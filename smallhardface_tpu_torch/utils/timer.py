"""Wall-clock averaging timer: the port's copy of
``smallhardface_tpu/utils/timer.py`` (the reference's lib/utils/timer.py);
the device's busy time of a torch.profiler run; and the stage hook of an
uninstrumented run (``no_stages``; ``tools/measure.Stages`` records)."""

from __future__ import annotations

import contextlib
import math
import time


def no_stages(name, level=None):
    """The stage hook of a run that nobody times: ``with
    stages(name, level):`` around a stage of ``TorchDetector`` or of a
    training step does nothing. Inside a stage ``s``, a span named
    "wait_s" wraps each call that waits for the device (a copy from
    pageable host memory, a readback) and nothing else."""
    return contextlib.nullcontext()


class Timer:
    def __init__(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.average_time = 0.0

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self, average=True):
        self.diff = time.perf_counter() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return self.average_time if average else self.diff


def device_busy_s(prof):
    """The union of the intervals of the device's own events (kernels,
    copies) of a finished torch.profiler run, in seconds. A
    ``record_function`` range also shows on the device as a span from its
    first kernel to its last (a GPU user annotation, gaps included): not
    the device's work, so left out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if getattr(ev, "device_type", None) == cuda
                   and not getattr(ev, "is_user_annotation", False))
    busy, end = 0.0, -math.inf
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e6
