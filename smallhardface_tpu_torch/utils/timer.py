"""Wall-clock averaging timer: the port's copy of
``smallhardface_tpu/utils/timer.py`` (the reference's lib/utils/timer.py);
and the device's busy time of a torch.profiler run."""

from __future__ import annotations

import math
import time


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
    copies) of a finished torch.profiler run, in seconds."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if getattr(ev, "device_type", None) == cuda)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e6
