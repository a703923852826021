"""Device time from a ``torch.profiler`` session, grouped by the host
range open at each launch.

Copied from ``smallhardface_tpu_torch/tools/measure.py`` :51-61, :208-297
and :343-372 (``Trace``: the card's events, the host's
``record_function`` ranges, the launch that put each event on the card;
the busy union; ``group``; the priming work before a session), keeping
what the benchmark reads: the device events with their launch times,
the ranges, ``busy_s`` and ``group``.
"""

from __future__ import annotations

import bisect
import contextlib
import math
import re
from collections import defaultdict

import torch

STAGE_PREFIX = "stage:"
PRIME = "portbench:prime"
_LAUNCH_PREFIXES = ("cuda", "cu")


class Trace:
    """``device``: [(name, start µs, end µs, launch µs or None)]; ``ranges``:
    [(name, start µs, end µs)] of the host's ``record_function`` ranges."""

    def __init__(self, prof):
        cuda = torch.autograd.DeviceType.CUDA
        ranges, dev, launches = [], [], {}
        for ev in prof.events():
            start, end = ev.time_range.start, ev.time_range.end
            if ev.device_type == cuda:
                dev.append(ev)
                continue
            if ev.name.startswith(_LAUNCH_PREFIXES):
                launches.setdefault(ev.id, (start, ev.name))
                continue
            if getattr(ev, "is_user_annotation", "::" not in ev.name):
                ranges.append((ev.name, start, end))
        names = {r[0] for r in ranges}
        primed = max((e for n, _, e in ranges if n == PRIME),
                     default=-math.inf)
        self.ranges = [r for r in ranges if r[0] != PRIME]
        self.device = [(ev.name, ev.time_range.start, ev.time_range.end,
                        launches.get(ev.id, (None,))[0])
                       for ev in dev if ev.name not in names
                       and not getattr(ev, "is_user_annotation", False)]
        self.device = [d for d in self.device
                       if d[3] is None or d[3] > primed]

    def busy_s(self):
        """The union of the device events' intervals, seconds."""
        busy, end = 0.0, -math.inf
        for _, a, b, _ in sorted(self.device, key=lambda d: d[1]):
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        return busy / 1e6

    def kernel_s(self, pattern):
        """Summed device seconds of the events whose name matches the
        regular expression ``pattern``, and their count."""
        rx = re.compile(pattern)
        hits = [b - a for n, a, b, _ in self.device if rx.search(n)]
        return sum(hits) / 1e6, len(hits)

    def group(self, is_scope, key=lambda name: name):
        """{key(range): {"device_s", "launches"}}: each device event in the
        innermost range passing ``is_scope`` that was open at its launch,
        else "(outside)"."""
        spans = sorted((s, e, n) for n, s, e in self.ranges if is_scope(n))
        starts = [s for s, _, _ in spans]
        out = defaultdict(lambda: {"device_s": 0.0, "launches": 0})
        for _, a, b, t in self.device:
            owner = "(outside)"
            if t is not None:
                for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
                    s, e, name = spans[i]
                    if s <= t <= e:
                        owner = key(name)
                        break
            out[owner]["device_s"] += (b - a) / 1e6
            out[owner]["launches"] += 1
        return dict(out)

    def stages(self):
        """``group`` over the stage ranges, keyed by stage name without its
        level ("forward.L3" counts under "forward")."""
        return self.group(
            lambda n: n.startswith(STAGE_PREFIX),
            key=lambda n: n[len(STAGE_PREFIX):].split(".")[0])

    def top_ops(self, k=10):
        """The k device operations that took most time: [[name, s]]."""
        tot = defaultdict(float)
        for n, a, b, _ in self.device:
            tot[n] += (b - a) / 1e6
        return [[n[:120], s] for n, s in sorted(tot.items(),
                                                key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k=10):
        """The k longest gaps between device work, each named by the
        innermost host range open over most of it: [[name, s]]."""
        ev = sorted(self.device, key=lambda d: d[1])
        gaps, end = [], None
        for _, a, b, _ in ev:
            if end is not None and a > end:
                gaps.append((end, a))
            end = b if end is None else max(end, b)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            mid = (a + b) / 2
            held = [(s, n) for n, s, e in self.ranges if s <= mid <= e]
            name = max(held)[1] if held else "(no range)"
            out.append([name[:120], (b - a) / 1e6])
        return out


@contextlib.contextmanager
def profiled(device, box):
    """Profile the block on ``device`` (a card); ``box["trace"]`` holds the
    ``Trace`` afterwards. The session first runs about 0.1 s of priming
    work, which ``Trace`` leaves out."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(PRIME):
            torch.cuda._sleep(200_000_000)
            z = torch.zeros(1, device=device)
            for _ in range(64):
                z.add_(1)
        torch.cuda.synchronize(device)
        yield
        torch.cuda.synchronize(device)
    box["trace"] = Trace(prof)


class Stages:
    """A stage hook for the program's ``stages`` seams: the host wall of
    each stage (``time.perf_counter`` around the issuing code, no sync),
    summed by stage name, and while a profiler records a
    ``record_function`` range "stage:<name>[.L<level>]". A lock keeps the
    sums whole when requests run on several threads. From
    ``smallhardface_tpu_torch/tools/measure.py`` :183-205."""

    def __init__(self):
        import threading
        self.host_s = defaultdict(float)
        self.calls = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, name, level=None):
        import time
        key = name if level is None else f"{name}.L{level}"
        rf = (torch.profiler.record_function(STAGE_PREFIX + key)
              if torch._C._autograd._profiler_enabled()
              else contextlib.nullcontext())
        t = time.perf_counter()
        with rf:
            yield
        dt = time.perf_counter() - t
        with self._lock:
            self.host_s[name] += dt
            self.calls[name] += 1
