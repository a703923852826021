"""The program's wait spans in a record: the spans "wait_<stage>" that the
port opens inside its stages around each call that waits for the device
(a copy from pageable host memory, a readback). They reach the benchmark
through the ``stages`` seam like any stage: host seconds by name in
``rec["host_s"]`` (the unprofiled stretch) and ranges "stage:wait_…" in
the profiled stretch's trace, on the device events' clock. A program
without them has neither, and the readers then return None."""

from __future__ import annotations

import bisect

from portbench.yardstick.trace import STAGE_PREFIX

WAIT_PREFIX = "wait_"
RANGE_PREFIX = STAGE_PREFIX + WAIT_PREFIX


def host_s(rec):
    """Σ host seconds of the wait spans over the unprofiled stretch, or
    None where there is none."""
    waits = [s for k, s in rec["host_s"].items() if k.startswith(WAIT_PREFIX)]
    return sum(waits) if waits else None


def ranges(trace):
    """The wait ranges of the profiled stretch, [(start µs, end µs)] in
    order of start."""
    return sorted((a, b) for n, a, b in trace.ranges
                  if n.startswith(RANGE_PREFIX))


def drained_idle_pct(trace):
    """Of the device's idle time between its first and last event, the
    share in gaps that open while the host is inside a wait range (the
    device drained while the host was blocked on it), %; 0 where no gap
    opens in one, None without wait ranges."""
    waits = ranges(trace)
    if not waits:
        return None
    starts = [a for a, _ in waits]
    reach, top = [], -float("inf")
    for _, b in waits:          # the latest end among the ranges so far
        top = max(top, b)
        reach.append(top)
    idle = drained = 0.0
    end = None
    for _, a, b, _ in sorted(trace.device, key=lambda d: d[1]):
        if end is not None and a > end:
            i = bisect.bisect_right(starts, end) - 1
            if i >= 0 and reach[i] >= end:
                drained += a - end
            idle += a - end
        end = b if end is None else max(end, b)
    return 100.0 * drained / idle if idle > 0 else 0.0
