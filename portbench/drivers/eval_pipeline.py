"""Offline evaluation as ``test_runner.inference_worker`` runs it under
``TPU.EVAL_BATCH 1``: a closed loop over the pool of JPEG paths, each
image through ``TorchDetector.detect_async`` with ``pipeline_depth``
images in flight, the oldest read back by ``finalize_async``.

End to end: ``images_per_s`` (images read back within the window over
its length), ``peak_mem_gib`` (the window's peak allocation), ``setup_s``.
"""

from __future__ import annotations

import time
from collections import deque

from portbench import common, evalcore

UNITS = {"images_per_s": "images/s", "peak_mem_gib": "GiB", "setup_s": "s"}


def _loop(det, pool, start, depth, thresh, seconds=None, count=None,
          outputs=None):
    """Issue pool images from ``start`` in order, ``depth`` in flight,
    until ``seconds`` have passed or ``count`` images were issued; drain.
    Returns (images read back before the deadline, images issued, next
    start)."""
    pending = deque()
    t_end = None if seconds is None else time.perf_counter() + seconds
    done = issued = 0
    k = start
    while True:
        if t_end is not None and time.perf_counter() >= t_end:
            break
        if count is not None and issued >= count:
            break
        item = pool[k % len(pool)]
        k += 1
        pending.append((item, det.detect_async(item["path"], thresh)))
        issued += 1
        if len(pending) > depth:
            it, h = pending.popleft()
            dets = det.finalize_async(h, thresh)[0]
            if t_end is None or time.perf_counter() <= t_end:
                done += 1
            if outputs is not None:
                outputs.setdefault(it["index"], dets)
    while pending:
        it, h = pending.popleft()
        dets = det.finalize_async(h, thresh)[0]
        if t_end is None and count is not None:
            done += 1
        if outputs is not None:
            outputs.setdefault(it["index"], dets)
    return done, issued, k


def run(ctx):
    from portbench.yardstick.trace import Stages
    from smallhardface_tpu_torch.utils.timer import no_stages
    c = ctx.cell
    depth, thresh = int(c["pipeline_depth"]), float(c["thresh"])
    det, params, pool, calib = evalcore.build(ctx)
    precision = ctx.cfgd["TPU"]["PRECISION"]
    # warm-up: every image shape of the pool through the pipeline
    shapes = {}
    for it in pool:
        shapes.setdefault(it["shape"], it)
    warm = list(shapes.values())
    _loop(det, warm, 0, depth, thresh, count=2 * len(warm))
    ctx.sync()
    outputs = {}
    ctx.reset_peak()
    setup_s = common.process_age_s()
    box, host = {}, None
    if not ctx.trace:
        done, issued, nxt = _loop(det, pool, 0, depth, thresh,
                                  seconds=ctx.seconds, outputs=outputs)
    else:
        stages = Stages()
        det.stages = stages
        done, issued, nxt = _loop(det, pool, 0, depth, thresh,
                                  seconds=ctx.seconds / 2, outputs=outputs)
        host = stages.host_s
        host_items = issued
        det.stages = Stages()
        n_b = int(c.get("trace_images", 8))
        with common.phase_b(ctx, box):
            _loop(det, pool, nxt, depth, thresh, count=n_b, outputs=outputs)
        det.stages = no_stages
        traced = [pool[(nxt + i) % len(pool)] for i in range(n_b)]
    ctx.sync()
    peak_window, peak_run = ctx.window_peak()
    del det
    evalcore.free(ctx)
    nums, picked = evalcore.check(ctx, params, pool, calib, outputs,
                                  int(c["check_images"]))
    for k, v in nums.items():
        common.log(f"reading {k} = {v!r}")
    out = {"numbers": nums,
           "attempted": issued, "failed": 0, "units": UNITS,
           "device": evalcore.device_fields(ctx, peak_run,
                                            box if ctx.trace else None)}
    if not ctx.trace:
        out["e2e"] = {"images_per_s": done / ctx.seconds,
                      "peak_mem_gib": (peak_window or 0) / 2 ** 30,
                      "setup_s": setup_s}
        common.log(f"window: {done} images read back in {ctx.seconds} s, "
                   f"{issued} issued")
    else:
        work = evalcore.merge_work(
            [evalcore.level_work(it, ctx.cfgd, 2, precision, ctx.stages)
             for it in traced])
        out["rec"] = evalcore.record("eval", n_b, host, host_items,
                                     box, work)
        out["breakdown"] = evalcore.breakdown(box)
    return out
