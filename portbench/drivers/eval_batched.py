"""Offline evaluation as ``test_runner.inference_worker`` runs it under
``TPU.EVAL_BATCH`` = ``eval_batch``: groups of that many same-shape
images, each read from disk (``cv2.imread``), through
``TorchDetector.detect_many(max_batch=eval_batch)``. The pool is ordered
so that every group shares one bucket key.

End to end: ``images_per_s`` (images of the groups returned within the
window over its length), ``peak_mem_gib``, ``setup_s``.
"""

from __future__ import annotations

import time

from portbench import common, evalcore

UNITS = {"images_per_s": "images/s", "peak_mem_gib": "GiB", "setup_s": "s"}


def _loop(det, pool, start, size, thresh, seconds=None, count=None,
          outputs=None):
    """Run groups from group ``start`` until ``seconds`` have passed or
    ``count`` groups ran. Returns (images returned before the deadline,
    images issued, next group, images that got no answer)."""
    import cv2
    n_groups = len(pool) // size
    t_end = None if seconds is None else time.perf_counter() + seconds
    done = issued = missing = 0
    g = start
    while True:
        if t_end is not None and time.perf_counter() >= t_end:
            break
        if count is not None and g - start >= count:
            break
        items = pool[(g % n_groups) * size:(g % n_groups + 1) * size]
        g += 1
        ims = [cv2.imread(it["path"]) for it in items]
        res = det.detect_many(ims, thresh, max_batch=size)
        issued += len(items)
        missing += max(0, len(items) - len(res))
        if t_end is None or time.perf_counter() <= t_end:
            done += len(items)
        if outputs is not None:
            for it, r in zip(items, res):
                outputs.setdefault(it["index"], r[0])
    return done, issued, g, missing


def run(ctx):
    from portbench.yardstick.trace import Stages
    from smallhardface_tpu_torch.utils.timer import no_stages
    c = ctx.cell
    size, thresh = int(c["eval_batch"]), float(c["thresh"])
    det, params, pool, calib = evalcore.build(ctx)
    precision = ctx.cfgd["TPU"]["PRECISION"]
    # warm-up: one group of every shape, twice
    firsts, warm = set(), []
    for g in range(len(pool) // size):
        shape = pool[g * size]["shape"]
        if shape not in firsts:
            firsts.add(shape)
            warm += pool[g * size:(g + 1) * size]
    _loop(det, warm, 0, size, thresh, count=2 * len(warm) // size)
    ctx.sync()
    outputs = {}
    ctx.reset_peak()
    setup_s = common.process_age_s()
    box = {}
    if not ctx.trace:
        done, issued, _, missing = _loop(det, pool, 0, size, thresh,
                                         seconds=ctx.seconds,
                                         outputs=outputs)
    else:
        stages = Stages()
        det.stages = stages
        done, issued, nxt, missing = _loop(det, pool, 0, size, thresh,
                                           seconds=ctx.seconds / 2,
                                           outputs=outputs)
        host, host_items = stages.host_s, issued
        det.stages = Stages()
        n_b = int(c.get("trace_groups", 4))
        with common.phase_b(ctx, box):
            _loop(det, pool, nxt, size, thresh, count=n_b, outputs=outputs)
        det.stages = no_stages
        n_groups = len(pool) // size
        traced = [it for g in range(nxt, nxt + n_b)
                  for it in pool[(g % n_groups) * size:
                                 (g % n_groups + 1) * size]]
    ctx.sync()
    peak_window, peak_run = ctx.window_peak()
    del det
    evalcore.free(ctx)
    nums, picked = evalcore.check(ctx, params, pool, calib, outputs,
                                  int(c["check_images"]))
    for k, v in nums.items():
        common.log(f"reading {k} = {v!r}")
    out = {"numbers": nums,
           "attempted": issued, "failed": missing, "units": UNITS,
           "device": evalcore.device_fields(ctx, peak_run,
                                            box if ctx.trace else None)}
    if not ctx.trace:
        out["e2e"] = {"images_per_s": done / ctx.seconds,
                      "peak_mem_gib": (peak_window or 0) / 2 ** 30,
                      "setup_s": setup_s}
        common.log(f"window: {done} images returned in {ctx.seconds} s")
    else:
        # one launch per level for each group: its weights read once
        work = evalcore.merge_work(
            [evalcore.level_work(traced[i], ctx.cfgd, 2 * size, precision,
                                 ctx.stages)
             for i in range(0, len(traced), size)])
        out["rec"] = evalcore.record("eval", len(traced), host,
                                     host_items, box, work)
        out["breakdown"] = evalcore.breakdown(box)
    return out
