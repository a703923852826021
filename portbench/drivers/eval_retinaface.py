"""RetinaFace-R50's WIDER evaluation as ``test_runner.inference_worker``
runs it under ``TPU.EVAL_BATCH 1`` (``MODEL.ARCH "retinaface_r50"``): a
closed loop over the pool of JPEG paths, each image through
``TorchDetector.detect_async`` with ``pipeline_depth`` images in flight,
the oldest read back by ``finalize_async`` (``eval_pipeline._loop``).

Weights from the seed, made by the plain reference
(``reference/retinaface.py``): He-normal convolutions, each batch norm's
statistics from one probe forward over a 480×640 background image (so
that every batch norm normalises, as trained statistics do), heads at
0.01 and a background bias on the class heads that lets ``PASS_SHARE`` of
the probe's priors pass the cut; loaded into the port through its
Pytorch_Retinaface loader (``io/retinaface.py``, the batch norms folded).

``correct``: ``check_images`` completed images of the window against the
reference's fp32 detections under the strict rule
(``det_unmatched_pct.strict``); with ``ctx.control`` also the reference
with TF32-rounded operands in the program's place (``control.*``).

End to end: ``images_per_s``, ``peak_mem_gib``, ``setup_s``, as in
``eval_pipeline``.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import common, evalcore
from portbench.drivers.eval_pipeline import UNITS, _loop

PROBE = (480, 640)


def _probe(ctx):
    """The probe image as the network input (1, 3, H, W) on the device."""
    import torch
    from portbench.gen import images
    rng = np.random.default_rng(ctx.seed + 3)
    mean = np.asarray(ctx.cfgd["PIXEL_MEANS"], np.float32).reshape(3)
    x = images.background(*PROBE, rng).astype(np.float32) - mean
    return torch.from_numpy(x).permute(2, 0, 1)[None].contiguous().to(
        ctx.device)


def reference_weights(ctx, thresh):
    """The reference's state dict (CPU tensors) from the seed, and its
    readings: the background bias and the largest |activation| at C5 over
    the probe."""
    import torch
    from portbench.reference import retinaface as ref
    net = ref.RetinaFace().to(ctx.device)
    ref.init_weights(net, ctx.seed)
    x = _probe(ctx)
    ref.probe_bn(net, x)
    bias = ref.background_bias(net, x, common.PASS_SHARE, thresh)
    with torch.no_grad(), ref.numerics("fp32"):
        c5 = float(net.body(x)[-1].abs().max())
    sd = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    return sd, {"diag.background_bias": bias, "diag.c5_amax": c5}


def build(ctx, thresh):
    """The port's configuration first (a port without ``MODEL.ARCH`` stops
    here), then V1 built on the card, the weights, the pool and the
    detector. Returns (detector, reference state dict, pool, readings)."""
    ctx.port_config()
    from smallhardface_tpu_torch.detect import TorchDetector
    from smallhardface_tpu_torch.io import retinaface as rio
    if ctx.on_card:
        from smallhardface_tpu_torch.ops import cuda_build, nms_device
        cuda_build.build_all([nms_device.VOTE])
    sd, readings = reference_weights(ctx, thresh)
    pool = ctx.pool()
    det = TorchDetector(rio.load_state_dict(sd), None, ctx.device)
    return det, sd, pool, readings


def reference_dets(ctx, sd, items, thresh, control=False):
    """The reference's detections of ``items`` and the rows above the cut
    of each."""
    from portbench.reference import retinaface as ref
    net = ref.RetinaFace().to(ctx.device)
    net.load_state_dict(sd)
    net.eval()
    dets, above = [], []
    for it in items:
        stats = {}
        dets.append(ref.detect(net, it["image"], ctx.cfgd, ctx.device,
                               thresh, control, stats))
        above.append(stats["above_cut"])
    return dets, above


def check(ctx, sd, pool, outputs, n_check, thresh):
    """The comparison numbers of a sample of the window's outputs against
    the reference in fp32, and under ``ctx.control`` the TF32 control's."""
    from portbench.reference import compare
    picked = evalcore.sample(ctx, outputs, pool, n_check)
    if not picked:
        return {"det_unmatched_pct.strict": float("inf")}
    t = time.perf_counter()
    items = [pool[i] for i in picked]
    refs, above = reference_dets(ctx, sd, items, thresh)
    nums = compare.detections([(r, outputs[i]) for r, i in zip(refs,
                                                                picked)],
                              "float32")
    nums["diag.above_cut_min"] = float(min(above))
    nums["diag.above_cut_max"] = float(max(above))
    if getattr(ctx, "control", False):
        ctl, _ = reference_dets(ctx, sd, items, thresh, control=True)
        for k, v in compare.detections(list(zip(refs, ctl)),
                                       "float32").items():
            nums["control." + k] = v
    common.log(f"reference: {len(picked)} images in "
               f"{time.perf_counter() - t:.1f} s, rows "
               f"{[len(r) for r in refs]} against "
               f"{[len(outputs[i]) for i in picked]}; above the cut "
               f"{above}")
    return nums


def level_work(item, cfgd):
    """The convolutions of one image's pyramid (image and mirror a level)
    on each level's valid extent: {"layers", "k1": [], "q1": []}."""
    from portbench.reference.detect import levels
    from portbench.yardstick import counts_retinaface
    rows = []
    for _, _, h_s, w_s, _, _ in levels(item["shape"], cfgd["TEST"]):
        rows += counts_retinaface.forward(h_s, w_s, 2)
    return {"layers": rows, "k1": [], "q1": []}


def run(ctx):
    from portbench.yardstick.trace import Stages
    from smallhardface_tpu_torch.utils.timer import no_stages
    c = ctx.cell
    depth, thresh = int(c["pipeline_depth"]), float(c["thresh"])
    det, sd, pool, readings = build(ctx, thresh)
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
        done, issued, _ = _loop(det, pool, 0, depth, thresh,
                                seconds=ctx.seconds, outputs=outputs)
    else:
        stages = Stages()
        det.stages = stages
        done, issued, nxt = _loop(det, pool, 0, depth, thresh,
                                  seconds=ctx.seconds / 2, outputs=outputs)
        host, host_items = stages.host_s, issued
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
    nums = check(ctx, sd, pool, outputs, int(c["check_images"]), thresh)
    nums.update(readings)
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
        work = evalcore.merge_work([level_work(it, ctx.cfgd)
                                    for it in traced])
        out["rec"] = evalcore.record("eval", n_b, host, host_items, box,
                                     work)
        out["breakdown"] = evalcore.breakdown(box)
    return out
