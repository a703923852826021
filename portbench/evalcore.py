"""Detection set-up, records and the reference check shared by the
evaluation drivers."""

from __future__ import annotations

import time

import numpy as np

from portbench import common

def build(ctx):
    """The port's detector on the context's device with the seed's
    weights (built kernels first on the card), and the cell's pool;
    under int8 the detector is calibrated on the pool's first
    ``TPU.INT8_CALIB_IMAGES`` images, as ``test_runner`` calibrates.
    Returns (detector, params, pool, calibration images)."""
    cfg = ctx.port_config()
    from smallhardface_tpu_torch.detect import TorchDetector
    from smallhardface_tpu_torch.models import detector as dm
    int8 = str(cfg.TPU.PRECISION) == "int8"
    if ctx.on_card:
        from smallhardface_tpu_torch.ops import (conv_int8, cuda_build,
                                                 nms_device, stem)
        libs = [stem.STEM, nms_device.VOTE] + ([conv_int8.CONV_INT8]
                                               if int8 else [])
        cuda_build.build_all(libs)
    params = ctx.weights()
    pool = ctx.pool()
    det = TorchDetector(params, dm.build_spec(cfg), ctx.device)
    calib = []
    if int8:
        calib = pool[:int(cfg.TPU.INT8_CALIB_IMAGES)]
        det.calibrate_int8([it["path"] for it in calib])
    return det, params, pool, calib


def level_work(item, cfgd, items_per_image, precision, stages):
    """The work of one image's pyramid (image and mirror per level):
    {"layers": [forward rows], "k1": [(ops, bytes)], "q1": [(ops, bytes)]}
    per level launch on the valid ×16 extents."""
    from portbench.reference import arch, detect as rdet
    from portbench.yardstick import counts
    stages = stages or arch.VGG16
    work = {"layers": [], "k1": [], "q1": []}
    for _, _, _, _, hb, wb in rdet.levels(item["shape"], cfgd["TEST"]):
        rows = counts.forward(hb, wb, items_per_image, precision, stages)
        work["layers"] += rows
        work["q1"] += [(r["ops"], r["bytes"]) for r in rows if r["q1"]]
        if stages[0] == ("conv1", 64, 2):
            work["k1"].append(counts.stem(hb, wb, items_per_image))
    return work


def merge_work(works):
    out = {"layers": [], "k1": [], "q1": []}
    for w in works:
        for k in out:
            out[k] += w[k]
    return out


def record(kind, n_items, host_s, host_items, box, work):
    """The record the per-layer readers take: the cell's kind, the items
    of the profiled stretch, the host stages' seconds over ``host_items``
    items, the trace and its window, and the work of those items."""
    return {"kind": kind, "items": n_items, "host_s": dict(host_s),
            "host_items": host_items, "trace": box.get("trace"),
            "window_s": box.get("window_s"), "work": work}


def device_fields(ctx, peak_run, box=None):
    import torch
    dev = {"platform": "gpu" if ctx.on_card else "cpu",
           "kind": (torch.cuda.get_device_name(ctx.device) if ctx.on_card
                    else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak_run or 0)}
    if box is not None and box.get("trace") is not None:
        dev["busy_s"] = box["trace"].busy_s()
        dev["window_s"] = box["window_s"]
    return dev


def breakdown(box):
    tr = box.get("trace")
    if tr is None:
        return None
    return {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}


def sample(ctx, done_indices, pool, n):
    """``n`` completed images drawn from the seed, one of every shape among
    them first."""
    rng = np.random.default_rng(ctx.seed + 1)
    done = sorted(done_indices)
    picked, shapes = [], set()
    for i in rng.permutation(done):
        if pool[i]["shape"] not in shapes:
            shapes.add(pool[i]["shape"])
            picked.append(int(i))
    for i in rng.permutation(done):
        if len(picked) >= n:
            break
        if int(i) not in picked:
            picked.append(int(i))
    return picked[:n]


def reference_dets(ctx, params, items, calib, mode):
    """The reference's detections of ``items`` in ``mode`` ("fp32",
    "tf32", "int8", "int4"), calibrated on ``calib`` in the quantized
    modes."""
    from portbench.reference import detect as rdet
    from portbench.reference.net import Net
    import torch
    net = Net(params, mode, ctx.stages or __import__(
        "portbench.reference.arch", fromlist=["VGG16"]).VGG16)
    if mode in ("int8", "int4"):
        xs = rdet.calibration_inputs([it["image"] for it in calib], ctx.cfgd)
        net.calibrate([torch.from_numpy(x).to(ctx.device) for x in xs])
    return [rdet.detect(net, it["image"], ctx.cfgd, ctx.device,
                        float(ctx.cell["thresh"])) for it in items]


def check(ctx, params, pool, calib, outputs, n_check):
    """The comparison numbers of a sample of the window's outputs
    ({pool index: (N, 5)}) against the reference in the configuration's
    precision."""
    precision = ctx.cfgd["TPU"]["PRECISION"]
    mode = "int8" if precision == "int8" else "fp32"
    picked = sample(ctx, outputs, pool, n_check)
    if not picked:
        from portbench.reference.compare import DECIDES
        return {d[0]: float("inf") for d in DECIDES[precision]}, picked
    t = time.perf_counter()
    refs = reference_dets(ctx, params, [pool[i] for i in picked], calib,
                          mode)
    from portbench.reference import compare
    nums = compare.detections([(r, outputs[i]) for r, i in zip(refs,
                                                               picked)],
                              precision)
    if getattr(ctx, "control", False):
        # the control: the reference one precision lower in the program's
        # place (TF32 for fp32, a 4-bit grid for int8)
        low = {"fp32": "tf32", "int8": "int4"}[mode]
        ctl = reference_dets(ctx, params, [pool[i] for i in picked], calib,
                             low)
        for k, v in compare.detections(list(zip(refs, ctl)),
                                       precision).items():
            nums["control." + k] = v
    common.log(f"reference: {len(picked)} images in "
               f"{time.perf_counter() - t:.1f} s, rows "
               f"{[len(r) for r in refs]} against "
               f"{[len(outputs[i]) for i in picked]}")
    return nums, picked


def free(ctx):
    """Collect the program's dropped state before the reference runs."""
    import gc
    gc.collect()
    if ctx.on_card:
        import torch
        torch.cuda.synchronize(ctx.device)
        torch.cuda.empty_cache()
