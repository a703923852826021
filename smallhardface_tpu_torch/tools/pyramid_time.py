"""Stage split of one warm full-pyramid ``detect`` on the card.

Counterpart of ``smallhardface_tpu/tools/pyramid_time.py`` (:42). JAX
compiles the pyramid into one program and bisects it by truncated variants
of ``_build_run`` (its ``_truncate`` hook). The port issues the pyramid
from Python, so the split comes from the port's own stage boundaries: a
``tools/measure.Stages`` hook on ``TorchDetector.stages`` marks

  prep      ``_prep``: the levels and the bucket key, on the host
  upload    the raw image to the device
  preproc   ``_level_batch``: the resize products, mean, mask and mirror
            of each level
  forward   ``Detector.forward`` of each level (image and mirror)
  decode    softmax, decode, un-mirror and scale of each level, and the
            cross-level merge (``_pyramid``)
  vote      ``top_rows`` and the vote V1 (``_dispatch``)
  readback  the voted rows to the host (``finalize_async``)

For each stage (and each level of preproc, forward and decode): the
host ms of issuing it (``time.perf_counter`` without a sync, the median
``detect`` of ``--reps``), its device ms and launches in one profiled
``detect`` (``torch.profiler``, device activity grouped by the stage open
at launch) and host µs per launch; the ``detect``'s wall (host clock
around it, its readback syncs), device busy ms and idle share (1 − busy /
wall). The instrumented ``detect`` returns the same rows as a plain one:
``split_detect`` checks it.

Usage: python -m smallhardface_tpu_torch.tools.pyramid_time
    [--size 768 1024] [--reps 5] [--weights PATH] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from smallhardface_tpu_torch.config import CONFIG_DIR, cfg, cfg_from_file
from smallhardface_tpu_torch.detect import TorchDetector
from smallhardface_tpu_torch.models import detector as dm
from smallhardface_tpu_torch.tools import measure
from smallhardface_tpu_torch.utils.device import resolve_device
from smallhardface_tpu_torch.utils.timer import no_stages

STAGES = ("prep", "upload", "preproc", "forward", "decode", "vote",
          "readback", "host_vote")
# random-init heads score every anchor near 0.5: this bias ([bg, fg] =
# [+b, -b]) leaves the tail of the anchors above the 0.05 cut, so the vote
# has thousands of rows to merge, as in chip_smoke.py's detection phase
CLS_BIAS = 1.55


def synthetic_image(h, w, seed=0):
    """A uint8 BGR image: a blocky low-frequency colour field and noise."""
    rng = np.random.RandomState(seed)
    low = rng.randint(0, 256, (h // 32 + 2, w // 32 + 2, 3)).astype(
        np.float32)
    field = np.kron(low, np.ones((32, 32, 1), np.float32))[:h, :w]
    return np.clip(field + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(
        np.uint8)


def split_detect(det, image, reps=5, thresh=0.05):
    """The stage split of a warm ``det.detect(image)``. Returns {"stages":
    {stage: {"host_ms", "device_ms", "launches", "host_us_per_launch"}},
    "wall_ms", "device_busy_ms", "idle_share", "outside", "rows_equal",
    "dets", "levels"}: every instrumented ``detect`` (``reps`` timed on the
    host, one profiled) gave the plain one's rows."""
    dev = det.device
    plain = det.detect(image, thresh)[0][0]          # warm-up and rows
    stages = measure.Stages()
    walls, same = [], True
    det.stages = stages
    try:
        for _ in range(reps):
            measure.sync(dev)
            t = time.perf_counter()
            rows = det.detect(image, thresh)[0][0]
            walls.append((time.perf_counter() - t) * 1e3)
            same = same and np.array_equal(rows, plain)
        det.stages = measure.Stages()
        tr, rows = measure.trace(lambda: det.detect(image, thresh)[0][0],
                                 dev, n=1, warmup=0)
        same = same and np.array_equal(rows, plain)
    finally:
        det.stages = no_stages
    out = measure.stage_table(stages, tr, float(np.median(walls)),
                              n_host=reps)
    out.update(rows_equal=bool(same), dets=int(plain.shape[0]),
               walls_ms=walls,
               levels=[[lv["hb"], lv["wb"]]
                       for lv in det._prep(image)["levels"]])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, nargs=2, default=[768, 1024],
                    help="source image (H W); levels follow TEST.SCALES")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--weights", default="",
                    help="weights .npz or .caffemodel (default: random "
                         "weights, background-biased)")
    ap.add_argument("--scales", type=int, nargs="*", default=None,
                    help="TEST.SCALES (default: the config's)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg_from_file(os.path.join(CONFIG_DIR, "smallhardface.toml"))
    if args.scales:
        cfg.TEST.SCALES = list(args.scales)
    spec = dm.build_spec(cfg)
    params = dm.init_params(torch.Generator().manual_seed(3), spec)
    if args.weights.endswith(".caffemodel"):
        from smallhardface_tpu_torch.io import caffemodel
        params = caffemodel.load_into_params(args.weights, params)
    elif args.weights:
        from smallhardface_tpu_torch.io.weights import load_params
        params = load_params(args.weights)
    else:
        for k in dm.ANCHOR_SCALES:
            params[f"cls_score_{k}"]["b"] = torch.tensor([CLS_BIAS,
                                                          -CLS_BIAS])
    det = TorchDetector(params, spec, dev)
    h, w = args.size
    res = split_detect(det, synthetic_image(h, w), args.reps)
    card = measure.card_line(dev)
    print(f"# {card or 'cpu: no device times'}; source {h}x{w}; levels "
          f"{res['levels']}; {res['dets']} detections; rows equal to a "
          f"plain detect: {res['rows_equal']}")
    print(f"{'stage':14s} {'host ms':>9s} {'device ms':>10s} "
          f"{'launches':>9s} {'host us/launch':>15s}")
    for name, r in sorted(res["stages"].items(), key=lambda kv: (
            STAGES.index(kv[0].split(".")[0]), kv[0])):
        def f(v, fmt):
            return format(v, fmt) if v is not None else "-"
        print(f"{name:14s} {r['host_ms']:9.3f} {f(r['device_ms'], '10.3f')} "
              f"{f(r['launches'], '9.0f')} "
              f"{f(r['host_us_per_launch'], '15.2f')}")
    idle = res["idle_share"]
    print(f"# detect wall {res['wall_ms']:.2f} ms (median of {args.reps}); "
          f"device busy {res['device_busy_ms']} ms; idle share "
          f"{idle if idle is None else round(idle, 4)}")
    result = {"tool": "pyramid_time", "size": [h, w], "device": str(dev),
              "card": card, "weights": args.weights or "random", **res}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
