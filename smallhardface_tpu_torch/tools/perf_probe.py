#!/usr/bin/env python3
"""Where a detection's milliseconds go on the card, one JSON line per
experiment.

Counterpart of ``smallhardface_tpu/tools/perf_probe.py`` (:47-245), with
the port's own timing (``tools/measure.profile_call``,
``tools/pyramid_time.split_detect``, ``tools/train_time.split_step``; no
timing code of its own):

  fwd_<precision>_<mask>  the flagship forward at ``--size``: fp32, bf16
                          and calibrated int8 (Q1), each with the valid
                          extent (size − 32) masked and unmasked
  detect                  one full-pyramid ``detect`` of a ``--size``
                          image, its stage split beside the forward's
  batching                ``detect_many`` of ``--batch`` images of half
                          the size, one batch, against ``detect`` of each
                          in turn: images per second of both
  train_step              ``--train``: the flagship step at 768×1024
                          (iter_size 1) and 512×640 (iter_size 2)

Each line carries walls (mean, p50, min of CUDA-event walls), device ms,
launches, host µs per launch and the idle share where they apply, and the
card's name and power limit.

Usage: python -m smallhardface_tpu_torch.tools.perf_probe
       [--size 1408 1920] [--iters 8] [--batch 4] [--train]
       [--train-only] [--only fwd_float32,...] [--device cuda|cpu]
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
from smallhardface_tpu_torch.ops import conv_int8
from smallhardface_tpu_torch.tools import (measure, pyramid_time,
                                           train_time)
from smallhardface_tpu_torch.utils.device import resolve_device

TRAIN_SHAPES = ((768, 1024, 1), (512, 640, 2))


def forward_probes(model, x, qstate, iters, only=None):
    """{label: profile_call dict} of the forward in each precision and
    mask mode; int8 runs the calibrated chain (``qstate``)."""
    h, w = x.shape[1:3]
    out = {}
    for prec in ("float32", "bfloat16", "int8"):
        for mask, valid in (("where", (h - 32, w - 32)), ("unmasked", None)):
            label = f"fwd_{prec}_{mask}"
            if only and not any(k in label for k in only):
                continue
            qs = qstate if prec == "int8" else None

            def call(valid=valid, prec=prec, qs=qs):
                with torch.inference_mode():
                    return model(x, valid, prec, qs)
            conv_int8.conv3x3_int8.launches = 0
            res = measure.profile_call(call, x.device, n=iters, warmup=2)
            res["q1_launches"] = conv_int8.conv3x3_int8.launches
            out[label] = res
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, nargs=2, default=[1408, 1920])
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--train", action="store_true",
                    help="also time the flagship train step (768x1024 "
                         "iter_size 1, 512x640 iter_size 2)")
    ap.add_argument("--train-only", action="store_true",
                    help="the train step only")
    ap.add_argument("--only", default=None,
                    help="run only forward probes whose label contains one "
                         "of these comma-separated substrings (and skip "
                         "detect and batching)")
    ap.add_argument("--scales", type=int, nargs="*", default=None,
                    help="TEST.SCALES of detect and batching (default: the "
                         "config's)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.train_only:
        args.train = True

    dev = resolve_device(args.device)
    card = measure.card_line(dev)
    cfg_from_file(os.path.join(CONFIG_DIR, "smallhardface.toml"))
    if args.scales:
        cfg.TEST.SCALES = list(args.scales)
    h, w = args.size
    spec = dm.build_spec(cfg)
    params = dm.init_params(torch.Generator().manual_seed(3), spec)
    results = []

    def emit(probe, **fields):
        line = {"probe": probe, "card": card, "device": str(dev), **fields}
        results.append(line)
        print(json.dumps(line), flush=True)

    only = [k for k in args.only.split(",") if k] if args.only else None
    if not args.train_only:
        model = dm.Detector(params, spec, dev)
        rng = np.random.RandomState(0)
        x = torch.from_numpy((rng.randn(1, h, w, 3) * 30).astype(
            np.float32)).to(dev)
        qstate = dm.make_qstate(model.tree(), spec, dm.collect_int8_amax(
            model, [x.cpu()]))
        flops = dm.forward_flops(spec, h, w)
        for label, res in forward_probes(model, x, qstate, args.iters,
                                         only).items():
            dms = res["device_ms"]
            emit(label, size=[h, w], **res,
                 tflops_s=flops / dms / 1e9 if dms else None)
        del model
    if not args.train_only and only is None:
        for k in dm.ANCHOR_SCALES:
            params[f"cls_score_{k}"]["b"] = torch.tensor(
                [pyramid_time.CLS_BIAS, -pyramid_time.CLS_BIAS])
        det = TorchDetector(params, spec, dev)
        split = pyramid_time.split_detect(
            det, pyramid_time.synthetic_image(h, w), reps=args.iters)
        emit("detect", size=[h, w], **split)
        ims = [pyramid_time.synthetic_image(h // 2, w // 2, seed=i)
               for i in range(args.batch)]

        def one_by_one():
            return [det.detect(im)[0] for im in ims]

        def batched():
            return det.detect_many(ims, max_batch=args.batch)
        seq = measure.summary_ms(measure.walls_ms(one_by_one, dev, 2, 1))
        many = measure.summary_ms(measure.walls_ms(batched, dev, 2, 1))
        emit("batching", size=[h // 2, w // 2], batch=args.batch,
             one_by_one=seq, detect_many=many,
             images_per_s_one_by_one=args.batch / seq["p50_ms"] * 1e3,
             images_per_s_detect_many=args.batch / many["p50_ms"] * 1e3)
        del det
    if args.train:
        for th, tw, iter_size in TRAIN_SHAPES:
            t0 = time.perf_counter()
            step = train_time.Step(cfg, dev, train_time.make_samples(
                th, tw, iter_size))
            split = train_time.split_step(step, reps=args.iters)
            split.pop("metrics")
            emit("train_step", size=[th, tw], iter_size=iter_size,
                 images_per_s=iter_size / split["wall_ms"] * 1e3,
                 seconds=time.perf_counter() - t0, **split)
            del step
    return results


if __name__ == "__main__":
    main()
