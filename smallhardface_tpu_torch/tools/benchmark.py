"""Model timing — the `caffe time` analog of the port.

Counterpart of ``smallhardface_tpu/tools/benchmark.py`` (:21): the whole
forward, or with ``--train`` the forward and backward of one CE loss over
every parameter (``jax.grad`` of the JAX tool's loss: the class logits
against labels -1/0/1 in turn, -1 ignored), per
``--height/--width/--batch``, on seeded random input. ``--bf16`` runs the
forward in ``TPU.PRECISION "bfloat16"``; bf16 training is refused, as
``train_net`` refuses it. It prints the first call's wall, then mean, p50
and min of CUDA-event walls, the device's busy ms and launches in one
profiled call (``tools/measure.profile_call``), the host's issue ms and
host µs per launch; ``--trace-dir`` writes that call's ``torch.profiler``
Chrome trace there. The last line is the result as JSON, beside the
card's name and power limit.

Usage:
  python -m smallhardface_tpu_torch.tools.benchmark [--height 608]
      [--width 912] [--batch 1] [--iters 20] [--train] [--bf16]
      [--trace-dir DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from smallhardface_tpu_torch.models import detector as dm
from smallhardface_tpu_torch.tools import measure
from smallhardface_tpu_torch.train.losses import softmax_ce_with_ignore
from smallhardface_tpu_torch.utils.device import resolve_device


def build(device, train=False, seed=0):
    """The flagship detector (different dilation) with random weights
    from ``seed``; under ``train`` every parameter takes a gradient, as
    ``jax.grad`` over the whole tree does."""
    spec = dm.ModelSpec(different_dilation=True)
    params = dm.init_params(torch.Generator().manual_seed(seed), spec)
    model = dm.Detector(params, spec, device)
    if train:
        for p in model.parameters():
            p.requires_grad_(True)
    return model


def make_call(model, x, train=False, precision="float32"):
    """fn() running one forward (no autograd), or one forward and backward
    of the CE loss with the gradients reset first."""
    if not train:
        def call():
            with torch.inference_mode():
                return model(x, precision=precision)
        return call
    params = list(model.parameters())

    def call():
        for p in params:
            p.grad = None
        out = model(x, precision=precision)
        logits = out["cls_logits"].reshape(-1, 2)
        labels = (torch.arange(logits.shape[0], device=x.device) % 3
                  - 1).float()
        softmax_ce_with_ignore(logits, labels).backward()
        return logits
    return call


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--height", type=int, default=608)
    p.add_argument("--width", type=int, default=912)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--train", action="store_true",
                   help="time forward+backward instead of forward")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--trace-dir", default="",
                   help="write a torch.profiler Chrome trace here")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)
    if args.train and args.bf16:
        raise SystemExit(
            "--train --bf16: the port trains in float32 only (the JAX "
            "reference's own bfloat16 gradient fails; train_net refuses it)")

    dev = resolve_device(args.device)
    model = build(dev, args.train)
    precision = "bfloat16" if args.bf16 else "float32"
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(args.batch, args.height, args.width, 3)
                          * 30).astype(np.float32)).to(dev)
    call = make_call(model, x, args.train, precision)

    measure.sync(dev)
    t0 = time.perf_counter()
    call()
    measure.sync(dev)
    first_s = time.perf_counter() - t0
    print(f"first call: {first_s:.2f}s")

    export = None
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        export = os.path.join(args.trace_dir, "benchmark_trace.json")
    res = measure.profile_call(call, dev, n=args.iters, warmup=2,
                               export=export)
    if export:
        print(f"profiler trace written to {export}")
    mode = "fwd+bwd" if args.train else "forward"
    card = measure.card_line(dev)
    dev_txt = ("" if res["device_ms"] is None else
               f" device {res['device_ms']:.2f}ms, {res['launches']} "
               f"launches, host {res['host_us_per_launch']:.1f}us/launch")
    print(f"{mode} {args.batch}x{args.height}x{args.width} "
          f"({'bf16' if args.bf16 else 'f32'}): "
          f"mean {res['mean_ms']:.1f}ms p50 {res['p50_ms']:.1f}ms "
          f"min {res['min_ms']:.1f}ms;{dev_txt} [{card or dev.type}]")
    result = {"tool": "benchmark", "mode": mode,
              "shape": [args.batch, args.height, args.width, 3],
              "precision": precision, "first_call_s": first_s,
              "device": str(dev), "card": card, **res}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
