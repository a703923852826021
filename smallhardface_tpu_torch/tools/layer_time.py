#!/usr/bin/env python3
"""Per-layer timing — the `caffe time` analog of the port.

Counterpart of ``smallhardface_tpu/tools/layer_time.py`` (:60-340). The
reference printed each layer's forward and backward milliseconds
(caffe/tools/caffe.cpp:339-427). The JAX tool read the TPU compiler's
cost-model cycles per ``jax.named_scope`` (``collect_cycles``, :34); XLA's
cycle estimates have no CUDA counterpart, so the port MEASURES instead:
one forward (``--train``: one forward and backward of a sum loss over every
parameter, in the training mask mode) runs under ``torch.profiler``, and
every kernel, copy and fill the card ran is grouped by the
``record_function`` scope of ``Detector.forward`` that was open when it
was launched (``models.detector.scope``: JAX's scope names, plus the
pools). Backward work is grouped by the forward scope of the operator that
made its autograd node (``tools/measure.Trace.backward_by_scope``).

Default: the per-layer table, one row per scope in forward order: device
ms (fwd, and bwd under ``--train``), launches, share of the run's device
time, GFLOP, TFLOP/s and the layer's bound (the larger of its bytes over
3.35 TB/s and its operations over the fp32 CUDA-core peak, the stem's
conv1_2 as three TF32 products; ``tools/measure``), with the share of the
bound reached. The scoped rows' share of all device time is printed as the
coverage.

``--bisect``: the cumulative and Δ device time per VGG stage in forward
order (``measure.vgg_stage_list``; the fused stem is one row for conv1_1
to pool1), then the full forward with its TFLOP/s and share of its bound.
Method: the per-scope device time of one profiled forward, not truncated
prefixes: ops are issued eagerly, so the scope boundaries are the stage
boundaries.

``--int8-chain``: the post-stem chain (conv2_1 to conv5_3 with its pools,
the int8 serving chain's domain) per stage, the calibrated int8 chain
(Q1, ``ops/conv_int8``; timing-only steps) against the fp32 chain, beside
each stage's floor (the int8 bound), with the measured device copy rate
and Q1's launches.

``--mask-mode``: the valid extent the port masks to, ``where`` (the
training mode, extent size − 32), ``exact`` or ``none`` (no mask); the
JAX ``band`` modes are not carried (a TPU speed trick) and are refused.

Usage: python -m smallhardface_tpu_torch.tools.layer_time [--size 1408 1920]
       [--mask-mode where|exact|none] [--train] [--bisect] [--int8-chain]
       [--batch 1] [--reps 3] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch
import torch.nn.functional as F

from smallhardface_tpu_torch.models import detector as dm
from smallhardface_tpu_torch.models.layers import (conv2d_int8_chain,
                                                   conv3x3, max_pool_2x2)
from smallhardface_tpu_torch.ops import conv_int8
from smallhardface_tpu_torch.tools import measure
from smallhardface_tpu_torch.utils.device import resolve_device

MASK_MODES = ("where", "exact", "none")


def _conv_cost(b, h, w, k, ci, co, in_bytes, out_bytes, w_bytes=4):
    """(operations, bytes) of a k×k convolution at output h×w: two per
    multiply-add; input, weights and output read or written once."""
    return (2.0 * b * h * w * k * k * ci * co,
            b * h * w * (ci * in_bytes + co * out_bytes)
            + k * k * ci * co * w_bytes)


def layer_costs(spec, h, w, batch=1):
    """{scope: {"gflop", "bound_ms", "bound_by"}} of one fp32 forward at
    input (batch, h, w), keyed like ``detector.scope_names``: activations
    and weights read or written once in fp32, products on the CUDA cores
    (TF32 is off), the stem's conv1_2 as three TF32 products."""
    shapes = dm.param_shapes(spec)
    out = {}

    def conv(scope, name, hs, ws):
        kh, _, ci, co = shapes[name]["w"]
        ops, by = _conv_cost(batch, hs, ws, kh, ci, co, 4, 4)
        prev = out.get(scope, {"ops": 0.0, "bytes": 0.0})
        out[scope] = {"ops": ops + prev["ops"], "bytes": by + prev["bytes"]}

    fused = dm.VGG_STAGES[0] == ("conv1", 64, 2)
    s = 1
    for si, (stage, c_out, n) in enumerate(dm.VGG_STAGES):
        hs, ws = math.ceil(h / s), math.ceil(w / s)
        if fused and stage == "conv1":
            p = batch * h * w
            ops, by = 2.0 * 27 * 64 * p, 4 * (3 * p + 64 * p // 4)
            out["pallas_stem"] = {"ops": ops + 2.0 * 576 * 64 * p,
                                  "bytes": by, "split": (
                                      2.0 * 27 * 64 * p, 2.0 * 576 * 64 * p)}
        else:
            for i in range(1, n + 1):
                conv(f"{stage}_{i}", f"{stage}_{i}", hs, ws)
        if si < len(dm.VGG_STAGES) - 1:
            if not (fused and stage == "conv1"):
                out[f"pool{si + 1}"] = {"ops": 0.0, "bytes": batch * c_out * 4
                                        * (hs * ws + math.ceil(hs / 2)
                                           * math.ceil(ws / 2))}
            s *= 2
    h16, w16 = math.ceil(h / s), math.ceil(w / s)
    h8, w8 = math.ceil(h / (s // 2)), math.ceil(w / (s // 2))
    conv("conv5_256", "conv5_256", h16, w16)
    lat = spec.lateral_channels
    out["conv5_256_up"] = {"ops": 2.0 * batch * h8 * w8 * 16 * lat,
                           "bytes": batch * lat * 4 * (h16 * w16 + h8 * w8)}
    conv("conv4_256", "conv4_256", h8, w8)
    conv("conv4_fuse_final", "conv4_fuse_final", h8, w8)
    if spec.different_dilation:
        conv("conv4_fuse_final_dim_red", "conv4_fuse_final_dim_red", h8, w8)
        for k in dm.ANCHOR_SCALES:
            for name in ("head", f"cls_score_{k}", f"bbox_pred_{k}"):
                conv(f"head_{k}", name, h8, w8)
    else:
        for name in ("head", "cls_score", "bbox_pred"):
            conv(name, name, h8, w8)
    table = {}
    for scope, c in out.items():
        bnd, by = (measure.split_bound_ms(c["bytes"], *c["split"])
                   if "split" in c else measure.bound_ms(c["bytes"], c["ops"]))
        table[scope] = {"gflop": c["ops"] / 1e9, "bound_ms": bnd,
                        "bound_by": by}
    return table


def _setup(args):
    if args.mask_mode not in MASK_MODES:
        raise SystemExit(
            f"--mask-mode {args.mask_mode}: the port has the valid-extent "
            f"masks only ({', '.join(MASK_MODES)}); the JAX 'band' modes "
            "are a TPU speed trick that is not carried over")
    dev = resolve_device(args.device)
    spec = dm.ModelSpec(different_dilation=True)
    params = dm.init_params(torch.Generator().manual_seed(3), spec)
    model = dm.Detector(params, spec, dev)
    h, w = args.size
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(args.batch, h, w, 3) * 30).astype(
        np.float32)).to(dev)
    valid = (h - 32, w - 32) if args.mask_mode == "where" else None
    return dev, spec, model, x, valid


def per_layer(model, x, valid, train=False):
    """One profiled forward (``train``: forward and backward of the sum of
    both outputs, every parameter taking a gradient) after a warm-up.
    Returns {"rows": {scope: {"fwd_ms", "bwd_ms", "launches", "calls"}}
    in forward order, "total_ms": all device ms (fwd and bwd), "fwd_ms"
    and "bwd_ms": the forward's and the backward nodes', "coverage" and
    "bwd_coverage": the scoped shares of each, the forward's "(outside)"
    work, "lost": ``Trace.lost``}; device fields None on the CPU."""
    names = dm.scope_names(model.spec)
    is_scope = set(names).__contains__
    if train:
        for p in model.parameters():
            p.requires_grad_(True)

        def call():
            for p in model.parameters():
                p.grad = None
            out = model(x, valid)
            (out["cls_logits"].sum() + out["bbox_deltas"].sum()).backward()
    else:
        def call():
            with torch.inference_mode():
                model(x, valid)
    tr, _ = measure.trace(call, x.device, n=1, warmup=1)
    calls = tr.scope_calls(is_scope)
    on_card = tr.on_card
    fwd = tr.group(is_scope) if on_card else {}
    bwd = tr.backward_by_scope(is_scope) if on_card and train else {}
    rows = {}
    for n in names:
        f, b = fwd.get(n, {}), bwd.get(n, {})
        rows[n] = {"calls": calls.get(n, 0),
                   "fwd_ms": f.get("device_ms", 0.0) if on_card else None,
                   "bwd_ms": (b.get("device_ms", 0.0) if on_card and train
                              else None),
                   "launches": (f.get("launches", 0) + b.get("launches", 0)
                                if on_card else None)}
    if not on_card:
        return {"rows": rows, "total_ms": None, "fwd_ms": None,
                "coverage": None, "outside": None, "bwd_ms": None,
                "bwd_coverage": None, "lost": None}
    total = tr.device_ms()
    bwd_total = sum(v["device_ms"] for v in bwd.values())
    # under --train the forward's own device time: everything minus the
    # backward nodes' work
    fwd_total = total - bwd_total if train else total
    scoped = sum(r["fwd_ms"] for r in rows.values())
    bwd_out = bwd.get("(outside)", {"device_ms": 0.0})["device_ms"]
    return {"rows": rows, "total_ms": total, "fwd_ms": fwd_total,
            "coverage": scoped / fwd_total if fwd_total else None,
            "outside": fwd.get("(outside)"),
            "bwd_ms": bwd_total if train else None,
            "bwd_coverage": (1.0 - bwd_out / bwd_total if bwd_total
                             else None), "lost": tr.lost}


def print_table(res, costs, train):
    """The per-layer table; returns its rows with the derived columns."""
    total = res["total_ms"]
    print(f"{'layer':28s} {'fwd ms':>9s} {'bwd ms':>9s} {'launch':>6s} "
          f"{'share':>7s} {'GFLOP':>8s} {'TFLOP/s':>8s} {'bound ms':>9s} "
          f"{'of bound':>8s}")
    table = {}
    mult = 3.0 if train else 1.0      # backward ≈ twice the forward's work
    for n, r in res["rows"].items():
        c = costs.get(n, {"gflop": 0.0, "bound_ms": 0.0})
        ms = None if r["fwd_ms"] is None else r["fwd_ms"] + (r["bwd_ms"] or 0)
        row = dict(r, gflop=c["gflop"] * mult, bound_ms=c["bound_ms"] * mult,
                   share=(ms / total if ms is not None and total else None),
                   tflops=(c["gflop"] * mult / ms if ms else None),
                   of_bound=(c["bound_ms"] * mult / ms if ms else None))
        table[n] = row

        def f(v, fmt):
            return format(v, fmt) if v is not None else "-"
        print(f"{n:28s} {f(r['fwd_ms'], '9.3f')} {f(r['bwd_ms'], '9.3f')} "
              f"{f(r['launches'], '6d')} {f(row['share'], '7.1%')} "
              f"{row['gflop']:8.1f} {f(row['tflops'], '8.1f')} "
              f"{row['bound_ms']:9.3f} {f(row['of_bound'], '8.1%')}")
    return table


def bisect_stages(res, costs, spec, h, w, batch):
    """Cumulative and Δ device ms per VGG stage from the per-scope times,
    then the full forward's TFLOP/s and share of its bound (the sum of
    the layers' bounds)."""
    fused = dm.VGG_STAGES[0] == ("conv1", 64, 2)
    rows, cum = [], 0.0
    for nm in measure.vgg_stage_list(dm.VGG_STAGES):
        if fused and nm.startswith("conv1"):
            continue
        scope = "pallas_stem" if fused and nm == "pool1" else nm
        d = res["rows"][scope]["fwd_ms"]
        if d is None:
            rows.append({"stage": nm, "scope": scope, "cum_ms": None,
                         "delta_ms": None})
            continue
        cum += d
        rows.append({"stage": nm, "scope": scope, "cum_ms": cum,
                     "delta_ms": d, "gflop": costs[scope]["gflop"]})
    flops = dm.forward_flops(spec, h, w, batch)
    bound = sum(c["bound_ms"] for c in costs.values())
    fwd = res["fwd_ms"]
    full = {"fwd_ms": fwd, "gflop": flops / 1e9, "bound_ms": bound,
            "tflops": flops / fwd / 1e9 if fwd else None,
            "of_bound": bound / fwd if fwd else None}
    return rows, full


def _chain_fn(stages, qstate, weights, int8):
    """fn(x) running the post-stem chain over ``stages`` under a scope per
    stage: fp32 convs (``layers.conv3x3``) and pools, or the calibrated
    int8 chain (``layers.conv2d_int8_chain``, pools on the int8 carrier,
    the last link back to fp32)."""
    convs = [n for n in stages if not n.startswith("pool")]
    succ = dict(zip(convs, convs[1:]))

    def run(x):
        h = x
        with torch.inference_mode():
            for nm in stages:
                with dm.scope(nm):
                    if nm.startswith("pool"):
                        h = max_pool_2x2(h)
                    elif int8:
                        nxt = succ.get(nm)
                        h = conv2d_int8_chain(
                            h, qstate["qw"][nm], dm.input_step(qstate, nm),
                            qstate["s_w"][nm], weights[nm]["b"],
                            s_out=(None if nxt is None
                                   else dm.input_step(qstate, nxt)))
                    else:
                        h = F.relu(conv3x3(h, weights[nm]["w"],
                                           weights[nm]["b"]))
        return h
    return run


def int8_chain(model, spec, h, w, batch, dev, reps=3):
    """The post-stem chain per stage, int8 against fp32, beside each
    stage's floor (its int8 bound), from one profiled run each; and the
    chains' walls (CUDA events, median of ``reps``), the measured copy
    rate and Q1's launches in one int8 chain."""
    stages = measure.chain_stage_list(dm.VGG_STAGES)
    weights = model.tree()
    # timing-only steps: calibration values do not change the program
    qstate = dm.make_qstate(weights, spec, {n: 1.0 for n in
                                            dm.int8_layer_names(spec)})
    hs, ws = h // 2, w // 2
    c0 = dm.VGG_STAGES[0][1]
    rng = np.random.RandomState(1)
    q8 = torch.from_numpy(rng.randint(-127, 128, (batch, c0, hs, ws))
                          .astype(np.int8)).to(dev).contiguous(
                              memory_format=torch.channels_last)
    qf = torch.from_numpy(rng.randn(batch, c0, hs, ws).astype(np.float32)
                          ).to(dev).contiguous(
                              memory_format=torch.channels_last)
    fn8 = _chain_fn(stages, qstate, weights, True)
    fnf = _chain_fn(stages, qstate, weights, False)
    is_scope = set(stages).__contains__
    conv_int8.conv3x3_int8.launches = 0
    tr8, _ = measure.trace(lambda: fn8(q8), dev, n=1, warmup=1)
    q1_launches = conv_int8.conv3x3_int8.launches // 2
    trf, _ = measure.trace(lambda: fnf(qf), dev, n=1, warmup=1)
    on_card = tr8.on_card
    g8 = tr8.group(is_scope) if on_card else {}
    gf = trf.group(is_scope) if on_card else {}
    shapes = dm.param_shapes(spec)
    rows, floor_sum, s, chans = [], 0.0, 2, c0
    for nm in stages:
        hh, ww = math.ceil(h / s), math.ceil(w / s)
        if nm.startswith("pool"):
            by = batch * hh * ww * chans * 1.25   # read + 1/4-size write
            floor, bound_by = by / measure.PEAK_BYTES * 1e3, "bytes"
            s *= 2
        else:
            kh, _, ci, co = shapes[nm]["w"]
            ops, by = _conv_cost(batch, hh, ww, kh, ci, co, 1, 1, 1)
            floor, bound_by = measure.bound_ms(by, ops, measure.PEAK_INT8)
            chans = co
        floor_sum += floor
        rows.append({
            "stage": nm, "floor_ms": floor, "floor_by": bound_by,
            "int8_ms": g8.get(nm, {}).get("device_ms") if on_card else None,
            "fp32_ms": gf.get(nm, {}).get("device_ms") if on_card else None})
    walls8 = measure.walls_ms(lambda: fn8(q8), dev, reps, 1)
    wallsf = measure.walls_ms(lambda: fnf(qf), dev, reps, 1)
    rate, rate_ms = measure.copy_bandwidth(
        dev, 2 ** 30 if measure.is_cuda(dev) else 2 ** 24)
    out = {"rows": rows, "floor_ms": floor_sum,
           "int8_device_ms": tr8.busy_ms() if on_card else None,
           "fp32_device_ms": trf.busy_ms() if on_card else None,
           "int8_wall_ms": float(np.median(walls8)),
           "fp32_wall_ms": float(np.median(wallsf)),
           "q1_launches": q1_launches, "copy_bytes_per_s": rate,
           "copy_ms": rate_ms,
           "lost": tr8.lost + trf.lost if on_card else None}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, nargs=2, default=[1408, 1920])
    ap.add_argument("--mask-mode", default="where")
    ap.add_argument("--train", action="store_true",
                    help="time forward+backward (grad of a sum loss in the "
                         "training mask mode): per-layer fwd/bwd like "
                         "`caffe time`")
    ap.add_argument("--bisect", action="store_true",
                    help="cumulative and Δ device ms per VGG stage, then "
                         "the full forward")
    ap.add_argument("--int8-chain", action="store_true",
                    help="the post-stem chain per stage, int8 (Q1) against "
                         "fp32, beside each stage's floor")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev, spec, model, x, valid = _setup(args)
    h, w = args.size
    card = measure.card_line(dev)
    print(f"# {card or 'cpu: no device times'}")
    result = {"tool": "layer_time", "size": [h, w], "batch": args.batch,
              "mask_mode": args.mask_mode, "device": str(dev), "card": card}
    if args.int8_chain:
        res = int8_chain(model, spec, h, w, args.batch, dev, args.reps)
        print(f"# post-stem chain @ {h}x{w} input, B={args.batch}; "
              f"device ms per stage from one profiled run each; floor: "
              f"the int8 bound; measured copy rate "
              f"{res['copy_bytes_per_s'] / 1e9:.0f} GB/s")
        for r in res["rows"]:
            i8 = "-" if r["int8_ms"] is None else f"{r['int8_ms']:7.3f}"
            f32 = "-" if r["fp32_ms"] is None else f"{r['fp32_ms']:7.3f}"
            print(f"  {r['stage']:10s} int8 {i8} ms   fp32 {f32} ms   "
                  f"floor {r['floor_ms']:6.3f} ms ({r['floor_by']})")
        print(f"  CHAIN: int8 wall {res['int8_wall_ms']:.2f} ms, fp32 wall "
              f"{res['fp32_wall_ms']:.2f} ms, floor {res['floor_ms']:.2f} "
              f"ms, Q1 launches {res['q1_launches']}")
        result.update(mode="int8_chain", **res)
    else:
        res = per_layer(model, x, valid, args.train)
        costs = layer_costs(spec, h, w, args.batch)
        mode = "fwd+bwd" if args.train else "forward"
        print(f"# per-layer device time @ {args.batch}x{h}x{w}, {mode}, "
              f"mask {args.mask_mode}, fp32: kernels grouped by the "
              f"forward's record_function scopes (torch.profiler)")
        table = print_table(res, costs, args.train)
        cov = res["coverage"]
        print(f"# device total {res['total_ms']} ms; scoped share of the "
              f"forward {cov if cov is None else round(cov, 4)}"
              + (f", of the backward {res['bwd_coverage']}"
                 if args.train else ""))
        result.update(mode=mode, layers=table, total_ms=res["total_ms"],
                      fwd_ms=res["fwd_ms"], coverage=cov,
                      outside=res["outside"], bwd_ms=res["bwd_ms"],
                      bwd_coverage=res["bwd_coverage"], lost=res["lost"])
        if args.bisect:
            rows, full = bisect_stages(res, costs, spec, h, w, args.batch)
            print("# --bisect: per-scope device ms of one profiled forward, "
                  "cumulative in forward order (no truncated prefixes)")
            for r in rows:
                if r["cum_ms"] is None:
                    print(f"  {r['stage']:10s} (no device)")
                    continue
                print(f"  {r['stage']:10s} cum {r['cum_ms']:8.3f} ms   "
                      f"Δ {r['delta_ms']:7.3f} ms   {r['gflop']:7.1f} GF")
            if full["fwd_ms"]:
                print(f"  {'FULL fwd':10s} {full['fwd_ms']:8.3f} ms, "
                      f"{full['tflops']:.1f} TFLOP/s, "
                      f"{full['of_bound']:.1%} of its bound "
                      f"({full['bound_ms']:.3f} ms)")
            result.update(bisect=rows, full=full,
                          bisect_method="per-scope device time of one "
                                        "profiled forward")
    print(json.dumps(result, default=float), flush=True)
    return result


if __name__ == "__main__":
    main()
