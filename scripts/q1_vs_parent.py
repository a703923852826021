#!/usr/bin/env python3
"""Device time of the int8 convolution kernel Q1
(smallhardface_tpu_torch/csrc/conv_int8.cu) against an earlier source of
it, on one NVIDIA card, in turns.

    git show <rev>:smallhardface_tpu_torch/csrc/conv_int8.cu \\
        > runs/conv_int8_parent.cu
    python3 scripts/q1_vs_parent.py runs/conv_int8_parent.cu

The earlier source must have the C interface Q1 had before it took a tile
plan: shf_conv3x3_int8(x, w, scale, scale_stride, bias, B, H, W, C, O,
dilation, epilogue, s_out, out, stream). Both sources are built with the
port's nvcc flags (ops/conv_int8.py) and called through their C entry
points on the same inputs: int8 values and weights made from a seed, a
scale row, a bias, at batch 2 (image and mirror). The shapes are the 16
int8 convolutions of the 1408×1872 level (chip_smoke.int8_layer_shapes)
and the 80 of a calibrated int8 ``detect`` of a 768×1024 image (its five
levels, detect.level_sizes under smallhardface-int8.toml at
chip_smoke.INT8_SCALES), each with the epilogue the chain runs there. At
each distinct shape both outputs must be equal to the bit; each is timed
as 10 calls captured in one CUDA graph, replayed between two CUDA events
(median of 3 replays, per call), in the order earlier, this, this,
earlier. Then the host time of one call of each C entry point (the new
one encodes two TMA tensor maps a call): HOST_CALLS calls at the smallest
shape, without a synchronisation inside, on the host clock, in the same
turns. Prints the card's name and power limit, one JSON line per shape
(device ms of each, the bound, the share of the bound), one line for each
sum and one for the host time. Exits nonzero without a card or where the
outputs differ.

    python3 scripts/q1_vs_parent.py --requantize

times instead this source's two requantizes of a chain link against each
other at the same tile plan: the product with fl(1 / s_out) and its exact
tie tests (epilogue 0) and the division of every element (epilogue 3), at
the chain links of the 1408×1872 level and of the int8 ``detect``, in
the order product, division, division, product, equal to the bit.
"""

import ctypes
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

REPS = 10
HOST_CALLS = 200
EPILOGUES = {"link": 0, "end": 1}


def host_us(fn, n=HOST_CALLS):
    """Host microseconds a call of fn, over n calls after a
    synchronisation (the device runs them meanwhile)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return t / n * 1e6


def main(argv):
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    if argv[0] == "--requantize":
        return requantize()
    import chip_smoke as cs
    from smallhardface_tpu_torch.ops import conv_int8, cuda_build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    VP, CI = cuda_build.VP, cuda_build.CI
    earlier = cuda_build.CudaLibrary(
        "conv_int8_earlier", os.path.abspath(argv[0]),
        {"shf_conv3x3_int8": [VP] * 3 + [CI] + [VP] + [CI] * 7
         + [ctypes.c_float, VP, VP]},
        extra_flags=conv_int8.CONV_INT8.flags[len(cuda_build.NVCC_FLAGS):])
    cuda_build.build_all([earlier, conv_int8.CONV_INT8])
    old, new = earlier.load(), conv_int8.CONV_INT8.load()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 13)

    sets, levels = shape_sets()
    timed = {}
    for level, (name, C, O, H, W, d, epi) in sets["level_1408"] + \
            sets["detect"]:
        key = (C, O, H, W, d, epi)
        if key in timed:
            continue
        B = 2
        x, w, scale, bias, s_out = cs._q1_inputs(gen, B, C, O, H, W, dev,
                                                False, False)
        nhwc = x.permute(0, 2, 3, 1)
        dtype = torch.int8 if epi == "link" else torch.float32
        outs = {k: torch.empty((B, H, W, O), device=dev, dtype=dtype)
                for k in ("earlier", "this")}
        args = (nhwc.data_ptr(), w.data_ptr(), scale.data_ptr(), 0,
                bias.data_ptr(), B, H, W, C, O, d, EPILOGUES[epi], s_out)
        plan = conv_int8.plan(H, W, C, O)

        def run_earlier():
            earlier.check(old.shf_conv3x3_int8(
                *args, outs["earlier"].data_ptr(),
                torch.cuda.current_stream().cuda_stream), "earlier Q1")

        def run_this():
            conv_int8.CONV_INT8.check(new.shf_conv3x3_int8(
                *args, outs["this"].data_ptr(), *plan,
                torch.cuda.current_stream().cuda_stream), "Q1")

        run_earlier()
        run_this()
        torch.cuda.synchronize()
        if not torch.equal(outs["earlier"], outs["this"]):
            raise AssertionError(f"the two kernels differ at {name} "
                                 f"{[B, C, O, H, W]} d={d}")
        times = {"earlier": [], "this": []}
        for which in ("earlier", "this", "this", "earlier"):
            times[which].append(cs.graph_ms(
                run_earlier if which == "earlier" else run_this,
                reps=REPS, n=3))
        bound = cs.q1_bound_ms(B, C, O, H, W, epi == "link")[0]
        row = {"level": list(level), "layer": name, "shape": [B, C, O, H, W],
               "dilation": d, "epilogue": epi, "plan": list(plan),
               "earlier_device_ms": times["earlier"],
               "this_device_ms": times["this"], "bound_ms": bound,
               "this_of_bound": bound / min(times["this"]),
               "earlier_of_bound": bound / min(times["earlier"]),
               "bit_equal": True}
        timed[key] = row
        print("q1_vs_parent: " + json.dumps(row), flush=True)
        if name == "head_d1" and level == levels[0]:   # the smallest call
            host = {"earlier": [], "this": []}
            for which in ("earlier", "this", "this", "earlier"):
                host[which].append(host_us(
                    run_earlier if which == "earlier" else run_this))
        del x, w, scale, bias, nhwc, outs
    for label, rows in sets.items():
        picked = [timed[(C, O, H, W, d, epi)]
                  for _, (_, C, O, H, W, d, epi) in rows]
        total = {k: [sum(r[k][i] for r in picked) for i in range(2)]
                 for k in ("earlier_device_ms", "this_device_ms")}
        bound = sum(r["bound_ms"] for r in picked)
        slower = [r["layer"] for r in picked
                  if min(r["this_device_ms"]) > max(r["earlier_device_ms"])]
        print(f"q1_vs_parent_{label}: " + json.dumps({
            "convolutions": len(picked), **{k + "_sum": v
                                            for k, v in total.items()},
            "bound_ms_sum": bound,
            "this_of_bound": bound / min(total["this_device_ms"]),
            "this_over_earlier": min(total["this_device_ms"])
            / min(total["earlier_device_ms"]),
            "slower_than_earlier": slower,
            "timing": f"{REPS} calls in one CUDA graph, median of 3 "
                      "replays, per call; in turns earlier, this, this, "
                      "earlier; sums over the convolutions"}), flush=True)
    print("q1_vs_parent_host: " + json.dumps({
        "shape": [2, 128, 128, levels[0][0] // 8, levels[0][1] // 8],
        "earlier_host_us": host["earlier"], "this_host_us": host["this"],
        "timing": f"host clock over {HOST_CALLS} C-entry calls after a "
                  "synchronisation, per call; in turns earlier, this, "
                  "this, earlier"}), flush=True)
    return 0


def shape_sets():
    """The (level, layer row) pairs of the 1408×1872 level and of the int8
    ``detect`` of a 768×1024 image, and the smallest level."""
    import chip_smoke as cs
    from smallhardface_tpu_torch.config import CONFIG_DIR, cfg, cfg_from_file
    from smallhardface_tpu_torch.detect import level_sizes
    cfg_from_file(os.path.join(CONFIG_DIR, "smallhardface-int8.toml"))
    cfg.TEST.SCALES = list(cs.INT8_SCALES)
    levels = [(hb, wb) for *_, hb, wb in level_sizes((768, 1024, 3))]
    sets = {"level_1408": [(cs.INT8_LEVEL, r)
                           for r in cs.int8_layer_shapes()],
            "detect": [(lv, r) for lv in levels
                       for r in cs.int8_layer_shapes(lv)]}
    assert len(sets["level_1408"]) == 16 and len(sets["detect"]) == 80
    return sets, levels


def requantize():
    """The product requantize against the division, at the chain links."""
    import chip_smoke as cs
    from smallhardface_tpu_torch.ops import conv_int8
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    lib = conv_int8.CONV_INT8.load()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 13)
    sets, _ = shape_sets()
    timed = {}
    for level, (name, C, O, H, W, d, epi) in sets["level_1408"] + \
            sets["detect"]:
        key = (C, O, H, W, d)
        if epi != "link" or key in timed:
            continue
        B = 2
        x, w, scale, bias, s_out = cs._q1_inputs(gen, B, C, O, H, W, dev,
                                                False, False)
        nhwc = x.permute(0, 2, 3, 1)
        outs = {k: torch.empty((B, H, W, O), device=dev, dtype=torch.int8)
                for k in ("product", "division")}
        plan = conv_int8.plan(H, W, C, O)

        def run(which):
            conv_int8.CONV_INT8.check(lib.shf_conv3x3_int8(
                nhwc.data_ptr(), w.data_ptr(), scale.data_ptr(), 0,
                bias.data_ptr(), B, H, W, C, O, d,
                0 if which == "product" else 3, s_out,
                outs[which].data_ptr(), *plan,
                torch.cuda.current_stream().cuda_stream), "Q1")

        run("product")
        run("division")
        torch.cuda.synchronize()
        if not torch.equal(outs["product"], outs["division"]):
            raise AssertionError(f"the two requantizes differ at {name} "
                                 f"{[B, C, O, H, W]}")
        times = {"product": [], "division": []}
        for which in ("product", "division", "division", "product"):
            times[which].append(cs.graph_ms(lambda: run(which), reps=REPS,
                                            n=3))
        row = {"level": list(level), "layer": name, "shape": [B, C, O, H, W],
               "plan": list(plan), "product_device_ms": times["product"],
               "division_device_ms": times["division"],
               "bound_ms": cs.q1_bound_ms(B, C, O, H, W, True)[0],
               "bit_equal": True}
        timed[key] = row
        print("q1_requantize: " + json.dumps(row), flush=True)
        del x, w, scale, bias, nhwc, outs
    for label, rows in sets.items():
        picked = [timed[(C, O, H, W, d)]
                  for _, (_, C, O, H, W, d, epi) in rows if epi == "link"]
        total = {k: [sum(r[k][i] for r in picked) for i in range(2)]
                 for k in ("product_device_ms", "division_device_ms")}
        print(f"q1_requantize_{label}: " + json.dumps({
            "links": len(picked), **{k + "_sum": v
                                     for k, v in total.items()},
            "division_over_product": min(total["division_device_ms"])
            / min(total["product_device_ms"]),
            "timing": f"{REPS} calls in one CUDA graph, median of 3 "
                      "replays, per call; in turns product, division, "
                      "division, product; sums over the links"}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
