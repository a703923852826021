#!/usr/bin/env python3
"""Device time of the stem kernel K1 (smallhardface_tpu_torch/csrc/stem.cu)
against an earlier source of it, on one NVIDIA card, in turns.

    git show <rev>:smallhardface_tpu_torch/csrc/stem.cu > runs/stem_parent.cu
    python3 scripts/k1_vs_parent.py runs/stem_parent.cu

The earlier source must have the C interface K1 had before it wrote the
pool's routing: shf_stem_forward(x, w1, b1, w2, b2, out, B, H, W, vh, vw,
stream). Both sources are built with the port's nvcc flags
(ops/cuda_build.py). At (2, 1408, 1872, 3) and at the five level shapes of
a 768×1024 image's detection pyramid (flip batched, no masking), on float
inputs made from a seed, each is timed as 20 calls captured in one CUDA
graph, replayed between two CUDA events (median of 5 replays, per call), in
the order earlier, this, this, earlier; the two outputs must agree within
chip_smoke.py's RTOL. Prints the card's name and power limit, one JSON line
per shape and one for the sum over the pyramid. Exits nonzero without a
card.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

LARGEST = (2, 1408, 1872, 3)
PYRAMID = [(2, h, w, 3) for h, w in ((112, 144), (304, 400), (608, 800),
                                      (1008, 1344), (1408, 1872))]
RTOL = 1e-4
REPS = 20


def graph_ms(fn, reps=REPS, n=5):
    """Per-call device time of fn: reps calls in one CUDA graph (relaxed
    capture: the earlier launcher sets a function attribute on every
    call), replayed between two CUDA events, median of n replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return float(np.median(times))


def main(argv):
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    from smallhardface_tpu_torch.models.detector import pin_fp32_numerics
    from smallhardface_tpu_torch.ops import cuda_build, stem
    pin_fp32_numerics()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    earlier = cuda_build.CudaLibrary(
        "stem_earlier", os.path.abspath(argv[0]),
        {"shf_stem_forward": [cuda_build.VP] * 6 + [cuda_build.CI] * 5
         + [cuda_build.VP]})
    cuda_build.build_all([earlier, stem.STEM])
    lib = earlier.load()
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    w1, b1, w2, b2 = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.randn(64, 3, 3, 3) * np.sqrt(2 / 27), rng.randn(64) * 0.5,
        rng.randn(64, 64, 3, 3) * np.sqrt(2 / 576), rng.randn(64) * 0.5)]
    w1k = w1.permute(2, 3, 1, 0).contiguous()
    w2k = w2.permute(2, 3, 1, 0).contiguous()
    total = {"earlier": [0.0, 0.0], "this": [0.0, 0.0]}
    for shape in [LARGEST] + PYRAMID:
        B, H, W, _ = shape
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 50).to(dev)
        out = torch.empty((B, H // 2, W // 2, 64), device=dev)

        def run_earlier():
            earlier.check(lib.shf_stem_forward(
                x.data_ptr(), w1k.data_ptr(), b1.data_ptr(), w2k.data_ptr(),
                b2.data_ptr(), out.data_ptr(), B, H, W, H, W,
                torch.cuda.current_stream().cuda_stream), "earlier stem")

        def run_this():
            return stem.fused_stem(x, w1, b1, w2, b2)

        run_earlier()
        got = run_this()
        torch.cuda.synchronize()
        scale = out.abs().max().item()
        err = (got - out).abs().max().item()
        if err > 2 * RTOL * scale:
            raise AssertionError(f"the two kernels disagree at {shape}")
        times = {"earlier": [], "this": []}
        for which in ("earlier", "this", "this", "earlier"):
            fn = run_earlier if which == "earlier" else run_this
            times[which].append(graph_ms(fn))
        print("k1_vs_parent: " + json.dumps({
            "shape": list(shape), "earlier_device_ms": times["earlier"],
            "this_device_ms": times["this"], "max_err_over_peak": err / scale,
            "timing": f"{REPS} calls in one CUDA graph, median of 5 replays, "
                      "per call; in turns earlier, this, this, earlier"}),
            flush=True)
        if shape in PYRAMID:
            for k in total:
                total[k] = [a + b for a, b in zip(total[k], times[k])]
        del x, out, got
        torch.cuda.empty_cache()
    print("k1_vs_parent_pyramid: " + json.dumps({
        "shapes": [list(s) for s in PYRAMID],
        "earlier_device_ms_sum": total["earlier"],
        "this_device_ms_sum": total["this"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
