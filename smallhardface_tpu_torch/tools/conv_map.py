"""Map the 3×3 convolutions of the detector's forward over the pyramid
levels of WIDER-sized images on one CUDA card: each distinct shape's
device time beside its bound, the device kernels it launches and the
device memory the call adds, in fp32 or in bf16.

    python -m smallhardface_tpu_torch.tools.conv_map [--levers | --levels |
        --train | --threshold] [--dtype bfloat16] [--out conv_map.json]

The levels are those of the flagship config (TEST.SCALES 100..1400 over
PYRAMID_BASE_SIZE 800×1200) for the images in ``IMAGES``, both at the
exact ×16 shapes of ``detect`` and at the ``TPU.TEST_BUCKET`` = 128 buckets
of ``detect_many``, at batch 2, 4 and 8 (1, 2 and 4 images with their
mirrors). Each shape runs as the forward runs it (``layers.conv3x3``);
``--levers`` also times every shape under the other ways of running it
(``LEVERS``) and traces the ``conv4_fuse_final_dim_red`` shape of the
1408×1872 level through cuDNN cold and warm; ``--levels`` times the
flagship detector's forward per level and ``detect`` instead.
``--threshold`` times only the shapes below ``layers.TAPS_MIN_FLOP``
(which run on cuDNN) under cuDNN and under C1 (``ops/conv_fp32``), the
measurement the threshold rests on. ``--dtype bfloat16`` runs the map
(and ``--levels``' forward and ``detect``, under TPU.PRECISION
"bfloat16") in bf16, against the bf16
bound; its ``--levers`` are cuDNN with the bias fused and the taps summed
in fp32. ``--train`` maps the flagship training step's 3×3 convolutions
with a trainable weight instead, at its buckets (``train_buckets``,
batch 1): each one's forward, data gradient and weight gradient, under
cuDNN as autograd runs them and under the nine products' adjoint
(``layers.conv3x3_taps_grad``), with the kernels each launches (cuDNN's
FFT route or not). Device times come from CUDA graphs, so the host is
not in them. ``chip_smoke.py`` runs ``conv_map`` as its ``cliff_map``
phase. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from smallhardface_tpu_torch.models import layers
from smallhardface_tpu_torch.ops.conv_fp32 import conv3x3_fp32
from smallhardface_tpu_torch.tools.measure import (PEAK_BF16, PEAK_BYTES,
                                                   PEAK_FP32)

IMAGES = ((768, 1024), (1024, 768), (683, 1024), (1024, 1024), (1365, 1024))
SCALES = (100, 300, 600, 1000, 1400)
BASE = (800, 1200)                  # TEST.PYRAMID_BASE_SIZE
BATCHES = (2, 4, 8)
BUCKETS = {"exact": 16, "bucket": 128}
SHORT_SIDES = (400, 800, 1200)          # TRAIN.SCALES.SHORT_SIDE
TRAIN_MAX_SIZE = 2000                   # TRAIN.SCALES.MAX_SIZE


def _round_up(x, m):
    return int(math.ceil(x / m) * m)


def level_shapes(hw, scales=SCALES, base=BASE):
    """The (hb, wb) ×16 level shapes of an (h, w) image under the
    multi-scale rule of ``detect._pyramid_scales``."""
    h0, w0 = hw
    s = base[0] / min(hw)
    if round(s * max(hw)) > base[1]:
        s = base[1] / max(hw)
    out = []
    for t in scales:
        f = t / base[0] * s
        out.append((_round_up(round(h0 * f), 16),
                    _round_up(round(w0 * f), 16)))
    return out


def forward_convs(hb, wb):
    """The 3×3 convolutions of the VGG-16 detector's forward at an
    (hb, wb) level, conv1 (the fused stem) aside: (name, C, O, H, W,
    dilation)."""
    convs = [("conv2_1", 64, 128, 2), ("conv2_2", 128, 128, 2),
             ("conv3_1", 128, 256, 4), ("conv3_2", 256, 256, 4),
             ("conv3_3", 256, 256, 4), ("conv4_1", 256, 512, 8),
             ("conv4_2", 512, 512, 8), ("conv4_3", 512, 512, 8),
             ("conv5_1", 512, 512, 16), ("conv5_2", 512, 512, 16),
             ("conv5_3", 512, 512, 16), ("conv4_fuse_final", 512, 512, 8),
             ("conv4_fuse_final_dim_red", 512, 128, 8)]
    out = [(n, c, o, hb // s, wb // s, 1) for n, c, o, s in convs]
    out += [(f"head_d{d}", 128, 128, hb // 8, wb // 8, d) for d in (1, 2, 4)]
    return out


def shard_convs(hb, wb, k):
    """The 3×3 convolutions of the forward over k shards of an (hb, wb)
    level (``parallel/spatial``: the level padded to ``padded_height``),
    conv1 aside, as each shard runs them (``layers.conv3x3`` with a halo):
    (name, C, O, rows in, W, dilation, (top, bottom) halo), for a shard at
    the image's top (its bottom twin has the same shape) and, for k > 2,
    an inner one."""
    from smallhardface_tpu_torch.parallel import spatial
    out = []
    for name, c, o, h, w, d in forward_convs(
            spatial.padded_height(hb, k), wb):
        for halo in [(0, d)] + ([(d, d)] if k > 2 else []):
            out.append((name, c, o, h // k + sum(halo), w, d, halo))
    return out


def shape_map(images=IMAGES, batches=BATCHES):
    """{(B, C, O, H, W, d): [where, ...]} over every image, level, kind
    (exact / bucket) and batch."""
    shapes = {}
    for hw in images:
        for li, (hb, wb) in enumerate(level_shapes(hw)):
            for kind, m in BUCKETS.items():
                hk, wk = _round_up(hb, m), _round_up(wb, m)
                for name, c, o, h, w, d in forward_convs(hk, wk):
                    for B in batches:
                        shapes.setdefault((B, c, o, h, w, d), []).append(
                            f"{hw[0]}x{hw[1]}/L{li}/{kind}/{name}")
    return shapes


def bound_ms(B, C, O, H, W, dtype=torch.float32):
    """The larger of the FLOP at the dtype's peak (fp32 on the CUDA cores,
    bf16 on the tensor cores) and the bytes (input, weights and output
    once, in the dtype) at the memory rate."""
    bf16 = dtype == torch.bfloat16
    flop = 2.0 * B * H * W * 9 * C * O
    n_bytes = (2.0 if bf16 else 4.0) * (B * H * W * (C + O) + 9 * C * O + O)
    t_f = flop / (PEAK_BF16 if bf16 else PEAK_FP32) * 1e3
    t_b = n_bytes / PEAK_BYTES * 1e3
    return max(t_f, t_b), ("operations" if t_f >= t_b else "bytes"), flop


def cudnn(x, w, b, d):
    return F.conv2d(x, w, b, padding=d, dilation=d)


def cudnn_b1(x, w, b, d):
    return torch.cat([cudnn(x[i:i + 1], w, b, d) for i in range(x.shape[0])])


def cudnn_nchw(x, w, b, d):
    return cudnn(x.contiguous(), w.contiguous(), b, d)


def cudnn_nondet(x, w, b, d):
    torch.backends.cudnn.deterministic = False
    try:
        return cudnn(x, w, b, d)
    finally:
        torch.backends.cudnn.deterministic = True


def taps(x, w, b, d):
    """The nine products of ``layers.conv3x3_taps``; in bf16 each product
    sums into an fp32 accumulator (cuBLAS with ``out_dtype``), which is
    rounded to bf16 once before the bf16 bias, the rounding the bf16
    forward needs."""
    if x.dtype != torch.bfloat16:
        return layers.conv3x3_taps(x, w, b, dilation=d)
    B, C, H, W = x.shape
    O = w.shape[0]
    Hp, Wp = H + 2 * d, W + 2 * d
    w9 = w.permute(2, 3, 1, 0)                      # (3, 3, C, O)
    rows = F.pad(x.permute(0, 2, 3, 1), (0, 0, d, d, d, d)).reshape(-1, C)
    acc = torch.mm(rows, w9[1, 1], out_dtype=torch.float32)
    n = acc.shape[0]
    for ky in range(3):
        for kx in range(3):
            s = (ky - 1) * d * Wp + (kx - 1) * d
            if s:
                lo, hi = max(0, -s), n - max(0, s)
                part = acc[lo:hi]
                torch.addmm(part, rows[lo + s:hi + s], w9[ky, kx],
                            out_dtype=torch.float32, out=part)
    out = acc.view(B, Hp, Wp, O)[:, d:d + H, d:d + W].to(torch.bfloat16) + b
    return out.permute(0, 3, 1, 2)


def gemm9(x, w, b, d):
    """All nine taps as one product (B·H·W, C) @ (C, 9·O), then F.fold
    sums each output pixel's nine shifted products (the taps flipped)."""
    B, C, H, W = x.shape
    O = w.shape[0]
    rows = x.permute(0, 2, 3, 1).reshape(B * H * W, C)
    wm = w.flip(2, 3).reshape(O, C, 9).permute(1, 0, 2).reshape(C, O * 9)
    y = (rows @ wm).view(B, H * W, O * 9).transpose(1, 2)
    out = F.fold(y, (H, W), 3, dilation=d, padding=d)
    return (out + b[:, None, None]).contiguous(
        memory_format=torch.channels_last)


def port(x, w, b, d):
    """As the forward runs it (``layers.conv3x3``)."""
    return layers.conv3x3(x, w, b, dilation=d)


def c1(x, w, b, d):
    """C1 (``ops/conv_fp32.conv3x3_fp32``) at any FLOP count."""
    return conv3x3_fp32(x, w, b, dilation=d)


LEVERS = {"port": port, "cudnn": cudnn, "cudnn_b1": cudnn_b1,
          "cudnn_nchw": cudnn_nchw, "cudnn_nondet": cudnn_nondet,
          "taps": taps, "gemm9": gemm9, "c1": c1}
# scratch of gemm9's product beyond which it is not timed
GEMM9_BYTES = 4e9


def inputs(shape, dev, gen, dtype=torch.float32):
    B, C, O, H, W, _ = shape
    x = torch.randn((B, C, H, W), device=dev, generator=gen).to(
        dtype).contiguous(memory_format=torch.channels_last)
    w = (torch.randn((O, C, 3, 3), device=dev, generator=gen)
         * math.sqrt(2 / (9 * C))).to(dtype).contiguous(
        memory_format=torch.channels_last)
    b = (torch.randn((O,), device=dev, generator=gen) * 0.1).to(dtype)
    return x, w, b


def bf16_vs_fp32(x, w, d, padding=None):
    """A bf16 convolution as the forward runs it (``layers.conv2d`` on a
    bf16 x, no bias) against the fp32 sum of the same bf16 products (TF32
    off) rounded to bf16 once: the share of outputs that differ, and the
    largest difference over its bound, two fp32 sums of the same terms in
    different orders (2·K·2⁻²³·Σ|x·w|, K terms) plus a bf16 ulp (> 1: a
    rounding the JAX bf16 mode does not make)."""
    pad = d if padding is None else padding
    got = layers.conv2d(x, w, None, dilation=d, padding=pad)
    wr = w.to(torch.bfloat16).float()
    plain = F.conv2d(x.float(), wr, None, dilation=d, padding=pad)
    abs_sum = F.conv2d(x.float().abs(), wr.abs(), None, dilation=d,
                       padding=pad)
    ref = plain.to(torch.bfloat16)
    ulp = torch.maximum(got.float().abs(), ref.float().abs()) * 2.0 ** -7
    bound = 2 * w[0].numel() * 2.0 ** -23 * abs_sum + ulp
    over = ((got.float() - ref.float()).abs()
            / bound.clamp_min(1e-30)).max().item()
    return {"differ_share": (got != ref).float().mean().item(),
            "max_err_over_bound": over, "dtype": str(got.dtype)}


def device_kernels(fn, n=1):
    """{kernel name: device ms per call} of n calls under torch.profiler,
    and the CUDA runtime calls of note on the host (count, host ms)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kern, runtime = {}, {}
    for ev in prof.key_averages():
        if ev.self_device_time_total > 0:
            kern[ev.key[:120]] = ev.self_device_time_total / n / 1e3
        if ev.key in ("cudaMalloc", "cudaFree", "cudaMallocAsync",
                      "cudaFreeAsync", "cudaStreamSynchronize",
                      "cudaDeviceSynchronize", "cudaMemsetAsync"):
            runtime[ev.key] = {"count": ev.count,
                               "host_ms": ev.cpu_time_total / 1e3}
    kern = dict(sorted(kern.items(), key=lambda kv: -kv[1])[:6])
    return kern, runtime


def graph_ms(fn, reps, n=3):
    """Device time of one call of fn without the host: reps calls captured
    in one CUDA graph, replayed between two CUDA events; the median of n
    replays over reps."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(a.elapsed_time(e) / reps)
    del graph
    return float(np.median(times))


def time_call(fn):
    """(first-call wall ms, the warm call's wall ms on CUDA events, its
    device time from a CUDA graph, and the device memory the warm call
    adds beyond its inputs and output)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    first = (time.perf_counter() - t) * 1e3
    del out
    a = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    a.record()
    out = fn()
    e.record()
    e.synchronize()
    wall = a.elapsed_time(e)
    added = torch.cuda.max_memory_allocated() - base - (
        out.numel() * out.element_size())
    del out
    torch.cuda.empty_cache()        # a capture allocates its own scratch
    device = graph_ms(fn, reps=20 if wall < 1 else 5 if wall < 20 else 1)
    torch.cuda.empty_cache()
    return first, wall, device, int(added)


@torch.inference_mode()
def conv_map(dev, levers=("port",), profile_over=5.0, log=print,
             dtype=torch.float32, images=IMAGES, batches=BATCHES,
             select=lambda shape: True):
    """Time every distinct shape of ``shape_map(images, batches)`` that
    ``select`` takes under each lever, under inference_mode as detection
    runs them, on inputs of
    ``dtype`` against that dtype's bound; in bf16 the forward's way is
    also held against the fp32 sum rounded once (``bf16_vs_fp32``). A
    shape's kernels
    are traced where it takes more than ``profile_over`` times its bound,
    adds more than 1 GB or is a shape of ``conv4_fuse_final_dim_red``.
    Returns the rows, one per (shape, lever)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for shape, where in sorted(shape_map(images, batches).items(),
                               key=lambda kv: kv[0]):
        if not select(shape):
            continue
        B, C, O, H, W, d = shape
        bnd, by, flop = bound_ms(B, C, O, H, W, dtype)
        x, w, b = inputs(shape, dev, gen, dtype)
        for lever in levers:
            fn = LEVERS[lever]
            if lever == "gemm9" and 36.0 * B * H * W * O > GEMM9_BYTES:
                continue
            call = lambda: fn(x, w, b, d)       # noqa: E731
            first, wall, ms, added = time_call(call)
            row = {"shape": list(shape), "layers": sorted({
                s.rsplit("/", 1)[1] for s in where}), "n_levels": len(where),
                "lever": lever, "dtype": str(dtype).split(".")[1],
                "ms": ms, "wall_ms": wall,
                "first_ms": first,
                "bound_ms": bnd, "bound_by": by, "of_bound": ms / bnd,
                "tflops": flop / ms / 1e9, "added_bytes": added}
            if ((ms > profile_over * bnd and bnd >= 0.05) or added > 1e9
                    or "conv4_fuse_final_dim_red" in row["layers"]):
                row["kernels"], row["runtime"] = device_kernels(call)
            if lever == "port" and dtype == torch.bfloat16:
                row.update(bf16_vs_fp32(x, w, d))
            rows.append(row)
            log(row)
        del x, w, b
        torch.cuda.empty_cache()
    return rows


def trace_cliff(dev, shape=(2, 512, 128, 176, 234, 1)):
    """One shape cold (a fresh allocator cache) and warm under torch
    .profiler: its device kernels, the runtime calls on the host, and the
    allocator's counters around each call."""
    gen = torch.Generator(device=dev).manual_seed(1)
    x, w, b = inputs(shape, dev, gen)
    out = {}
    for phase in ("cold", "warm"):
        if phase == "cold":
            torch.cuda.empty_cache()
        before = torch.cuda.memory_stats()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        kern, runtime = device_kernels(lambda: cudnn(x, w, b, shape[5]))
        wall = (time.perf_counter() - t) * 1e3
        after = torch.cuda.memory_stats()
        out[phase] = {
            "wall_ms_with_profiler": wall, "kernels": kern,
            "runtime": runtime,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "reserved_bytes": torch.cuda.memory_reserved(),
            "allocator": {k: after.get(k, 0) - before.get(k, 0) for k in (
                "num_alloc_retries", "num_device_alloc", "num_device_free",
                "num_ooms")}}
    return {"shape": list(shape), **out}


def train_buckets(images=IMAGES[:3], short_sides=SHORT_SIDES,
                  max_size=TRAIN_MAX_SIZE):
    """The (hb, wb) training buckets of the flagship config at batch 1:
    each image's short side resized to each of TRAIN.SCALES.SHORT_SIDE
    (the long side at most TRAIN.SCALES.MAX_SIZE), uncropped, snapped to
    MAX_RESOLUTION and then to ``train_loop.BUCKET``."""
    from smallhardface_tpu_torch.train.train_loop import BUCKET, _snap
    out = []
    for hw in images:
        for side in short_sides:
            s = side / min(hw)
            if round(s * max(hw)) > max_size:
                s = max_size / max(hw)
            hb, wb = (_snap(_snap(round(v * s), 16), BUCKET) for v in hw)
            if (hb, wb) not in out:
                out.append((hb, wb))
    return out


def train_convs(hb, wb):
    """The 3×3 convolutions with a trainable weight in the flagship
    training step at an (hb, wb) bucket: ``forward_convs`` without the
    frozen conv2_*; (name, C, O, H, W, dilation, needs dx). conv3_1's
    input comes from the frozen conv2, so it takes no data gradient."""
    return [(n, c, o, h, w, d, n != "conv3_1")
            for n, c, o, h, w, d in forward_convs(hb, wb)
            if not n.startswith("conv2")]


def cudnn_grad(x, w, dy, d, need_x, need_w):
    """cuDNN's backward as autograd runs it for ``F.conv2d`` (padding d),
    one gradient: dx (need_x) or dw."""
    out = torch.ops.aten.convolution_backward(
        dy, x, w, None, [1, 1], [d, d], [d, d], False, [0, 0], 1,
        [need_x, need_w, False])
    return out[0] if need_x else out[1]


def adjoint_grad(x, w, dy, d, need_x, need_w):
    """The nine products' adjoint (``layers.conv3x3_taps_grad``), one
    gradient: dx (need_x) or dw."""
    dx, dw = layers.conv3x3_taps_grad(x, w, dy, dilation=d, need_x=need_x,
                                      need_w=need_w)
    return dx if need_x else dw


def route_kernels(kern):
    """Whether a traced call launched cuDNN's FFT route (an ``fft`` or a
    ``gemv`` kernel)."""
    return any("fft" in k or "gemv" in k for k in kern)


def train_map(dev, log=print, buckets=None):
    """Each distinct trainable 3×3 convolution of the flagship training
    step at each training bucket (``train_buckets``, batch 1): its
    forward (cuDNN, on both routes) and its data and weight gradients
    under cuDNN as autograd runs them and under the adjoint, each with
    its device ms (CUDA graphs), the memory the call adds, the bound and
    its kernels (FFT or not). Returns {"rows": [...], "shapes": [...]}:
    a row per (shape, pass, route) and a line per shape with its FLOP and
    both routes' backward ms (data gradient where the layer takes one,
    and weight gradient)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = {}
    for hb, wb in buckets or train_buckets():
        for name, c, o, h, w, d, need_x in train_convs(hb, wb):
            shapes.setdefault((1, c, o, h, w, d, need_x), []).append(
                f"{hb}x{wb}/{name}")
    rows, lines = [], []
    for shape, where in sorted(shapes.items()):
        B, C, O, H, W, d, need_x = shape
        bnd, by, flop = bound_ms(B, C, O, H, W)
        x, wt, b = inputs(shape[:6], dev, gen)
        dy = torch.randn((B, O, H, W), device=dev, generator=gen).contiguous(
            memory_format=torch.channels_last)
        calls = {("forward", "cudnn"): lambda: cudnn(x, wt, b, d)}
        for pas in (("dgrad",) if need_x else ()) + ("wgrad",):
            for route, fn in (("cudnn", cudnn_grad),
                              ("adjoint", adjoint_grad)):
                calls[(pas, route)] = (
                    lambda fn=fn, gx=pas == "dgrad":
                    fn(x, wt, dy, d, gx, not gx))
        ms = {}
        for (pas, route), call in calls.items():
            first, wall, t, added = time_call(call)
            kern, _ = device_kernels(call)
            row = {"shape": list(shape[:6]), "where": where, "pass": pas,
                   "route": route, "ms": t, "wall_ms": wall,
                   "first_ms": first, "bound_ms": bnd, "bound_by": by,
                   "of_bound": t / bnd, "tflops": flop / t / 1e9,
                   "added_bytes": added, "fft": route_kernels(kern),
                   "kernels": kern}
            ms[(pas, route)] = t
            rows.append(row)
            log(row)
        backward = {r: sum(v for (p, rr), v in ms.items()
                           if rr == r and p != "forward")
                    for r in ("cudnn", "adjoint")}
        line = {"shape": list(shape[:6]), "needs_dx": need_x,
                "layers": sorted({s.rsplit("/", 1)[1] for s in where}),
                "flop": flop, "cudnn_backward_ms": backward["cudnn"],
                "adjoint_backward_ms": backward["adjoint"],
                "adjoint_faster": backward["adjoint"] < backward["cudnn"]}
        lines.append(line)
        log(line)
        del x, wt, b, dy
        torch.cuda.empty_cache()
    return {"buckets": [list(b) for b in buckets or train_buckets()],
            "rows": rows, "shapes": lines}


def level_walls(dev, image_hw=(768, 1024), reps=3, precision="float32"):
    """The flagship detector (random weights from seed 0) on one seeded
    image in ``precision``: each level's forward at batch 2 (image and
    mirror) on the host clock after a synchronisation, with the device
    memory it adds beyond its input, and warm ``detect`` walls with the
    peak of the process."""
    from smallhardface_tpu_torch.config import CONFIG_DIR, cfg, cfg_from_file
    from smallhardface_tpu_torch.detect import TorchDetector
    from smallhardface_tpu_torch.models import detector as tdm
    import os
    cfg_from_file(os.path.join(CONFIG_DIR, "smallhardface.toml"))
    cfg.TEST.SCALES = list(SCALES)
    cfg.TEST.FLIP = True
    cfg.TPU.PRECISION = precision
    spec = tdm.build_spec(cfg)
    params = tdm.init_params(torch.Generator().manual_seed(0), spec)
    det = TorchDetector(params, spec, dev)
    image = np.random.RandomState(0).randint(
        0, 256, (*image_hw, 3)).astype(np.uint8)
    levels = []
    with torch.inference_mode():
        for hb, wb in level_shapes(image_hw):
            x = torch.randn((2, hb, wb, 3), device=dev)
            walls = []
            for _ in range(reps + 1):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                det.model(x, precision=precision)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t) * 1e3)
            levels.append({"level": [hb, wb], "forward_ms": walls[1:],
                           "added_bytes": torch.cuda.max_memory_allocated()
                           - base})
            del x
    detect = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        det.detect(image, 0.05)
        torch.cuda.synchronize()
        detect.append(time.perf_counter() - t)
    return {"image": list(image_hw), "precision": precision,
            "levels": levels,
            "detect_s": detect[1:], "detect_first_s": detect[0],
            "detect_peak_bytes": torch.cuda.max_memory_allocated()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--levers", action="store_true")
    p.add_argument("--threshold", action="store_true",
                   help="only the shapes below layers.TAPS_MIN_FLOP, "
                        "under cuDNN and C1")
    p.add_argument("--levels", action="store_true",
                   help="only the per-level forward and detect walls")
    p.add_argument("--train", action="store_true",
                   help="only the training step's convolutions: forward, "
                        "data and weight gradients, cuDNN and the adjoint")
    p.add_argument("--dtype", choices=("float32", "bfloat16"),
                   default="float32")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    dtype = getattr(torch, args.dtype)
    if not torch.cuda.is_available():
        raise SystemExit("conv_map needs a CUDA card")
    from smallhardface_tpu_torch.models.detector import pin_fp32_numerics
    pin_fp32_numerics()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    result = {"device": smi, "torch": torch.__version__,
              "cudnn": torch.backends.cudnn.version()}
    log = lambda r: print(json.dumps(r), flush=True)   # noqa: E731
    if args.train:
        result["train_map"] = train_map(dev, log=log)
    elif args.levels:
        result["level_walls"] = level_walls(dev, precision=args.dtype)
        log(result["level_walls"])
    elif args.threshold:
        result["threshold"] = conv_map(
            dev, levers=("cudnn", "c1"), log=log, select=lambda s: (
                18.0 * s[0] * s[3] * s[4] * s[1] * s[2]
                < layers.TAPS_MIN_FLOP))
    else:
        bf16 = dtype == torch.bfloat16
        if args.levers and not bf16:
            result["trace"] = trace_cliff(dev)
            log(result["trace"])
        result["map"] = conv_map(dev, log=log, dtype=dtype)
        if args.levers:
            # in bf16: cuDNN with its bias fused (one rounding, so not the
            # forward's numbers: a yardstick) and the fp32-summed taps
            result["levers"] = conv_map(
                dev, levers=(("cudnn", "taps") if bf16 else
                             ("cudnn", "cudnn_b1", "taps", "gemm9")),
                log=log, dtype=dtype)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
