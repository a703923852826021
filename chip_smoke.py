#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's three CUDA kernels with nvcc, one process per source, all
at once: the fused VGG stem (K1, csrc/stem.cu), its backward (K2,
csrc/stem_grad.cu) and the anchor max-IoU (K3, csrc/iou.cu). Then, each
phase printing one line:

1. K1 against its plain version at the shapes of the detection path;
2. full-pyramid detection at the flagship configuration (VGG-16 at full
   width, TEST.SCALES 100..1400, flip TTA, BBOX_VOTE) on three seeded
   synthetic images with random weights, twice each, and against the same
   detector on the CPU at a small pyramid;
3. K2 against its plain version (equal to the bit on small-integer inputs,
   within a stated tolerance on float inputs, equal to itself from run to
   run) and its tensor-core products against the same products in float64
   on its own routing (its scratch c1 and dpre2), at four shapes up to the
   1200 training scale; at that scale its wrapper's wall, its device time
   (20 calls in one CUDA graph) and each of its five launches' device
   time (torch.profiler), beside two bounds: all on the CUDA cores, and its own split between the
   CUDA cores and the tensor cores;
4. K3 against its plain version (equal to the bit) on the 90,000 anchors of
   a 1200×1600 image for 0 to 2048 gt boxes: uniform, a crowd, and a band
   of faces that overfills one block's list of gt; its wrapper's wall, and
   its device time with the host taken out (200 launches captured in a
   CUDA graph, replayed between two CUDA events), beside the same device
   time of an empty kernel on the same grid;
5. one training micro-batch with every parameter requiring a gradient
   (K2 runs), its stem gradients against the plain stem's;
6. training, the slice's path: ``train_net`` for 6 iterations of the
   flagship configuration over all three scales on four seeded synthetic
   images and their mirrors, then a resume from the iteration-3 snapshot
   that must reach the same final.npz to the bit;
7. one training iteration of a small skeletal network on the CPU and on
   the card from the same weights.

Each main path runs with the launch counts set to 0 just before it and read
just after. The second-to-last line is a JSON summary of the kernels; the
last is {"ok": true, "device": ...}. Any failure raises, exits nonzero and
prints no such line. Without a CUDA card it exits nonzero at once.
"""

import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
REPO = os.path.dirname(os.path.abspath(__file__))
# random-init heads score every anchor near 0.5; this bias on cls_score_k
# ([bg, fg] = [+CLS_BIAS, -CLS_BIAS]) puts the foreground probability near
# sigmoid(-2 * CLS_BIAS) ~ 0.04, so only the tail of anchors passes the 0.05
# detect threshold and the host vote gets hundreds to thousands of boxes
CLS_BIAS = 1.55
IMAGE_SIZES = ((768, 1024), (1024, 768), (683, 1024))
STEM_SHAPES = (((1, 32, 128, 3), None), ((2, 112, 144, 3), None),
               ((2, 64, 128, 3), (48, 96)), ((2, 1408, 1872, 3), None))
GRAD_SHAPES = (((1, 32, 128, 3), None), ((2, 112, 144, 3), None),
               ((2, 64, 128, 3), (48, 96)), ((1, 1200, 1600, 3), None))
RTOL = 1e-4                 # fp32 kernel vs fp32 cuDNN: fp32 rounding only
# K2 on float inputs, max |Δ| / peak |grad| against the plain version in
# float64: the kernel's conv1_2 rounds in fp32, so a window whose two
# largest activations (or an activation near 0) lie within that rounding
# sends its gradient elsewhere (a pool or ReLU flip). Flips grow with the
# pixel count N and the peak with √N: 1e-3 holds with room at the small
# shapes, and 2.4e-3 was measured at 1×1200×1600 with this script's
# inputs (H100 80GB HBM3, 700 W).
GRAD_TOL = {False: 1e-3, True: 5e-3}        # keyed by "full training size"
# K2's products (3xTF32 on the tensor cores) on its own routing, max |Δ| /
# peak against the same products in float64: no pool or ReLU flip enters,
# and one TF32 product (no hi/lo split) would miss it by ten times
# (tests/test_torch_port_tf32x3.py)
PRODUCT_TOL = 1e-5
TRAIN_ITERS, SNAPSHOT = 6, 3
THRESH = 0.05
# published H100 SXM rates (NVIDIA H100 datasheet): fp32 on the CUDA
# cores and device-memory bandwidth
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
PEAK_TF32 = 495e12          # dense TF32 on the tensor cores
# K3's cases over the anchors of a 1200×1600 image: (gt, masked, layout)
IOU_CASES = ((0, 0, "uniform"), (1, 0, "uniform"), (64, 0, "uniform"),
             (64, 64, "uniform"), (512, 100, "uniform"),
             (2048, 500, "uniform"), (2048, 0, "crowd"), (2048, 0, "band"))
IOU_TIMED = ((64, 0, "uniform"), (2048, 500, "uniform"), (2048, 0, "crowd"),
             (2048, 0, "band"))
# the band: faces packed at the top left, all in the first block's union
# box, so that its list of gt fills and is walked early (csrc/iou.cu)
BAND = (0, 0, 600, 40)
GRAPH_REPS = 200
# K2's launches (csrc/stem_grad.cu) in order, by the stage each runs
GRAD_KERNELS = {"dpre2": "dpre2_kernel", "split_w2f": "split_w2f_kernel",
                "dc1": "dc1_kernel", "wgrad": "wgrad_kernel",
                "reduce": "reduce_kernel"}
# an empty kernel, launched on K3's grid: the floor of a launch
EMPTY_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int shf_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
extern "C" const char* shf_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
"""


def say(phase, **fields):
    print(phase + ": " + json.dumps(fields), flush=True)


def make_image(rng, h, w):
    """A uint8 BGR image: blocky low-frequency colour field + noise."""
    low = rng.randint(0, 256, (h // 32 + 2, w // 32 + 2, 3)).astype(np.float32)
    field = np.kron(low, np.ones((32, 32, 1), np.float32))[:h, :w]
    return np.clip(field + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(
        np.uint8)


def stem_inputs(rng, shape, valid_hw, device):
    x = rng.randn(*shape).astype(np.float32) * 50
    if valid_hw is not None:             # garbage beyond the valid extent
        x[:, valid_hw[0]:] = 1e4
        x[:, :, valid_hw[1]:] = -1e4
    ws = [rng.randn(64, 3, 3, 3) * math.sqrt(2 / 27), rng.randn(64) * 0.5,
          rng.randn(64, 64, 3, 3) * math.sqrt(2 / 576), rng.randn(64) * 0.5]
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
            for a in [x] + ws]


def grad_inputs(rng, shape, valid_hw, integer):
    """x, dy and OIHW weights for K2 (the small-integer recipe of
    tests/test_pallas_stem.py:192-213, or floats), as float64 numpy."""
    B, H, W, _ = shape
    if integer:
        arrs = [rng.randint(-3, 4, shape), rng.randint(-3, 4, (B, H // 2,
                                                               W // 2, 64)),
                rng.randint(-3, 4, (64, 3, 3, 3)), rng.randint(-3, 4, 64),
                rng.randint(-2, 3, (64, 64, 3, 3)), rng.randint(-3, 4, 64)]
    else:
        arrs = [rng.randn(*shape) * 50, rng.randn(B, H // 2, W // 2, 64),
                rng.randn(64, 3, 3, 3) * math.sqrt(2 / 27),
                rng.randn(64) * 0.5,
                rng.randn(64, 64, 3, 3) * math.sqrt(2 / 576),
                rng.randn(64) * 0.5]
    arrs = [np.asarray(a, np.float64) for a in arrs]
    if valid_hw is not None:
        arrs[0][:, valid_hw[0]:] = 7.0
        arrs[0][:, :, valid_hw[1]:] = -3.0
    return arrs


def median_ms(fn, n=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_ms(fn, reps=GRAPH_REPS, n=5):
    """Device time of one call of fn, without the host: `reps` calls
    captured in one CUDA graph, replayed between two CUDA events; the median
    of n replays over reps."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):               # warm up off the capture
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
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return float(np.median(times))


def bound_ms(n_bytes, n_ops):
    """The least time for the work: the larger of bytes over the memory
    rate and fp32 operations over the CUDA-core rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def kernel_ms(fn, kernels, n=10, warmup=3):
    """Device time per call of fn of each of the repo's kernels named in
    ``kernels`` ({label: __global__ name}): n calls under torch.profiler
    (CUPTI), each kernel's summed durations over n. Raises where the
    profiler saw one of them run for no time."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = dict.fromkeys(kernels, 0.0)
    for ev in prof.key_averages():
        for label, name in kernels.items():
            # the repo's kernels sit in an anonymous namespace
            if f"::{name}(" in ev.key:
                us[label] += ev.self_device_time_total
    if not all(us.values()):
        raise AssertionError(f"the profiler saw no device time: {us}")
    return {label: t / n / 1e3 for label, t in us.items()}


def stem_grad_time(stem, args, grad_err, prod_err, reps=20):
    """K2 at the training scale: its wrapper's wall, its device time, each
    launch's device time and its bounds. Returns its entry of the kernels
    line."""
    B, H, W, _ = args[0].shape
    ms = median_ms(lambda: stem.fused_stem_grad(*args))
    device_ms = graph_ms(lambda: stem.fused_stem_grad(*args), reps=reps)
    stage_ms = kernel_ms(lambda: stem.fused_stem_grad(*args), GRAD_KERNELS)
    plain_ms = median_ms(lambda: stem.fused_stem_grad_reference(*args))
    p = B * H * W
    n_bytes = 4 * (3 * p + 64 * p // 4)
    # all on the CUDA cores: recompute (conv1_2, conv1_1), the data
    # gradient, dw2, dw1 (the first design's bound)
    cores_ms, cores_by = bound_ms(n_bytes, 2 * (3 * 576 + 2 * 27) * 64 * p)
    # this design: the recompute and the dw1 job on the CUDA cores, then the
    # data gradient and dw2 as three TF32 products each on the tensor cores
    t_ops = (2 * (576 + 2 * 27) * 64 * p / PEAK_FP32
             + 3 * 2 * (2 * 576) * 64 * p / PEAK_TF32) * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    bnd, by = max(t_ops, t_bytes), "bytes" if t_bytes > t_ops else "operations"
    say("stem_grad_time", shape=[B, H, W, 3], kernel_ms=ms,
        device_ms=device_ms, stage_device_ms=stage_ms,
        stage_sum_ms=sum(stage_ms.values()), plain_ms=plain_ms,
        bound_ms=bnd, bound_by=by, bound_cuda_cores_ms=cores_ms,
        bound_cuda_cores_by=cores_by,
        timing=f"wall: median of 20 CUDA-event walls; device: {reps} calls "
               "in one CUDA graph, median of 5 replays, per call; a stage: "
               "its kernel's durations in 10 calls under torch.profiler, "
               "per call")
    return {"name": "fused_stem_grad", "route": "cuda",
            "source": "smallhardface_tpu_torch/csrc/stem_grad.cu",
            "replaces": "smallhardface_tpu/ops/pallas_stem.py:460",
            "max_abs_err": grad_err, "own_routing_err_over_peak": prod_err,
            "ms": ms, "device_ms": device_ms, "stage_device_ms": stage_ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": None}


def dense_anchors(h, w):
    """The (h, w, 3) stride-8 anchors of the detector, flattened."""
    from smallhardface_tpu_torch.models import detector as tdm
    from smallhardface_tpu_torch.ops import anchors
    base = anchors.generate_anchors(base_size=16, ratios=[1],
                                    scales=list(tdm.ANCHOR_SCALES),
                                    shifts=[0], strides=[8] * 3)
    return anchors.dense_anchors(h, w, 8, base).astype(np.float32)


def uniform_gt(rng, g):
    """g gt boxes of 8-300 px anywhere on a 1200×1600 image."""
    x1 = rng.uniform(-20, 1600, g)
    y1 = rng.uniform(-20, 1200, g)
    s = rng.uniform(8, 300, g)
    return np.stack([x1, y1, x1 + s, y1 + s * rng.uniform(0.7, 1.3, g)],
                    1).reshape(g, 4).astype(np.float32)


def iou_case_inputs(rng, case):
    """gt (G, 4) float32 and mask (G,) bool of one of IOU_CASES, drawn from
    rng in the order of IOU_CASES."""
    from smallhardface_tpu_torch.ops.iou_cases import band_gt, crowd_gt
    g, n_masked, layout = case
    gt = {"uniform": lambda: uniform_gt(rng, g),
          "crowd": lambda: crowd_gt(rng, g, 1200, 1600),
          "band": lambda: band_gt(rng, g, BAND)}[layout]()
    mask = np.ones(g, bool)
    mask[g - n_masked:] = False
    return gt, mask


def group_kept(anchors, gt, mask, size):
    """K3's culling (csrc/iou.cu) as tensor code: for each group of `size`
    consecutive anchors (a warp, 32, or a block, 256), the number of
    unmasked gt its union box keeps, and the number of its anchors."""
    n = anchors.shape[0]
    pad = anchors[-1:].expand((-n) % size, 4)   # leaves the union as it is
    a = torch.cat([anchors, pad]).view(-1, size, 4)
    u = torch.cat([a[..., :2].amin(1), a[..., 2:].amax(1)], 1)[:, None]
    iw = (torch.minimum(u[..., 2], gt[None, :, 2])
          - torch.maximum(u[..., 0], gt[None, :, 0]) + 1)
    ih = (torch.minimum(u[..., 3], gt[None, :, 3])
          - torch.maximum(u[..., 1], gt[None, :, 1]) + 1)
    kept = ((iw > 0) & (ih > 0) & mask[None]).sum(1)
    lanes = torch.full_like(kept, size)
    lanes[-1] = n - size * (len(kept) - 1)
    return kept, lanes


def face_roidb(rng, sizes, n_faces=(1, 30)):
    """Synthetic training images (uint8 BGR arrays) with painted square
    'faces' and their boxes, plus each one's mirrored entry."""
    roidb = []
    for h, w in sizes:
        im = make_image(rng, h, w)
        boxes = []
        for _ in range(rng.randint(n_faces[0], n_faces[1] + 1)):
            s = int(rng.randint(12, max(13, min(h, w) // 4)))
            x1, y1 = rng.randint(0, w - s), rng.randint(0, h - s)
            colour = rng.randint(60, 250, 3)
            im[y1:y1 + s, x1:x1 + s] = colour
            im[y1 + s // 4:y1 + s // 3, x1 + s // 5:x1 + 4 * s // 5] = 20
            boxes.append([x1, y1, x1 + s - 1, y1 + s - 1])
        boxes = np.array(boxes, np.float64)
        flipped = boxes.copy()
        flipped[:, [0, 2]] = w - 1 - boxes[:, [2, 0]]
        for b, f in ((boxes, False), (flipped, True)):
            roidb.append({"image": im, "flipped": f, "boxes": b,
                          "gt_classes": np.ones(len(b), np.int32),
                          "width": w, "height": h})
    return roidb


def set_counts_zero(*fns):
    for fn in fns:
        fn.launches = 0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    from smallhardface_tpu_torch.config import CONFIG_DIR, cfg, cfg_from_file
    from smallhardface_tpu_torch.detect import TorchDetector, _pyramid_scales
    from smallhardface_tpu_torch.models import detector as tdm
    from smallhardface_tpu_torch.ops import cuda_build, iou, stem
    from smallhardface_tpu_torch.ops.bbox import iou_matrix

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    tdm.pin_fp32_numerics()
    say("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    t0 = time.perf_counter()
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    empty_src = os.path.join(cuda_build.BUILD_DIR, "empty_launch.cu")
    with open(empty_src, "w") as f:
        f.write(EMPTY_CU)
    empty = cuda_build.CudaLibrary("empty", empty_src,
                                   {"shf_empty": [cuda_build.CI] * 2
                                    + [cuda_build.VP]})
    libs = [stem.STEM, stem.STEM_GRAD, iou.IOU, empty]
    cuda_build.build_all(libs)
    say("build", seconds=round(time.perf_counter() - t0, 3),
        capability=list(torch.cuda.get_device_capability(0)),
        libraries={lib.name: os.path.relpath(lib.path(), REPO)
                   for lib in libs},
        nvcc_flags={lib.name: " ".join(lib.flags) for lib in libs},
        ptxas={lib.name: [ln.strip() for ln in lib.log.splitlines()
                          if "registers" in ln or "spill" in ln]
               for lib in libs})
    kernels = {}

    # ---- K1 against its plain version ----
    rng = np.random.RandomState(SEED)
    max_err = 0.0
    for shape, valid_hw in STEM_SHAPES:
        x, w1, b1, w2, b2 = stem_inputs(rng, shape, valid_hw, dev)
        got = stem.fused_stem(x, w1, b1, w2, b2, valid_hw=valid_hw)
        want = stem.fused_stem_reference(x, w1, b1, w2, b2, valid_hw)
        torch.cuda.synchronize()
        if valid_hw is not None:
            got = got[:, :valid_hw[0] // 2, :valid_hw[1] // 2]
            want = want[:, :valid_hw[0] // 2, :valid_hw[1] // 2]
        err = (got - want).abs()
        scale = want.abs().max().item()
        bad = (err > RTOL * want.abs() + RTOL * scale).sum().item()
        max_err = max(max_err, err.max().item())
        say("stem_vs_plain", shape=list(shape), valid_hw=valid_hw,
            max_abs_err=err.max().item(), max_abs_ref=scale, n_outside_tol=bad,
            rtol=RTOL, atol=f"{RTOL}*max|ref|")
        if bad or not torch.isfinite(got).all():
            raise AssertionError(f"stem kernel disagrees at {shape}")
        if shape == STEM_SHAPES[-1][0]:
            B, H, W, _ = shape
            ms = median_ms(lambda: stem.fused_stem(x, w1, b1, w2, b2))
            plain_ms = median_ms(
                lambda: stem.fused_stem_reference(x, w1, b1, w2, b2))
            p = B * H * W
            bnd, by = bound_ms(4 * (3 * p + 64 * p // 4),
                               2 * (27 + 576) * 64 * p)
            say("stem_time", shape=list(shape), kernel_ms=ms,
                plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                timing="median of 20 CUDA-event walls")
            kernels["fused_stem"] = {
                "name": "fused_stem", "route": "cuda",
                "source": "smallhardface_tpu_torch/csrc/stem.cu",
                "replaces": "smallhardface_tpu/ops/pallas_stem.py:69",
                "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd, "bound_by": by, "library_ms": None}
        del x, got, want, err
    torch.cuda.empty_cache()

    # ---- detection, the first slice's path ----
    cfg_from_file(os.path.join(CONFIG_DIR, "smallhardface.toml"))
    cfg.TEST.SCALES = [100, 300, 600, 1000, 1400]
    cfg.TEST.FLIP = True
    cfg.TEST.NMS_METHOD = "BBOX_VOTE"
    spec = tdm.build_spec(cfg)
    params = tdm.init_params(torch.Generator().manual_seed(SEED), spec)
    for k in tdm.ANCHOR_SCALES:
        params[f"cls_score_{k}"]["b"] = torch.tensor([CLS_BIAS, -CLS_BIAS])
    det = TorchDetector(params, spec, dev)
    rng = np.random.RandomState(SEED)
    images = [make_image(rng, h, w) for h, w in IMAGE_SIZES]

    # the small-input reference: the same detector on the CPU (plain stem,
    # CPU convolutions) over a two-level pyramid of the first image
    cfg.TEST.SCALES = [100, 300]
    small_gpu = det.detect(images[0], THRESH)[0][0]
    small_cpu = TorchDetector(params, spec, "cpu").detect(
        images[0], THRESH)[0][0]
    fwd, bwd = _match_fraction(small_gpu, small_cpu), _match_fraction(
        small_cpu, small_gpu)
    say("reference", scales=[100, 300], dets_gpu=len(small_gpu),
        dets_cpu=len(small_cpu), match_gpu_in_cpu=fwd, match_cpu_in_gpu=bwd)
    if min(fwd, bwd) < 0.97 or abs(len(small_gpu) - len(small_cpu)) > max(
            2, 0.02 * len(small_cpu)):
        raise AssertionError("GPU detections disagree with the CPU path")
    cfg.TEST.SCALES = [100, 300, 600, 1000, 1400]

    set_counts_zero(stem.fused_stem, stem.fused_stem_grad, iou.max_iou)
    torch.cuda.reset_peak_memory_stats()
    n_forward = 0
    for i, im in enumerate(images):
        runs, walls = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            dets = det.detect(im, THRESH)[0][0]
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            runs.append(dets)
            n_forward += len(cfg.TEST.SCALES)
        h, w = im.shape[:2]
        slack = 0.5 * max(1.0 / s for s in _pyramid_scales(im.shape))
        dets = runs[0]
        ok = (dets.ndim == 2 and dets.shape[1] == 5
              and np.isfinite(dets).all()
              and (dets[:, 4] > 0).all() and (dets[:, 4] <= 1).all()
              and (dets[:, :4] >= 0).all()
              and (dets[:, 0] <= dets[:, 2]).all()
              and (dets[:, 1] <= dets[:, 3]).all()
              and (dets[:, 2] <= w + slack).all()
              and (dets[:, 3] <= h + slack).all()
              and (dets[:, 4] > THRESH).sum() >= 1)
        same = np.array_equal(runs[0], runs[1])
        say("detect", image=i, hw=[h, w], dets=int(dets.shape[0]),
            walls_s=walls, deterministic=same, checks_ok=bool(ok))
        if not (ok and same):
            raise AssertionError(f"detections of image {i} fail the checks")
    detect_counts = {"fused_stem": stem.fused_stem.launches,
                     "fused_stem_grad": stem.fused_stem_grad.launches,
                     "max_iou": iou.max_iou.launches}
    say("detect_path", forward_passes=n_forward, launches=detect_counts,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    if detect_counts["fused_stem"] != n_forward:
        raise AssertionError("the stem kernel did not run once per forward")
    del det
    torch.cuda.empty_cache()

    # ---- K2 against its plain version ----
    rng = np.random.RandomState(SEED + 1)
    grad_err = prod_err = 0.0
    for shape, valid_hw in GRAD_SHAPES:
        full = shape[1] >= 1200
        for integer in (True, False):
            arrs = grad_inputs(rng, shape, valid_hw, integer)
            args = [torch.from_numpy(a).to(dev, torch.float32) for a in arrs]
            arrs_t = [torch.from_numpy(a).to(dev) for a in arrs]
            got = stem.fused_stem_grad(*args, valid_hw=valid_hw)
            again = stem.fused_stem_grad(*args, valid_hw=valid_hw)
            want = stem.fused_stem_grad_reference(*arrs_t, valid_hw=valid_hw)
            # the products alone, on the kernel's own routing (a comparison
            # launch: the wrapper's count does not move)
            own, scratch = stem._stem_grad_launch(*args, valid_hw=valid_hw)
            prods = stem.fused_stem_grad_products(
                arrs_t[0], scratch["c1"].double(), scratch["dpre2"].double(),
                arrs_t[4], valid_hw)
            torch.cuda.synchronize()
            repeat = all(torch.equal(a, b) for a, b in zip(got, again))
            repeat = repeat and all(torch.equal(a, b) for a, b in
                                    zip(got, own))
            errs = [(a.double() - b).abs().max().item() for a, b in
                    zip(got, want)]
            peaks = [b.abs().max().item() for b in want]
            ratio = max(e / p for e, p in zip(errs, peaks))
            tol = 0.0 if integer else GRAD_TOL[full]
            own_ratio = {
                name: ((a.double() - b).abs().max()
                       / b.abs().max().clamp_min(1e-30)).item()
                for name, a, b in zip(("dpre1", "dw1", "db1", "dw2", "db2"),
                                      (scratch["dpre1"],) + own, prods)}
            say("stem_grad_vs_plain", shape=list(shape), valid_hw=valid_hw,
                inputs="small integers" if integer else "floats",
                max_abs_err={"dw1": errs[0], "db1": errs[1], "dw2": errs[2],
                             "db2": errs[3]},
                peak=peaks, max_err_over_peak=ratio, tol_over_peak=tol,
                reference="plain version in float64",
                bit_identical_repeat=repeat,
                own_routing_err_over_peak=own_ratio,
                own_routing_tol_over_peak=PRODUCT_TOL,
                own_routing_reference="fused_stem_grad_products in float64 "
                                      "on the kernel's c1 and dpre2")
            if not repeat or ratio > tol:
                raise AssertionError(f"K2 disagrees at {shape}")
            if not all(r <= PRODUCT_TOL for r in own_ratio.values()):
                raise AssertionError(f"K2's products disagree at {shape}")
            if not integer:
                grad_err = max(grad_err, max(errs))
                prod_err = max(prod_err, max(own_ratio.values()))
            del scratch, prods, own
        if full:
            kernels["fused_stem_grad"] = stem_grad_time(
                stem, [a.contiguous() for a in args], grad_err, prod_err)
        del args, arrs_t, got, again, want
    torch.cuda.empty_cache()

    # ---- K3 against its plain version ----
    rng = np.random.RandomState(SEED + 2)
    anchors = torch.from_numpy(dense_anchors(150, 200)).to(dev)
    n = anchors.shape[0]
    blocks = -(-n // 256)                       # K3's grid: 256 per block

    def launch_empty():
        empty.check(empty.load().shf_empty(
            blocks, 256, torch.cuda.current_stream().cuda_stream), "empty")
    floor_ms = graph_ms(launch_empty)
    say("launch_floor", kernel="empty", grid=[blocks, 256], device_ms=floor_ms,
        timing=f"{GRAPH_REPS} launches in one CUDA graph, median of 5 "
               "replays, per launch")
    for g, n_masked, layout in IOU_CASES:
        gt, mask = iou_case_inputs(rng, (g, n_masked, layout))
        gt_t = torch.from_numpy(gt).to(dev)
        mask_t = torch.from_numpy(mask).to(dev)
        got = iou.max_iou(anchors, gt_t, mask_t)
        want = iou.max_iou_reference(anchors, gt_t, mask_t)
        torch.cuda.synchronize()
        equal = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        fields = {}
        if (g, n_masked, layout) in IOU_TIMED:
            call = lambda: iou.max_iou(anchors, gt_t, mask_t)  # noqa: E731
            fields["kernel_ms"] = median_ms(call)
            fields["device_ms"] = graph_ms(call)
            fields["plain_ms"] = median_ms(
                lambda: iou.max_iou_reference(anchors, gt_t, mask_t))
            # the whole (N, G) IoU matrix in one pass, then its row max
            fields["iou_matrix_max_ms"] = median_ms(
                lambda: torch.where(mask_t[None], iou_matrix(anchors, gt_t),
                                    -1.0).max(1))
            # the bound of the dense work: 15 fp32 operations per pair
            fields["bound_ms"], fields["bound_by"] = bound_ms(
                24 * n + 17 * g, 15 * n * g)
            # the work this data needs, as the kernel culls: each block
            # tests every unmasked gt, each warp its block's list (10 fp32
            # operations per test), and the pairs its own list keeps (15 each)
            kept, lanes = group_kept(anchors, gt_t, mask_t, 32)
            block_kept, _ = group_kept(anchors, gt_t, mask_t, 256)
            pairs = int((kept * lanes).sum())
            warp_tests = int(
                block_kept.repeat_interleave(8)[:len(kept)].sum())
            fields["data_bound_ms"], fields["data_bound_by"] = bound_ms(
                24 * n + 17 * g,
                15 * pairs
                + 10 * (warp_tests + len(block_kept) * int(mask.sum())))
            fields.update(kept_per_warp_mean=float(kept.float().mean()),
                          kept_per_warp_max=int(kept.max()),
                          kept_per_block_max=int(block_kept.max()),
                          pairs_evaluated=pairs, pairs_dense=n * g)
        say("iou_vs_plain", anchors=n, gt=g, masked=n_masked, layout=layout,
            bit_equal=equal, fg_anchors=int((got[0] >= 0.5).sum()), **fields)
        if not equal:
            raise AssertionError(f"K3 disagrees at G={g} ({layout})")
        if (g, n_masked, layout) == IOU_TIMED[0]:
            kernels["max_iou"] = {
                "name": "max_iou", "route": "cuda",
                "source": "smallhardface_tpu_torch/csrc/iou.cu",
                "replaces": "smallhardface_tpu/ops/pallas_iou.py:34",
                "max_abs_err": 0.0, "ms": fields["kernel_ms"],
                "device_ms": fields["device_ms"],
                "plain_ms": fields["plain_ms"],
                "bound_ms": fields["bound_ms"],
                "bound_by": fields["bound_by"], "library_ms": None}

    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=_output_dir())
    try:
        full_grad_counts = full_tree_grad(cfg, tdm, stem, iou, dev, work)
        train_counts = train_path(cfg, tdm, stem, iou, dev, work)
        cpu_vs_card(cfg, tdm, dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels["fused_stem"]["launches"] = train_counts["fused_stem"]
    kernels["max_iou"]["launches"] = train_counts["max_iou"]
    kernels["fused_stem_grad"]["launches"] = full_grad_counts[
        "fused_stem_grad"]
    for k, path in (("fused_stem", "train"), ("max_iou", "train"),
                    ("fused_stem_grad", "train_full_grad")):
        kernels[k]["launches_path"] = path
    kernels["fused_stem"]["launches_detect"] = detect_counts["fused_stem"]
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib",
                                            "smallhardface_tpu"))
    if foreign:
        raise AssertionError(f"the port imported {foreign}")

    print(json.dumps({"kernels": [kernels[k] for k in (
        "fused_stem", "fused_stem_grad", "max_iou")]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _output_dir():
    out = os.path.join(REPO, "output")
    os.makedirs(out, exist_ok=True)
    return out


def _flagship(cfg):
    from smallhardface_tpu_torch.config import CONFIG_DIR, cfg_from_file
    cfg_from_file(os.path.join(CONFIG_DIR, "smallhardface.toml"))
    cfg.TRAIN.SNAPSHOT = SNAPSHOT
    cfg.TRAIN.RESUME = ""


def full_tree_grad(cfg, tdm, stem, iou, dev, work):
    """One micro-batch at the 800 scale with every parameter requiring a
    gradient, the tree jax.value_and_grad returns (train_loop.py:193): the
    stem's gradient runs K2. Its conv1 gradients against the plain stem's
    on the same card. Returns the launch counts of the kernel run."""
    from smallhardface_tpu_torch.train import targets, train_loop
    from smallhardface_tpu_torch.train.loader import RoIDataLoader
    _flagship(cfg)
    spec = tdm.build_spec(cfg)
    rng = np.random.RandomState(SEED + 3)
    roidb = face_roidb(rng, [(768, 1024)])
    sample = RoIDataLoader(roidb).get_minibatch(1)          # 800
    arrays, _, bucket = train_loop.assemble_batch(
        [sample], 1, list(cfg.TPU.MAX_GT_BUCKETS))
    for k in ("data", "gt", "gt_mask"):
        arrays[k] = torch.from_numpy(arrays[k]).to(dev)
    params = tdm.init_params(torch.Generator().manual_seed(SEED), spec)
    loss_fn = train_loop.LossFn(targets.from_cfg(cfg), dev)
    grads, losses, counts = {}, {}, None
    for which in ("kernel", "plain"):
        model = tdm.Detector(params, spec, dev, trainable=True)
        for p in model.parameters():
            p.requires_grad_(True)
        saved = tdm.fused_stem
        if which == "plain":
            tdm.fused_stem = stem.fused_stem_reference
        set_counts_zero(stem.fused_stem, stem.fused_stem_grad, iou.max_iou)
        try:
            m = train_loop.grad_step(model, loss_fn, arrays, bucket[2:4], 1)
            torch.cuda.synchronize()
        finally:
            tdm.fused_stem = saved
        if which == "kernel":
            counts = {"fused_stem": stem.fused_stem.launches,
                      "fused_stem_grad": stem.fused_stem_grad.launches,
                      "max_iou": iou.max_iou.launches}
        grads[which] = {
            f"{name}/{k}": model.params[name][k].grad.detach().clone()
            for name in ("conv1_1", "conv1_2") for k in ("w", "b")}
        losses[which] = float(m[0, 0] + m[1, 0])
        del model
    ratio = {k: ((grads["kernel"][k] - grads["plain"][k]).abs().max()
                 / grads["plain"][k].abs().max()).item() for k in grads["plain"]}
    say("full_tree_grad", scale=int(cfg.TRAIN.SCALES.SHORT_SIDE[1]),
        bucket=list(bucket), loss=losses, launches=counts,
        max_err_over_peak=ratio, tol_over_peak=GRAD_TOL[True],
        reference="the same step with the plain stem, fp32")
    if counts != {"fused_stem": 1, "fused_stem_grad": 1, "max_iou": 1}:
        raise AssertionError(f"full-tree step launches: {counts}")
    if not all(math.isfinite(r) and r <= GRAD_TOL[True]
               for r in ratio.values()):
        raise AssertionError("K2's conv1 gradients disagree in the step")
    torch.cuda.empty_cache()
    return counts


def train_path(cfg, tdm, stem, iou, dev, work):
    """The slice's path: train_net at the flagship configuration, then a
    resume from the iteration-3 snapshot. Returns the launch counts."""
    from smallhardface_tpu_torch.io import checkpoint
    from smallhardface_tpu_torch.train import train_loop
    _flagship(cfg)
    rng = np.random.RandomState(SEED + 4)
    roidb = face_roidb(rng, [(768, 1024), (1024, 768), (768, 1024),
                             (1024, 768)])
    spec = tdm.build_spec(cfg)
    lr_mults, _ = tdm.param_multipliers(spec)
    init = tdm.init_params(torch.Generator().manual_seed(int(cfg.RNG_SEED)),
                           spec)
    scales = list(cfg.TRAIN.SCALES.SHORT_SIDE)
    seq = np.random.RandomState(int(cfg.RNG_SEED)).randint(
        0, len(scales), size=TRAIN_ITERS)
    if set(seq.tolist()) != set(range(len(scales))):
        raise AssertionError("the scale sequence misses a scale")
    rows = []
    clock = {"t": None}

    def hook(it, m):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rows.append({"iter": it, "scale": scales[int(seq[it - 1])],
                     "bucket": list(m["bucket"]),
                     "cls_loss": m["cls_loss"].ravel().tolist(),
                     "reg_loss": m["reg_loss"].ravel().tolist(),
                     "n_fg": m["n_fg"].ravel().tolist(),
                     "wall_s": now - clock["t"],
                     "max_memory_allocated_bytes":
                         torch.cuda.max_memory_allocated()})
        say("train_iter", **rows[-1])
        torch.cuda.reset_peak_memory_stats()
        clock["t"] = time.perf_counter()

    first, second = os.path.join(work, "run"), os.path.join(work, "resume")
    os.makedirs(first)
    os.makedirs(second)
    set_counts_zero(stem.fused_stem, stem.fused_stem_grad, iou.max_iou)
    torch.cuda.reset_peak_memory_stats()
    clock["t"] = time.perf_counter()
    model = train_loop.train_net(roidb, first, None, TRAIN_ITERS, device=dev,
                                 progress_hook=hook)
    torch.cuda.synchronize()
    counts = {"fused_stem": stem.fused_stem.launches,
              "fused_stem_grad": stem.fused_stem_grad.launches,
              "max_iou": iou.max_iou.launches}
    micro = TRAIN_ITERS * int(cfg.TRAIN.ITERSIZE)
    losses = [v for r in rows for v in r["cls_loss"] + r["reg_loss"]]
    frozen_moved, trainable_still = [], []
    for name, leaf in model.tree().items():
        for k, v in leaf.items():
            same = torch.equal(v.detach().cpu().contiguous(),
                               init[name][k].contiguous())
            if lr_mults[name][k] == 0 and not same:
                frozen_moved.append(f"{name}/{k}")
            elif lr_mults[name][k] > 0 and same:
                trainable_still.append(f"{name}/{k}")
    say("train_path", iterations=TRAIN_ITERS, micro_batches=micro,
        scales_visited=sorted({r["scale"] for r in rows}), launches=counts,
        losses_finite=all(math.isfinite(v) for v in losses),
        frozen_changed=frozen_moved, trainable_unchanged=trainable_still)
    if not all(math.isfinite(v) for v in losses) or len(rows) != TRAIN_ITERS:
        raise AssertionError("training losses are not all finite")
    if frozen_moved or trainable_still:
        raise AssertionError("frozen or trainable leaves misbehaved")
    if (counts["fused_stem"] != micro or counts["max_iou"] != micro
            or counts["fused_stem_grad"] != 0):
        raise AssertionError(f"training launches: {counts}")
    del model
    torch.cuda.empty_cache()

    cfg.TRAIN.RESUME = os.path.join(
        first, f"{cfg.NAME}_iter_{SNAPSHOT}.npz")
    rows.clear()
    clock["t"] = time.perf_counter()
    train_loop.train_net(roidb, second, None, TRAIN_ITERS, device=dev,
                         progress_hook=hook)
    cfg.TRAIN.RESUME = ""
    a = np.load(os.path.join(first, "final.npz"))
    b = np.load(os.path.join(second, "final.npz"))
    same = sorted(a.files) == sorted(b.files) and all(
        np.array_equal(a[k], b[k]) for k in a.files)
    state = pickle.loads(checkpoint.load(os.path.join(first, "final.npz"))[
        3]["loader_state"].tobytes())
    say("train_resume", resumed_from=SNAPSHOT, to=TRAIN_ITERS,
        final_npz_bit_identical=same, arrays=len(a.files),
        loader_cursor=state[0]["cur"])
    if not same:
        raise AssertionError("the resumed run's final.npz differs")
    torch.cuda.empty_cache()
    return counts


def cpu_vs_card(cfg, tdm, dev, work):
    """One iteration of a skeletal network (the CPU tests' backbone) on
    64×80 images, on the CPU and on the card from the same weights."""
    from smallhardface_tpu_torch.io import checkpoint
    from smallhardface_tpu_torch.io.weights import params_to_numpy
    from smallhardface_tpu_torch.train import train_loop
    _flagship(cfg)
    cfg.TRAIN.SCALES.SHORT_SIDE = [64]
    cfg.TRAIN.SCALES.MAX_SIZE = 128
    cfg.TRAIN.AUGMENT.ENABLE = False
    cfg.TRAIN.ITERSIZE = 1
    cfg.TPU.MAX_GT_BUCKETS = [8]
    saved = tdm.VGG_STAGES, train_loop.BUCKET
    tdm.VGG_STAGES = (("conv1", 8, 1), ("conv2", 8, 1), ("conv3", 16, 1),
                      ("conv4", 16, 1), ("conv5", 16, 1))
    train_loop.BUCKET = 32
    try:
        rng = np.random.RandomState(SEED + 5)
        roidb = face_roidb(rng, [(64, 80)] * 2, n_faces=(1, 2))
        init = os.path.join(work, "skeletal_init.npz")
        checkpoint.save(init, params_to_numpy(tdm.init_params(
            torch.Generator().manual_seed(SEED), tdm.build_spec(cfg))))
        out = {}
        for where in ("cpu", dev):
            d = os.path.join(work, f"small_{torch.device(where).type}")
            os.makedirs(d)
            losses = []
            model = train_loop.train_net(
                roidb, d, init, 1, device=where,
                progress_hook=lambda it, m: losses.append(
                    float(m["cls_loss"].sum() + m["reg_loss"].sum())))
            out[torch.device(where).type] = (losses[0],
                                             params_to_numpy(model.tree()))
    finally:
        tdm.VGG_STAGES, train_loop.BUCKET = saved
    (l_cpu, p_cpu), (l_gpu, p_gpu) = out["cpu"], out["cuda"]
    worst = 0.0
    for name, leaf in p_cpu.items():
        for k, v in leaf.items():
            tol = 1e-4 * np.abs(v) + 1e-6
            worst = max(worst, float((np.abs(p_gpu[name][k] - v) / tol).max()))
    say("train_cpu_vs_card", loss_cpu=l_cpu, loss_card=l_gpu,
        loss_rel_err=abs(l_gpu - l_cpu) / abs(l_cpu),
        params_worst_err_over_tol=worst, tol="rtol 1e-4, atol 1e-6")
    if abs(l_gpu - l_cpu) > 1e-4 * abs(l_cpu) or worst > 1.0:
        raise AssertionError("the card's training step disagrees with the "
                             "CPU's")


def _match_fraction(a, b):
    """Fraction of rows of `a` with an IoU > 0.9, |Δscore| < 0.01 partner in
    `b` (the rule of the repo's golden detection tests)."""
    if len(a) == 0:
        return 1.0 if len(b) == 0 else 0.0
    from smallhardface_tpu_torch.ops import bbox_np
    iou = bbox_np.bbox_overlaps(a[:, :4], b[:, :4])
    best = iou.argmax(axis=1)
    hit = (iou[np.arange(len(a)), best] > 0.9) & (
        np.abs(a[:, 4] - b[best, 4]) < 0.01)
    return float(hit.mean())


if __name__ == "__main__":
    sys.exit(main())
