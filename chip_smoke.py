#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel (the fused VGG stem, csrc/stem.cu) with nvcc,
holds it against its plain PyTorch version at the shapes the main path
gives it, then runs full-pyramid detection at the flagship configuration
(VGG-16 at full width, TEST.SCALES 100..1400, flip TTA, BBOX_VOTE) on three
seeded synthetic images with random weights, twice each, and checks the
detections. Each phase prints one line. The second-to-last line is a JSON
summary of the kernels; the last is {"ok": true, "device": ...}. Any
failure raises, exits nonzero and prints no such line. Without a CUDA card
it exits nonzero at once.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
# random-init heads score every anchor near 0.5; this bias on cls_score_k
# ([bg, fg] = [+CLS_BIAS, -CLS_BIAS]) puts the foreground probability near
# sigmoid(-2 * CLS_BIAS) ~ 0.04, so only the tail of anchors passes the 0.05
# detect threshold and the host vote gets hundreds to thousands of boxes
CLS_BIAS = 1.55
IMAGE_SIZES = ((768, 1024), (1024, 768), (683, 1024))
STEM_SHAPES = (((1, 32, 128, 3), None), ((2, 112, 144, 3), None),
               ((2, 64, 128, 3), (48, 96)), ((2, 1408, 1872, 3), None))
RTOL = 1e-4                 # fp32 kernel vs fp32 cuDNN: fp32 rounding only
THRESH = 0.05


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    # the shared, jax-free config of the repo and the port
    from smallhardface_tpu.config import cfg, cfg_from_file
    from smallhardface_tpu_torch.detect import TorchDetector, _pyramid_scales
    from smallhardface_tpu_torch.models import detector as tdm
    from smallhardface_tpu_torch.ops import stem

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
    stem.build()
    ptxas = [ln.strip() for ln in stem.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "smem" in ln]
    say("build", seconds=round(time.perf_counter() - t0, 3),
        library=os.path.relpath(stem.library_path()), ptxas=ptxas)

    rng = np.random.RandomState(SEED)
    max_err, ms, plain_ms = 0.0, None, None
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
            ms = median_ms(lambda: stem.fused_stem(x, w1, b1, w2, b2))
            plain_ms = median_ms(
                lambda: stem.fused_stem_reference(x, w1, b1, w2, b2))
            say("stem_time", shape=list(shape), kernel_ms=ms,
                plain_ms=plain_ms, timing="median of 20 CUDA-event walls")
        del x, got, want, err
    torch.cuda.empty_cache()

    cfg_from_file(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "smallhardface_tpu", "configs",
                               "smallhardface.toml"))
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

    stem.fused_stem.launches = 0
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
    launches = stem.fused_stem.launches
    say("main_path", forward_passes=n_forward, stem_launches=launches,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    if launches != n_forward:
        raise AssertionError("the stem kernel did not run once per forward")
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    print(json.dumps({"kernels": [{
        "name": "fused_stem", "route": "cuda",
        "source": "smallhardface_tpu_torch/csrc/stem.cu",
        "replaces": "smallhardface_tpu/ops/pallas_stem.py:69",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _match_fraction(a, b):
    """Fraction of rows of `a` with an IoU > 0.9, |Δscore| < 0.01 partner in
    `b` (the rule of the repo's golden detection tests)."""
    if len(a) == 0:
        return 1.0 if len(b) == 0 else 0.0
    from smallhardface_tpu.ops import bbox_np
    iou = bbox_np.bbox_overlaps(a[:, :4], b[:, :4])
    best = iou.argmax(axis=1)
    hit = (iou[np.arange(len(a)), best] > 0.9) & (
        np.abs(a[:, 4] - b[best, 4]) < 0.01)
    return float(hit.mean())


if __name__ == "__main__":
    sys.exit(main())
