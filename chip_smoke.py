#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's five CUDA kernels with nvcc, one process per source, all
at once: the fused VGG stem (K1, csrc/stem.cu), its backward (K2,
csrc/stem_grad.cu), the anchor max-IoU (K3, csrc/iou.cu), the final vote
(V1, csrc/vote.cu) and the int8 3×3 convolution (Q1, csrc/conv_int8.cu).
Then, each phase printing one line:

1. K1 against its plain version at the shapes of the detection path: on
   small-integer inputs its output equal to the bit to the plain forward
   in float64 and its pool routing to ``fused_stem_route_reference``'s; on
   floats within RTOL; at the largest level its wrapper's wall, its device
   time (CUDA graph), the plain time and two bounds: all on the CUDA
   cores, and its own split (conv1_1 on the CUDA cores, conv1_2 as three
   TF32 products on the tensor cores);
2. full-pyramid detection at the flagship configuration (VGG-16 at full
   width, TEST.SCALES 100..1400, flip TTA, BBOX_VOTE on the device with
   VOTE_CAP 2048, the default) on three seeded synthetic images with
   random weights, twice each, and against the same detector on the CPU at
   a small pyramid; one image again with the float64 host vote
   (DEVICE_VOTE = false); no launch of K1 there writes a routing; K1's
   device time summed over the five launches of one warm ``detect``
   (torch.profiler);
3. V1 against its plain version: equal to the bit on integer boxes with
   dyadic scores; on the real top-2048 candidate sets of the three images,
   on a crowd, on boxes scattered over many centres, on 2048 boxes that
   overlap nothing (2048 steps) and on 2048 that form one cluster, the
   same rows out, the scores equal to the bit and the boxes within
   VOTE_BOX_TOL; its device time (CUDA graph, its three launches),
   wrapper wall, plain time, clusters and bound;
4. the full five-level pyramid with flip of one image on the card against
   the port's CPU path, by the golden tests' match rule; the device memory
   peak of a warm ``detect`` of that image (under DETECT_PEAK_LIMIT); V1
   over the three images' candidate sets as one launch against three
   single launches (equal to the bit, device times side by side); K1 on
   an 8-image batch with eight valid extents in one launch against its
   plain version and eight single-image launches;
4b. spatial H-sharding of detection (``spatial_phase``), its units
   ``cuda:0`` repeated k = 2 and 4 times: K4 (``fused_stem_spatial``, K1
   once per shard) equal to the bit to one K1 over the whole image at
   the 1408×1872 level (also with a valid height inside a shard), its
   wall, device time and plain time beside one K1's; the cuDNN-routed
   3×3 convolutions at the shard shapes of image 0's levels against the
   cliff limits; ``detect`` of image 0 over each unit against the
   one-device rows (rtol 1e-4, atol 1e-3, each row matched), with its
   wall, device time, idle share, peak, K1's launches (5·k) and halo
   bytes; calibrated int8 and bf16 at k = 2 by ``detect_many``'s rules;
   the command line's and the service's refusal of k = 2 on one card;
5. the slice's path: ``detect_many`` on eight WIDER-sized images in three
   bucket groups at max_batch 1, 2 and 4 against per-image ``detect``
   (counts within max(2, 2 %), each side matched at DM_MATCH_MIN), with
   images per second and peak memory beside sequential ``detect`` and
   test_net's three-in-flight pipeline, and K1's and V1's launches in one
   max_batch 4 run; then the HTTP service (``serve.DetectorService``
   behind ``serve.serve`` on 127.0.0.1:0): healthz, four concurrent
   requests micro-batched against the per-request service, a bad body,
   and the request latencies;
5b. int8 serving (TPU.PRECISION = "int8", smallhardface-int8.toml): Q1
   equal to the bit to its plain version at every int8 layer shape of the
   1408×1872 level (batch 2), for the epilogue the calibrated chain runs
   there and the dynamic one, on uniform int8 values and on the extremes
   (±127, -128), at the edges of its tiling (Q1_EDGES: ragged H and W, W
   under a tile, H = 1, dilation 4 beyond the image, three images with a
   scale row each, every K chunk, outputs that are all ties) and at one
   layer of each smaller level; at each 1408 shape its wrapper's wall,
   its device time (CUDA graph), its bound, the plain time and two
   yardsticks the port never calls (the fp32 layer as ``layers.conv3x3``
   runs it, ``torch._int_mm`` on the same M×K×N); a ``TorchDetector``
   calibrated on the three images; a warm calibrated ``detect`` of image 0
   (wall, peak, Q1's, K1's and V1's launches, where its device time goes,
   Q1's bound summed over the shapes of its 80 calls) against the port's
   int8 CPU path
   on the card's own stem outputs (the golden rule at INT8_MATCH_MIN), the
   int8-vs-fp32 logits correlation on the card (> INT8_CORR_MIN), a
   dynamic ``detect``; ``detect_many`` at max_batch 4 (against per-image
   int8 ``detect`` at INT8_MANY_MATCH_MIN, the int8-vs-fp32 agreement
   beside it) and the service with calib_images, each with Q1's launches
   above 0 and no call of Q1's plain version;
5c. bf16 detection (TPU.PRECISION = "bfloat16", the flagship config):
   the 1×1 convolutions and the deconv of the 1408×1872 level against the
   fp32 sum of the same bf16 products rounded once (at most
   BF16_CONV_MAX_DIFFER of the outputs differ, each within two fp32 sums'
   difference plus a bf16 ulp; the bf16 cliff map holds every 3×3 shape
   to the same); warm ``detect`` of the three images
   (walls, the median of BF16_WALL_REPS for image 0, peak, K1's and V1's
   launches, the device split into K1, cuDNN's convolutions, V1 and the
   rest, the idle share), image 0 against the port's bf16 CPU path (the
   loose rule at BF16_CPU_MATCH_MIN; fed the card's K1 outputs beside
   it), bf16 against the fp32 detections (printed), ``detect_many`` at
   max_batch 4 against per-image bf16 ``detect`` (the loose rule at
   BF16_MATCH_MIN) and one service request (the rows of ``detect``);
6. the cliff map: every 3×3 convolution of the forward, as the forward
   runs it, at the pyramid levels of five WIDER-sized images, exact and
   bucketed, at batch 2, 4 and 8 (``tools/conv_map.py``): each distinct
   shape's device time against its fp32 bound and the memory it adds;
   then the same map in bf16 against the bf16 bound, held to the memory
   limit and to the bf16 rounding of the fp32 sum at every shape;
7. K2 against its plain version (equal to the bit on small-integer inputs,
   within a stated tolerance on float inputs, equal to itself from run to
   run; K1 writes the routing it reads) and its tensor-core products
   against the same products in float64 on its own routing (its scratch c1
   and dpre2), at four shapes up to the 1200 training scale; at that scale,
   on a routing K1 wrote beforehand, its wrapper's wall, its device time
   (20 calls in one CUDA graph) and each of its five launches' device
   time (torch.profiler), beside two bounds: all on the CUDA cores, and its
   own split between the CUDA cores and the tensor cores;
8. K3 against its plain version (equal to the bit) on the 90,000 anchors of
   a 1200×1600 image for 0 to 2048 gt boxes: uniform, a crowd, and a band
   of faces that overfills one block's list of gt; its wrapper's wall, and
   its device time with the host taken out (200 launches captured in a
   CUDA graph, replayed between two CUDA events), beside the same device
   time of an empty kernel on the same grid;
9. one training micro-batch with every parameter requiring a gradient
   (K1 writes the routing, K2 runs on it), its stem gradients against the
   plain stem's;
10. training: ``train_net`` for 6 iterations of the flagship configuration
   over all three scales on four seeded synthetic images and their
   mirrors (conv1 frozen: K1 writes no routing, K2 never runs), its batches
   built by the prefetch thread beside the steps, with its split (the
   worker's draws and renders per image and its job per batch, the main
   thread's wait for the fetch, which must stay below the worker's time,
   and its time to queue a step, the snapshot writes, the device's busy
   time under torch.profiler, the idle share and the iteration wall);
   ``train_prefetch``: the same run in the serial order (the executors
   replaced by an inline stand-in) and with the thread again, each
   final.npz equal to the bit to the first; then a resume from the
   iteration-3 snapshot that must reach the same final.npz to the bit;
10b. spatial training (``spatial_train``), units ``cuda:0`` repeated k
   times: three flagship iterations over k = 2 beside the same run on one
   device (losses within the spatial forward's rtol, each leaf's update
   within UPDATE_TOL of its peak, frozen leaves to the bit; K1
   twice per micro-batch, K2 never; wall, device busy time, idle share,
   peak memory and halo bytes of both); the full-tree micro-batch over
   k = 2 and 4 (K1, its routing and K2 k times, K3 once; conv1 gradients
   against one device's within GRAD_TOL); K4's backward alone on the
   small-integer recipe at that micro-batch's shape, equal to the bit to
   one K2, with its wall, K2's device time per backward and the plain
   backward's time;
11. one training iteration of a small skeletal network on the CPU and on
   the card from the same weights;
12. train-then-test from the command line:
   ``smallhardface_tpu_torch.__main__.main`` with the flagship config,
   ``--train true --test true``, 2 iterations, on a seeded synthetic WIDER
   tree (scripts/synth_wider.py), evaluated on its 6 val images of
   1024×1024: final.npz, detections.pkl, result.tar.gz and the
   Easy/Medium/Hard line; then the same evaluation with TPU.EVAL_BATCH 2
   (three detect_many batches), whose detections.pkl must agree with the
   first image by image by the detect_many rule; then with the run's
   final.caffemodel as TEST.MODEL, which must load equal to final.npz and
   give its detections to the bit;
13. TRAIN.AUTO_RESUME and the signals, each run a ``python -m
   smallhardface_tpu_torch --device cuda`` process at the flagship config
   on the same tree (the kernels come from the build cache): device_query's
   output; a device-side assert from a plain torch op in a fresh process,
   with its class and message, and the add, matmul, convolution and K3
   launch after it failing too, each classified as a device fault by
   ``__main__._device_fault``; a fault injected at iteration 4
   (SHF_FAULT_ITER) with a snapshot at 2 and one relaunch: two run
   directories and a final.npz equal to the bit to an unfaulted run's,
   with the relaunch's walls from the exec to its first log line, its
   resume and its first iteration line; SIGINT once the first "iter" line
   is out: a stop at a snapshot, and a resume from it to iteration 6 equal
   to the bit to a straight 6-iteration run; a fault in the evaluation
   (SHF_FAULT_TEST) relaunched with training off, whose detections.pkl
   equals an unfaulted evaluation's to the bit. These processes' launches
   are their own: the kernels line keeps the counts of the phases above.
14. data parallelism through the user's command, ``python -m
   torch.distributed.run --standalone --nproc_per_node N -m
   smallhardface_tpu_torch --device cuda --train true --test true`` at
   the flagship config on the same tree, DP_ITERS iterations then the
   test (``dp_phases``): ``dp_nccl_world1``, N = 1 over NCCL beside the
   same command without the launcher (the backend the process group
   reports, final.npz equal to the bit, the detections row for row, the
   all-reduce's time); ``dp_two_ranks_one_card``, N = 2 on this card over
   gloo (``SHF_DIST_BACKEND=gloo``, ``SHF_TRAIN_PROFILE=1``) with a
   snapshot at every iteration: both ranks' weights digests equal, rank 0
   the only writer, two sampler states in the snapshot, the first step's
   update against an in-process oracle of both ranks' batches
   (``dp_oracle``, within DP_ORACLE_TOL of each leaf's update peak), the
   detections row for row against one process's ``test_net`` of the same
   final.npz, K1's and K3's launches per rank (each rank's "train
   summary" log line counts them from 0 in its own process), the
   all-reduce's bytes and time per iteration, each rank's iteration walls
   and the card's idle share;
15. the port's timing tools (``tools_phase``): ``tools/benchmark`` (the
   forward in fp32 and bf16 and forward+backward at 1×608×912),
   ``tools/layer_time`` at 1×1408×1920 (the per-layer table, whose
   scopes must hold SCOPE_COVERAGE_MIN of the forward's device time,
   ``--bisect``, ``--int8-chain`` with Q1's launches),
   ``tools/pyramid_time`` on image 0 (its rows equal to a plain
   ``detect``'s; per stage host ms, device ms, launches and host µs per
   launch, and the idle share), ``tools/train_time`` at 768×1024 (every
   step's loss equal, K3 launched), ``tools/perf_probe`` at 608×912 and
   ``tools/ap_parity --dry-run synth synth`` on 4 synthetic images
   (PARITY OK). Then the smoke's total.

Each main path runs with the launch counts set to 0 just before it and read
just after. The second-to-last line is a JSON summary of the kernels; the
last is {"ok": true, "device": ...}. Any failure raises, exits nonzero and
prints no such line. Without a CUDA card it exits nonzero at once.
"""

import copy
import glob
import json
import math
import re
import os
import pickle
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# the card's published peaks and the timing helpers, shared with the
# port's timing tools (smallhardface_tpu_torch/tools/measure.py)
from smallhardface_tpu_torch.tools.measure import (
    GRAPH_REPS, PEAK_BYTES, PEAK_INT8, bound_ms, graph_ms, kernel_ms,
    median_ms, split_bound_ms)

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
RTOL = 1e-4                 # 3xTF32 kernel vs fp32 cuDNN: fp32-grade rounding
# K2 on float inputs, max |Δ| / peak |grad| against the plain version in
# float64: the routing comes from K1's conv1_2 (3xTF32, fp32-grade
# rounding), so a window whose two largest activations (or an activation
# near 0) lie within that rounding sends its gradient elsewhere (a pool or
# ReLU flip). Flips grow with the pixel count N and the peak with √N: 1e-3
# holds with room at the small shapes, and 3.8e-3 was measured at
# 1×1200×1600 with this script's inputs (H100 80GB HBM3, 700 W).
GRAD_TOL = {False: 1e-3, True: 5e-3}        # keyed by "full training size"
# K2's products (3xTF32 on the tensor cores) on its own routing, max |Δ| /
# peak against the same products in float64: no pool or ReLU flip enters,
# and one TF32 product (no hi/lo split) would miss it by ten times
# (tests/test_torch_port_tf32x3.py)
PRODUCT_TOL = 1e-5
TRAIN_ITERS, SNAPSHOT = 6, 3
# V1's merged boxes on float inputs against its plain version, max |Δ| over
# the largest coordinate: the same members, summed in another order
VOTE_BOX_TOL = 1e-5
# the golden detection tests' rule: each side's rows matched at >= 97 %, the
# counts within max(2, 2 %)
MATCH_MIN, COUNT_SLACK = 0.97, 0.02
EVAL_IMAGES, EVAL_SIZE, EVAL_ITERS = 6, 1024, 2
THRESH = 0.05
# detect_many's images: width 1024, heights that make bucket groups of
# four, three and one under TPU.TEST_BUCKET 128 (detect._prep's key)
DM_HEIGHTS = (768, 760, 754, 748, 1024, 1022, 1020, 683)
DM_MAX_BATCH = (1, 2, 4)
# detect_many against per-image detect: the bucketed shapes may run other
# cuDNN algorithms and sum the resize in another order, so a box near the
# threshold may flip; each side matched at 99 %, counts within max(2, 2 %)
DM_MATCH_MIN = 0.99
DETECT_PEAK_LIMIT = 8e9     # bytes a warm detect of image 0 may peak at
# int8: the int8 detect against the port's int8 CPU path fed the card's own
# stem outputs (the stems differ in the last bits, and a one-ulp flip at
# conv2_1's input grows about threefold at every link of the chain:
# tests/test_torch_port_int8.py), each side matched at 99 %; the int8
# logits against fp32 on the card, JAX's calibrated bound
# (tests/test_int8.py:139-161)
INT8_MATCH_MIN, INT8_CORR_MIN = 0.99, 0.98
# int8 detect_many against per-image int8 detect: the bucketed levels sum
# their resize in another order, so the stems differ in the last bits and
# the chain grows that as above (each side matched at 0.907 to 1.0 on the
# eight images on an H100 80GB HBM3, 700 W); the int8-vs-fp32 agreement of
# the same images is printed beside it
INT8_MANY_MATCH_MIN = 0.85
INT8_LEVEL = (1408, 1872)   # the largest level of image 0's pyramid
INT8_SCALES = [100, 300, 600, 1000, 1400]
# Q1's tiling edges, beyond the layer shapes: (label, B, H, W, C, O,
# dilation, epilogue, ties), as tests/test_torch_port_conv_int8_tiles.py
# models them on the CPU
Q1_EDGES = (("ragged", 2, 19, 23, 64, 128, 1, "link", False),
            ("narrow", 2, 40, 5, 64, 128, 2, "link", False),
            ("h1", 1, 1, 37, 64, 128, 1, "link", False),
            ("h1_d4", 1, 1, 37, 32, 64, 4, "end", False),
            ("d4_beyond", 1, 3, 3, 128, 128, 4, "end", False),
            ("b3_rows", 3, 17, 30, 64, 128, 1, "dynamic", False),
            ("b3_rows_c256", 3, 5, 9, 256, 256, 2, "dynamic", False),
            ("k32", 1, 3, 10, 32, 64, 1, "link", False),
            ("k128_o512", 1, 3, 10, 512, 512, 1, "link", False),
            ("k128_o128", 1, 3, 10, 512, 128, 1, "dynamic", False),
            ("ties", 2, 19, 23, 256, 256, 1, "link", True),
            ("ties_c64", 2, 19, 23, 64, 128, 2, "link", True))
# one layer of each smaller level of image 0's pyramid (network inputs)
Q1_SMALLER_LEVELS = ((112, 144), (304, 400), (608, 800), (1008, 1344))
Q1_SMALLER = ("conv2_1", "conv3_2", "conv5_1", "head_d4")
# Q1's kernels (csrc/conv_int8.cu), K1's and V1's, for a detect's split:
# every __global__ of csrc/vote.cu (its three phases)
Q1_KERNEL = "conv3x3_int8_kernel"
V1_KERNELS = ("vote_mask_kernel", "vote_walk_kernel", "vote_emit_kernel")
# cuDNN's convolution kernels in a detect's split, by their names: forward
# implicit GEMMs (sm90_xmma_fprop_...), the grouped deconv (dgrad2d_...)
# and the older implicit-convolve kernels
CONV_KERNEL_MARKS = ("fprop", "dgrad", "convolve")
# bf16 (TPU.PRECISION = "bfloat16"): detect_many against per-image detect
# on the card, each side matched at 0.95 by the loose rule of
# tests/test_full_detect_golden.py's bf16 drift test (IoU > 0.6, |Δscore|
# < 0.1), the counts within max(3, 5 %): other cuDNN algorithms per batch
# size round other outputs to the neighbouring bf16 value, and a flipped
# last bf16 bit moves scores near the threshold (on the CPU the port and
# JAX in bf16 match 0.978 and 0.982 by this rule on the golden fixture,
# tests/test_torch_port_bf16.py). The card against the CPU path is held at
# 0.90: cuDNN's tensor-core sums and the CPU's fp32 sums round different
# outputs (each convolution within its bound of the fp32 sum rounded
# once: bf16_conv_check and the bf16 cliff map), and through five levels
# and the vote on these weights, whose scores crowd the threshold, that
# gave 0.934 and 0.936 each way on an H100 80GB HBM3 at 700 W (0.939 and
# 0.954 fed the card's K1 outputs, so the stem is not what moves them).
# The strict rule is printed beside both
BF16_MATCH_MIN, BF16_CPU_MATCH_MIN, BF16_COUNT_SLACK = 0.95, 0.90, 0.05
# a bf16 convolution on the card against the fp32 sum of the same bf16
# products rounded once: the share of outputs that may differ, each within
# two fp32 sums of the same terms in different orders plus a bf16 ulp
BF16_CONV_MAX_DIFFER = 0.01
BF16_WALL_REPS = 5
SERVE_WINDOW_MS = 50
# the cliff map's limits: no 3×3 convolution of the forward may add more
# than 4 GB or take more than 5× its fp32 bound. Below CLIFF_FLOOR_MS of
# bound a convolution is a few kernels' latency (the smallest levels),
# which no library call brings within 5×: those are reported, not held
CLIFF_MAX_OF_BOUND, CLIFF_MAX_ADDED, CLIFF_FLOOR_MS = 5.0, 4e9, 0.05
# K3's cases over the anchors of a 1200×1600 image: (gt, masked, layout)
IOU_CASES = ((0, 0, "uniform"), (1, 0, "uniform"), (64, 0, "uniform"),
             (64, 64, "uniform"), (512, 100, "uniform"),
             (2048, 500, "uniform"), (2048, 0, "crowd"), (2048, 0, "band"))
IOU_TIMED = ((64, 0, "uniform"), (2048, 500, "uniform"), (2048, 0, "crowd"),
             (2048, 0, "band"))
# the band: faces packed at the top left, all in the first block's union
# box, so that its list of gt fills and is walked early (csrc/iou.cu)
BAND = (0, 0, 600, 40)
# K2's launches (csrc/stem_grad.cu) in order, by the stage each runs
GRAD_KERNELS = {"c1_route": "c1_route_kernel", "split_w2f": "split_w2f_kernel",
                "dc1": "dc1_kernel", "wgrad": "wgrad_kernel",
                "reduce": "reduce_kernel"}
# K1's launches (csrc/stem.cu)
STEM_KERNELS = {"split_w2": "split_w2_kernel", "stem": "stem_kernel"}
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
    """x, dy and OIHW weights for K2, and without dy for K1 (the
    small-integer recipe of tests/test_pallas_stem.py:192-213, every
    product and sum exact in fp32 and in 3xTF32, or floats), as float64
    numpy."""
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


def stem_time(stem, args, err, err_over_peak):
    """K1 at the largest detection level: its wrapper's wall, its device
    time, the plain time and its bounds. Returns its entry of the kernels
    line."""
    B, H, W, _ = args[0].shape
    call = lambda: stem.fused_stem(*args)   # noqa: E731 (no routing)
    ms = median_ms(call)
    device_ms = graph_ms(call, reps=20)
    plain_ms = median_ms(lambda: stem.fused_stem_reference(*args))
    p = B * H * W
    n_bytes = 4 * (3 * p + 64 * p // 4)
    conv1_1, conv1_2 = 2 * 27 * 64 * p, 2 * 576 * 64 * p
    cores_ms, cores_by = bound_ms(n_bytes, conv1_1 + conv1_2)
    bnd, by = split_bound_ms(n_bytes, conv1_1, conv1_2)
    say("stem_time", shape=[B, H, W, 3], kernel_ms=ms, device_ms=device_ms,
        plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
        bound_cuda_cores_ms=cores_ms, bound_cuda_cores_by=cores_by,
        of_bound=bnd / device_ms, of_cuda_cores_bound=cores_ms / device_ms,
        timing="wall: median of 20 CUDA-event walls; device: 20 calls in "
               "one CUDA graph, median of 5 replays, per call")
    return {"name": "fused_stem", "route": "cuda",
            "source": "smallhardface_tpu_torch/csrc/stem.cu",
            "replaces": "smallhardface_tpu/ops/pallas_stem.py:69",
            "max_abs_err": err, "max_err_over_peak": err_over_peak,
            "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": by, "library_ms": None}


def stem_grad_time(stem, args, valid_hw, grad_err, prod_err, reps=20):
    """K2 at the training scale, on a routing K1 wrote beforehand (so that
    K1 is not inside K2's CUDA graph): its wrapper's wall, its device time,
    each launch's device time and its bounds. Returns its entry of the
    kernels line."""
    B, H, W, _ = args[0].shape
    x, dy, w1, b1, w2, b2 = args
    _, route = stem._stem_kernel(x, w1, b1, w2, b2, valid_hw, with_route=True)
    call = lambda: stem.fused_stem_grad(  # noqa: E731
        *args, valid_hw=valid_hw, route=route)
    ms = median_ms(call)
    device_ms = graph_ms(call, reps=reps)
    stage_ms = kernel_ms(call, GRAD_KERNELS)
    plain_ms = median_ms(lambda: stem.fused_stem_grad_reference(
        *args, valid_hw=valid_hw))
    p = B * H * W
    n_bytes = 4 * (3 * p + 64 * p // 4) + 64 * p // 4      # x, dy, route
    # all on the CUDA cores: conv1_1, the data gradient, dw2, dw1
    cores_ms, cores_by = bound_ms(n_bytes, 2 * (2 * 576 + 2 * 27) * 64 * p)
    # this design: conv1_1 and the dw1 job on the CUDA cores, the data
    # gradient and dw2 as three TF32 products each on the tensor cores
    bnd, by = split_bound_ms(n_bytes, 2 * (2 * 27) * 64 * p,
                             2 * (2 * 576) * 64 * p)
    say("stem_grad_time", shape=[B, H, W, 3], kernel_ms=ms,
        device_ms=device_ms, stage_device_ms=stage_ms,
        stage_sum_ms=sum(stage_ms.values()), plain_ms=plain_ms,
        bound_ms=bnd, bound_by=by, bound_cuda_cores_ms=cores_ms,
        bound_cuda_cores_by=cores_by, of_bound=bnd / device_ms,
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
        if hasattr(fn, "route_writes"):
            fn.route_writes = 0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    from smallhardface_tpu_torch.config import CONFIG_DIR, cfg, cfg_from_file
    from smallhardface_tpu_torch.detect import TorchDetector, _pyramid_scales
    from smallhardface_tpu_torch.models import detector as tdm
    from smallhardface_tpu_torch.ops import (conv_int8, cuda_build, iou,
                                             nms_device, stem)
    from smallhardface_tpu_torch.ops.bbox import iou_matrix

    t_smoke = time.perf_counter()
    dev = torch.device("cuda", 0)
    pristine = copy.deepcopy(cfg)
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
    libs = [stem.STEM, stem.STEM_GRAD, iou.IOU, nms_device.VOTE,
            conv_int8.CONV_INT8, empty]
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
    # small integers: the output and the routing equal to the bit
    rng = np.random.RandomState(SEED + 7)
    for shape, valid_hw in STEM_SHAPES:
        x, _, *ws = grad_inputs(rng, shape, valid_hw, integer=True)
        wide = [torch.from_numpy(a).to(dev) for a in [x] + ws]
        out, route = stem._stem_kernel(*[a.float() for a in wide], valid_hw,
                                       with_route=True)
        same_out = torch.equal(out.double(), stem.fused_stem_reference(
            *wide, valid_hw))
        same_route = torch.equal(route, stem.fused_stem_route_reference(
            *wide, valid_hw))
        codes = torch.bincount(route.flatten().long(), minlength=5)
        say("stem_int_vs_plain", shape=list(shape), valid_hw=valid_hw,
            out_bit_equal=same_out, route_bit_equal=same_route,
            route_codes=codes.tolist(), reference="plain forward in float64")
        if not (same_out and same_route):
            raise AssertionError(f"K1 is not equal to the bit at {shape}")
        del x, ws, wide, out, route
    torch.cuda.empty_cache()
    # floats: within RTOL; the timing at the largest level
    rng = np.random.RandomState(SEED)
    max_err = max_ratio = 0.0
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
        max_ratio = max(max_ratio, err.max().item() / scale)
        say("stem_vs_plain", shape=list(shape), valid_hw=valid_hw,
            max_abs_err=err.max().item(), max_abs_ref=scale,
            max_err_over_peak=err.max().item() / scale, n_outside_tol=bad,
            rtol=RTOL, atol=f"{RTOL}*max|ref|")
        if bad or not torch.isfinite(got).all():
            raise AssertionError(f"stem kernel disagrees at {shape}")
        if shape == STEM_SHAPES[-1][0]:
            kernels["fused_stem"] = stem_time(stem, [x, w1, b1, w2, b2],
                                              max_err, max_ratio)
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
    agree = _check_agreement("reference", small_gpu, small_cpu,
                             scales=[100, 300])
    if not agree:
        raise AssertionError("GPU detections disagree with the CPU path")
    cfg.TEST.SCALES = [100, 300, 600, 1000, 1400]

    vote_fns = (nms_device.bbox_vote_device, nms_device.nms_device)
    set_counts_zero(stem.fused_stem, stem.fused_stem_grad, iou.max_iou,
                    *vote_fns)
    torch.cuda.reset_peak_memory_stats()
    n_forward = n_detect = 0
    card_dets = []
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
            n_detect += 1
        card_dets.append(runs[0])
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
        if i == 0:
            first_walls = walls
        if not (ok and same):
            raise AssertionError(f"detections of image {i} fail the checks")
    detect_counts = {"fused_stem": stem.fused_stem.launches,
                     "route_writes": stem.fused_stem.route_writes,
                     "fused_stem_grad": stem.fused_stem_grad.launches,
                     "max_iou": iou.max_iou.launches,
                     "bbox_vote": nms_device.bbox_vote_device.launches,
                     "nms": nms_device.nms_device.launches}
    say("detect_path", forward_passes=n_forward, detects=n_detect,
        launches=detect_counts,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    if detect_counts["fused_stem"] != n_forward:
        raise AssertionError("the stem kernel did not run once per forward")
    if detect_counts["route_writes"]:
        raise AssertionError("K1 wrote a pool routing under inference")
    if detect_counts["bbox_vote"] != n_detect or detect_counts["nms"]:
        raise AssertionError("the vote kernel did not run once per detect")

    # the float64 host vote of the JAX DEVICE_VOTE=false path, for its time
    cfg.TPU.DEVICE_VOTE = False
    host_det = TorchDetector(params, spec, dev)
    host_walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        host_dets = host_det.detect(images[0], THRESH)[0][0]
        torch.cuda.synchronize()
        host_walls.append(time.perf_counter() - t)
    cfg.TPU.DEVICE_VOTE = True
    say("detect_host_vote", image=0, dets=int(host_dets.shape[0]),
        walls_s=host_walls, device_vote_walls_s=first_walls)
    del host_det

    kernels["fused_stem"]["device_ms_per_detect"] = stem_per_detect(
        det, images[0], stem)
    detect_split(det, images[0], nms_device, float(cfg.TEST.NMS_THRESH))
    vote_entry = vote_phase(det, images, nms_device, float(
        cfg.TEST.NMS_THRESH))
    pyramid_card_vs_cpu(params, spec, images[0], card_dets[0], TorchDetector)
    detect_peak(det, images[0])
    kernels["bbox_vote_batched_device_ms"] = v1_batched(
        det, images, nms_device, float(cfg.TEST.NMS_THRESH))
    k1_batched_extents(stem, dev)

    # ---- spatial H-sharding of detection over units of one card ----
    kernels["fused_stem_spatial"] = spatial_phase(
        cfg, tdm, params, images, det, card_dets[0], dev, stem, nms_device,
        conv_int8)
    torch.cuda.empty_cache()

    # ---- the slice's path: detect_many and the service ----
    many_counts, dm_images = detect_many_phase(det, stem, nms_device)
    del det
    torch.cuda.empty_cache()
    serve_phase(params, spec, dm_images, dev)
    torch.cuda.empty_cache()

    # ---- int8 serving ----
    snapshot = copy.deepcopy(cfg)
    kernels["conv3x3_int8"] = int8_phase(
        cfg, tdm, params, images, dm_images, dev, stem, nms_device,
        conv_int8, first_walls)
    cfg.clear()
    cfg.update(snapshot)
    torch.cuda.empty_cache()

    # ---- bf16 detection ----
    bf16_counts, bf16_many_counts = bf16_phase(
        cfg, tdm, params, images, dm_images, dev, stem, nms_device,
        card_dets)
    cfg.clear()
    cfg.update(snapshot)
    torch.cuda.empty_cache()
    cliff_map(dev)
    torch.cuda.empty_cache()
    cliff_map(dev, torch.bfloat16)
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
                stem, [a.contiguous() for a in args], valid_hw, grad_err,
                prod_err)
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
        spatial_train_out = spatial_train(cfg, tdm, stem, iou, dev, work)
        cpu_vs_card(cfg, tdm, dev, work)
        cfg.clear()
        cfg.update(copy.deepcopy(pristine))
        root = wider_tree(work)
        eval_counts = eval_cli(cfg, stem, iou, nms_device, root)
        auto_resume_phase(work, root)
        dp_counts = dp_phases(cfg, tdm, dev, pristine, root, work, smi)
        tools_counts = tools_phase(cfg, pristine, tdm, params, images[0],
                                   card_dets[0], dev, smi, work)
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
    kernels["fused_stem"]["launches_detect_many"] = many_counts["fused_stem"]
    vote_entry["batched_device_ms"] = kernels.pop(
        "bbox_vote_batched_device_ms")
    kernels["bbox_vote"] = vote_entry
    kernels["bbox_vote"]["launches_detect_many"] = many_counts["bbox_vote"]
    kernels["bbox_vote"]["launches"] = eval_counts["bbox_vote"]
    kernels["bbox_vote"]["launches_path"] = "eval_cli"
    kernels["bbox_vote"]["launches_detect"] = detect_counts["bbox_vote"]
    for k in ("fused_stem", "bbox_vote"):
        kernels[k]["launches_bf16_detect"] = bf16_counts[k]
        kernels[k]["launches_bf16_detect_many"] = bf16_many_counts[k]
    for k in ("fused_stem", "fused_stem_grad", "max_iou"):
        kernels[k]["launches_eval_cli"] = eval_counts[k]
    for k in ("fused_stem", "max_iou"):
        kernels[k]["launches_dp_two_ranks"] = [c[k] for c in dp_counts]
    for k in ("fused_stem", "bbox_vote", "max_iou", "conv3x3_int8"):
        kernels[k]["launches_tools"] = tools_counts[k]
    sp_tree = spatial_train_out["counts"]
    kernels["fused_stem_grad"]["launches_train_spatial"] = {
        str(k): c["fused_stem_grad"] for k, c in sp_tree.items() if k > 1}
    kernels["fused_stem"]["launches_train_spatial"] = spatial_train_out[
        "flagship"]["fused_stem"]
    k4 = kernels["fused_stem_spatial"]
    k4["launches_train_spatial"] = spatial_train_out["flagship"][
        "fused_stem_spatial"]
    k4["backward_launches"] = sp_tree[SPATIAL_GRAD_KS[-1]][
        "fused_stem_grad"]
    k4["backward_launches_path"] = (
        f"spatial_train_full_tree k={SPATIAL_GRAD_KS[-1]}")
    k4.update({f: v for f, v in spatial_train_out["k4"].items()
               if f.startswith("backward")})
    k4["backward_k"] = SPATIAL_GRAD_KS[-1]
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib",
                                            "smallhardface_tpu"))
    if foreign:
        raise AssertionError(f"the port imported {foreign}")

    say("total", seconds=time.perf_counter() - t_smoke, nvidia_smi=smi)
    print(json.dumps({"kernels": [kernels[k] for k in (
        "fused_stem", "fused_stem_spatial", "fused_stem_grad", "max_iou",
        "bbox_vote", "conv3x3_int8")]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def int8_layer_shapes(level=INT8_LEVEL):
    """The int8 convolutions of a pyramid level (the 1408×1872 one unless
    ``level`` names another network input) at batch 2 (image and mirror),
    as the calibrated chain runs them: (name, C, O, H, W, dilation,
    epilogue), the epilogue "link" (ReLU, int8 out) or "end" (ReLU, fp32
    out); the head once per dilation."""
    h, w = level[0] // 2, level[1] // 2
    rows, c = [], 64
    for stage, o, n in (("conv2", 128, 2), ("conv3", 256, 3),
                        ("conv4", 512, 3), ("conv5", 512, 3)):
        for i in range(1, n + 1):
            last = stage == "conv5" and i == n
            rows.append((f"{stage}_{i}", c, o, h, w, 1,
                         "end" if last else "link"))
            c = o
        if stage != "conv4":
            h, w = -(-h // 2), -(-w // 2)
        else:                               # conv5 runs at stride 16
            h8, w8 = h, w
            h, w = -(-h // 2), -(-w // 2)
    h, w = h8, w8
    rows += [("conv4_fuse_final", 512, 512, h, w, 1, "link"),
             ("conv4_fuse_final_dim_red", 512, 128, h, w, 1, "link")]
    rows += [(f"head_d{d}", 128, 128, h, w, d, "end") for d in (1, 2, 4)]
    return rows


def q1_bound_ms(B, C, O, H, W, int8_out):
    """Q1's bound for one call: its bytes (input, weights, output, scale
    and bias, each once) at 3.35 TB/s or its 2·M·N·K int8 operations at
    1,979 TOPS, the larger, and which it is."""
    M, K = B * H * W, 9 * C
    n_bytes = M * C + O * K + M * O * (1 if int8_out else 4) + 8 * O
    return max((n_bytes / PEAK_BYTES * 1e3, "bytes"),
               (2.0 * M * O * K / PEAK_INT8 * 1e3, "operations"))


def _q1_inputs(gen, B, C, O, H, W, dev, extreme, per_image, ties=False):
    """Q1's inputs on the card: int8 NHWC activations (uniform, or only
    -128, -127, 0, 127), (O, 3, 3, C) weights, scale rows that spread the
    outputs over the int8 range, a bias and an output step. ``ties``: small
    values, a scale of 1, a bias of 0.5 and a step of 1, so that every
    requantized value is a tie (x.5), which Q1 settles with exact sign
    tests instead of its product with the step's reciprocal."""
    if extreme:
        vals = torch.tensor([-128, -127, 0, 127], dtype=torch.int8,
                            device=dev)
        x = vals[torch.randint(0, 4, (B, H, W, C), generator=gen,
                               device=dev)]
        w = vals[1:][torch.randint(0, 3, (O, 3, 3, C), generator=gen,
                                   device=dev)]
    else:
        lo, hi = (-2, 3) if ties else (-128, 128)
        x = torch.randint(lo, hi, (B, H, W, C), generator=gen,
                          device=dev, dtype=torch.int8)
        w = torch.randint(max(lo, -127), hi, (O, 3, 3, C), generator=gen,
                          device=dev, dtype=torch.int8)
    spread = 40.0 / (math.sqrt(9 * C) * 74.0 * 74.0)
    scale = (0.5 + torch.rand((B if per_image else 1, O), generator=gen,
                              device=dev)) * spread
    bias = torch.randn((O,), generator=gen, device=dev) * 5
    if ties:
        return (x.permute(0, 3, 1, 2), w, torch.ones_like(scale),
                torch.full_like(bias, 0.5), 1.0)
    return x.permute(0, 3, 1, 2), w, scale, bias, 0.8173


def q1_checks(conv_int8, dev):
    """Q1 against its plain version, equal to the bit: at every int8 layer
    shape of the 1408×1872 level (batch 2) for the epilogue the chain runs
    there and the dynamic one, on the extremes for all three epilogues at
    three of them, at the tiling's edges (Q1_EDGES, with every requantized
    value a tie once), and at one layer of each smaller level of image 0's
    pyramid (Q1_SMALLER), and a chain link whose step lies below 2^-60 (the
    instance that divides every output). Returns (checks, max |Δ|); raises
    at the first difference."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    epilogues = {"link": dict(relu=True, s_out=True),
                 "end": dict(relu=True, s_out=False),
                 "dynamic": dict(relu=False, s_out=False)}
    shapes = int8_layer_shapes()
    extreme_at = {shapes[0][0], "conv4_2", "head_d4"}
    cases = []
    for name, C, O, H, W, d, epi in shapes:
        for e, extreme in [(epi, False), ("dynamic", False)] + (
                [(e, True) for e in epilogues] if name in extreme_at else []):
            cases.append((f"1408/{name}", 2, C, O, H, W, d, e, extreme, False,
                          None))
    for label, B, H, W, C, O, d, e, ties in Q1_EDGES:
        cases.append((label, B, C, O, H, W, d, e, False, ties, None))
    # a step below 2^-60: the chain link that divides every output
    cases.append(("step_2^-61", 2, 128, 256, 19, 23, 1, "link", False, False,
                  2.0 ** -61))
    for level, layer in zip(Q1_SMALLER_LEVELS, Q1_SMALLER):
        for name, C, O, H, W, d, epi in int8_layer_shapes(level):
            if name == layer:
                for e in (epi, "dynamic"):
                    cases.append((f"{level[0]}/{name}", 2, C, O, H, W, d, e,
                                  False, False, None))
    checks, max_err = [], 0.0
    for label, B, C, O, H, W, d, e, extreme, ties, step in cases:
        x, w, scale, bias, s_out = _q1_inputs(
            gen, B, C, O, H, W, dev, extreme, per_image=e == "dynamic",
            ties=ties)
        if step is not None:
            scale, bias = scale * (step / s_out), bias * (step / s_out)
            s_out = step
        kw = dict(dilation=d, relu=epilogues[e]["relu"],
                  s_out=s_out if epilogues[e]["s_out"] else None)
        before = conv_int8.conv3x3_int8.launches
        got = conv_int8.conv3x3_int8(x, w, scale, bias, **kw)
        want = conv_int8.conv3x3_int8_reference(x, w, scale, bias, **kw)
        torch.cuda.synchronize()
        conv_int8.conv3x3_int8.launches = before   # a comparison launch
        equal = torch.equal(got, want)
        err = (got.float() - want.float()).abs().max().item()
        max_err = max(max_err, err)
        checks.append({"case": label, "shape": [B, C, O, H, W], "dilation": d,
                       "epilogue": e, "extreme": extreme, "ties": ties,
                       "step": s_out if kw["s_out"] is not None else None,
                       "plan": list(conv_int8.plan(H, W, C, O)),
                       "bit_equal": equal, "max_abs_err": err})
        if not equal:
            say("q1_vs_plain", checks=checks)
            raise AssertionError(f"Q1 differs from its plain version at "
                                 f"{checks[-1]}")
        del x, w, scale, bias, got, want
    return checks, max_err


def q1_phase(conv_int8, layers, dev):
    """Q1 against its plain version (``q1_checks``); then, per int8 layer
    shape of the 1408×1872 level, its times, bound and yardsticks. Returns
    the kernels entry."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    B = 2
    rows = []
    shapes = int8_layer_shapes()
    checks, max_err = q1_checks(conv_int8, dev)
    say("q1_vs_plain", level=list(INT8_LEVEL), checks=checks,
        all_bit_equal=True, reference="F.conv2d in float64, then the fp32 "
        "epilogue as separate PyTorch ops")
    torch.cuda.empty_cache()
    for name, C, O, H, W, d, epi in shapes:
        x, w, scale, bias, s_out = _q1_inputs(gen, B, C, O, H, W, dev,
                                              False, False)
        kw = dict(dilation=d, relu=True,
                  s_out=s_out if epi == "link" else None)
        call = lambda: conv_int8.conv3x3_int8(  # noqa: E731
            x, w, scale, bias, **kw)
        before = conv_int8.conv3x3_int8.launches
        row = {"layer": name, "C": C, "O": O, "hw": [H, W], "dilation": d,
               "epilogue": epi, "ms": median_ms(call, n=5, warmup=2),
               "device_ms": graph_ms(call, reps=10, n=3),
               "plain_ms": median_ms(lambda: conv_int8.conv3x3_int8_reference(
                   x, w, scale, bias, **kw), n=3, warmup=1)}
        conv_int8.conv3x3_int8.launches = before
        M, K = B * H * W, 9 * C
        row["plan"] = list(conv_int8.plan(H, W, C, O))
        row["bound_ms"], row["bound_by"] = q1_bound_ms(B, C, O, H, W,
                                                       epi == "link")
        row["of_bound"] = row["bound_ms"] / row["device_ms"]
        # the yardsticks: the fp32 layer Q1 replaces, as the forward ran it
        # in fp32, and one int8 GEMM of the same size with an int32 output
        xf = torch.randn((B, C, H, W), generator=gen, device=dev).contiguous(
            memory_format=torch.channels_last)
        wf = torch.randn((O, C, 3, 3), generator=gen, device=dev) * 0.02
        bf = torch.randn((O,), generator=gen, device=dev)
        with torch.no_grad():
            row["fp32_conv3x3_ms"] = median_ms(
                lambda: layers.conv3x3(xf, wf, bf, dilation=d), n=3, warmup=1)
        del xf, wf, bf
        a = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                          dtype=torch.int8)
        b = torch.randint(-128, 128, (O, K), generator=gen, device=dev,
                          dtype=torch.int8).t()
        try:
            row["int_mm_ms"] = median_ms(lambda: torch._int_mm(a, b), n=3,
                                         warmup=1)
        except RuntimeError as e:          # a yardstick only
            row["int_mm_ms"], row["int_mm_error"] = None, str(e)[:200]
        del a, b, x, w
        torch.cuda.empty_cache()
        rows.append(row)
    total = {k: sum(r[k] for r in rows) for k in (
        "ms", "device_ms", "plain_ms", "bound_ms", "fp32_conv3x3_ms")}
    mm = [r["int_mm_ms"] for r in rows]
    total["int_mm_ms"] = sum(mm) if None not in mm else None
    ops_bound = sum(r["bound_ms"] for r in rows if r["bound_by"]
                    == "operations")
    say("q1_time", batch=B, level=list(INT8_LEVEL), layers=rows,
        sum=total, of_bound=total["bound_ms"] / total["device_ms"],
        timing="ms: CUDA events around the wrapper, median of 5; "
               "device_ms: 10 calls in one CUDA graph, median of 3 "
               "replays; plain, fp32 conv3x3, _int_mm: CUDA events, "
               "median of 3; bound: bytes at 3.35 TB/s or 2*M*N*K at "
               "1979 TOPS, the larger")
    return {"name": "conv3x3_int8", "route": "cuda",
            "source": "smallhardface_tpu_torch/csrc/conv_int8.cu",
            "replaces": "smallhardface_tpu/models/layers.py:117",
            "also_replaces": "smallhardface_tpu/models/layers.py:63",
            "max_abs_err": max_err, "ms": total["ms"],
            "device_ms": total["device_ms"], "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"],
            "bound_by": ("operations" if ops_bound * 2 >= total["bound_ms"]
                         else "bytes"),
            "library_ms": None,
            "fp32_conv3x3_ms": total["fp32_conv3x3_ms"],
            "int_mm_ms": total["int_mm_ms"],
            "timed_as": "the 16 int8 convolutions of one batch-2 forward at "
                        "the 1408x1872 level, summed"}


def detect_device_split(det, image, wall_ms, n=2):
    """Where one warm ``detect`` of `image` spends its device time: Q1's,
    K1's and V1's kernels (V1's three launches as the union of their
    intervals), cuDNN's convolutions (kernels named as CONV_KERNEL_MARKS)
    and the rest (cuBLAS, elementwise, copies), with the eight largest
    kernels of the last two by name, per detect under torch.profiler, and
    the idle share of ``wall_ms``, its wall without the profiler."""
    from torch.profiler import ProfilerActivity, profile
    det.detect(image, THRESH)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            det.detect(image, THRESH)
        torch.cuda.synchronize()
    split = {"q1": 0.0, "k1": 0.0, "v1": 0.0, "conv": 0.0, "other": 0.0}
    convs, others = {}, {}
    cuda = torch.autograd.DeviceType.CUDA
    is_v1 = lambda key: any(f"::{k}<" in key for k in V1_KERNELS)  # noqa: E731
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        # the device's own events (kernels, copies), not the CPU ops that
        # launched them, nor the device spans of the forward's per-layer
        # record_function ranges (GPU user annotations, gaps included)
        if (not us or getattr(ev, "device_type", None) != cuda
                or getattr(ev, "is_user_annotation", False)):
            continue
        if f"::{Q1_KERNEL}<" in ev.key or f"{Q1_KERNEL}<" in ev.key:
            split["q1"] += us
        elif any(f"::{k}(" in ev.key for k in STEM_KERNELS.values()):
            split["k1"] += us
        elif any(m in ev.key for m in CONV_KERNEL_MARKS):
            split["conv"] += us
            convs[ev.key[:90]] = convs.get(ev.key[:90], 0.0) + us
        elif not is_v1(ev.key):
            split["other"] += us
            others[ev.key[:90]] = others.get(ev.key[:90], 0.0) + us
    # V1's second and third launches start while the one before runs
    # (programmatic dependent launch) and wait for it, so their durations
    # overlap: V1's time is the union of its kernels' intervals
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if getattr(ev, "device_type", None) == cuda
                   and is_v1(ev.name))
    end = -math.inf
    for a, b in spans:
        split["v1"] += max(0.0, b - max(a, end))
        end = max(end, b)
    ms = {k: v / n / 1e3 for k, v in split.items()}
    busy = sum(ms.values())
    def top(d):
        return {k: v / n / 1e3
                for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:8]}
    return {"device_ms": ms, "device_ms_sum": busy, "wall_ms": wall_ms,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "conv_top_ms": top(convs), "other_top_ms": top(others)}


def int8_phase(cfg, tdm, params, images, dm_images, dev, stem, nms_device,
               conv_int8, fp32_walls):
    """The int8 serving path on the card (smallhardface-int8.toml): Q1
    against its plain version and timed (``q1_phase``), calibration on the
    three images, a warm calibrated ``detect`` of image 0 against the
    port's int8 CPU path on the card's stem outputs, the int8-vs-fp32
    logits correlation, a dynamic ``detect``, ``detect_many`` at max_batch
    4 and the service with calib_images. Returns Q1's kernels entry."""
    import threading
    import urllib.request
    import cv2
    from smallhardface_tpu_torch import serve as serve_mod
    from smallhardface_tpu_torch.config import CONFIG_DIR, cfg_from_file
    from smallhardface_tpu_torch.detect import TorchDetector, level_sizes
    from smallhardface_tpu_torch.models import layers
    entry = q1_phase(conv_int8, layers, dev)

    cfg_from_file(os.path.join(CONFIG_DIR, "smallhardface-int8.toml"))
    cfg.TEST.SCALES = list(INT8_SCALES)
    cfg.TEST.FLIP = True
    cfg.TEST.NMS_METHOD = "BBOX_VOTE"
    spec = tdm.build_spec(cfg)
    plain_calls = [0]
    reference = conv_int8.conv3x3_int8_reference

    def counted(*args, **kwargs):
        plain_calls[0] += 1
        return reference(*args, **kwargs)
    conv_int8.conv3x3_int8_reference = counted
    try:
        det = TorchDetector(params, spec, dev)
        t = time.perf_counter()
        amax = det.calibrate_int8(images)
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t
        det.detect(images[0], THRESH)                          # warm
        fns = (conv_int8.conv3x3_int8, stem.fused_stem,
               nms_device.bbox_vote_device)
        set_counts_zero(*fns)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        dets = det.detect(images[0], THRESH)[0][0]
        torch.cuda.synchronize()
        walls = [time.perf_counter() - t]
        peak = torch.cuda.max_memory_allocated()
        counts = {"conv3x3_int8": conv_int8.conv3x3_int8.launches,
                  "fused_stem": stem.fused_stem.launches,
                  "bbox_vote": nms_device.bbox_vote_device.launches}
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            det.detect(images[0], THRESH)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        split = detect_device_split(det, images[0],
                                    float(np.median(walls)) * 1e3)
        # Q1's calls in one more detect: their shapes give its bound per
        # detect, and must be the ones detect.level_sizes and
        # int8_layer_shapes model (scripts/q1_vs_parent.py times those)
        calls = []
        run_q1 = layers.conv3x3_int8

        def record_q1(x, qw, scale, bias, **kw):
            calls.append((x.shape[0], x.shape[1], qw.shape[0], x.shape[2],
                          x.shape[3], int(kw.get("dilation", 1)),
                          kw.get("s_out") is not None))
            return run_q1(x, qw, scale, bias, **kw)
        layers.conv3x3_int8 = record_q1
        try:
            det.detect(images[0], THRESH)
        finally:
            layers.conv3x3_int8 = run_q1
        modelled = sorted(
            (2, C, O, H, W, d, epi == "link")
            for *_, hb, wb in level_sizes(images[0].shape)
            for _, C, O, H, W, d, epi in int8_layer_shapes((hb, wb)))
        split["q1_bound_ms"] = sum(q1_bound_ms(B, C, O, H, W, i8)[0]
                                   for B, C, O, H, W, _, i8 in calls)
        split["q1_of_bound"] = (split["q1_bound_ms"]
                                / max(split["device_ms"]["q1"], 1e-9))
        split["q1_shapes_as_modelled"] = sorted(calls) == modelled
        # K1's outputs of one more detect, for the CPU path below
        recorded = []
        run_stem = tdm.fused_stem

        def record(*args, **kwargs):
            out = run_stem(*args, **kwargs)
            recorded.append(out.cpu())
            return out
        tdm.fused_stem = record
        try:
            again = det.detect(images[0], THRESH)[0][0]
        finally:
            tdm.fused_stem = run_stem
        deterministic = np.array_equal(again, dets)
        h, w = images[0].shape[:2]
        ok = (dets.ndim == 2 and dets.shape[1] == 5
              and np.isfinite(dets).all() and (dets[:, 4] > THRESH).any()
              and (dets[:, :4] >= 0).all()
              and (dets[:, 2] <= w + 8).all() and (dets[:, 3] <= h + 8).all())
        # the int8 logits against fp32 on the card, at the largest level
        lv = det._prep(images[0])["levels"][-1]
        imgs = torch.from_numpy(det._prep(images[0])["padded"][None]).to(
            dev).float()
        with torch.inference_mode():
            x = det._level_batch(imgs, [lv], lv["hb"], lv["wb"])
            q8 = det.model(x, precision="int8", qstate=det.qstate)
            f32 = det.model(x)
            corr = float(np.corrcoef(
                q8["cls_logits"].double().cpu().numpy().ravel(),
                f32["cls_logits"].double().cpu().numpy().ravel())[0, 1])
        del x, q8, f32, imgs
        # the dynamic mode: one detect of image 0 without the qstate
        qstate, det.qstate = det.qstate, None
        det.detect(images[0], THRESH)
        set_counts_zero(conv_int8.conv3x3_int8)
        torch.cuda.synchronize()
        t = time.perf_counter()
        dyn = det.detect(images[0], THRESH)[0][0]
        torch.cuda.synchronize()
        dyn_wall = time.perf_counter() - t
        dyn_launches = conv_int8.conv3x3_int8.launches
        det.qstate = qstate
        # detect_many at max_batch 4 against per-image int8 detect
        singles = [det.detect(im, THRESH)[0][0] for im in dm_images]
        det.detect_many(dm_images, THRESH, max_batch=4)       # warm
        set_counts_zero(*fns)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        many = [d[0] for d in det.detect_many(dm_images, THRESH,
                                              max_batch=4)]
        torch.cuda.synchronize()
        many_wall = time.perf_counter() - t
        many_peak = torch.cuda.max_memory_allocated()
        many_counts = {"conv3x3_int8": conv_int8.conv3x3_int8.launches,
                       "fused_stem": stem.fused_stem.launches,
                       "bbox_vote": nms_device.bbox_vote_device.launches}
        many_rule = [_rule(a, b, INT8_MANY_MATCH_MIN)
                     for a, b in zip(many, singles)]
        # the service, calibrated at start-up on the three images
        work = tempfile.mkdtemp(prefix="chip_smoke_int8_", dir=_output_dir())
        paths = []
        for i, im in enumerate(images):
            paths.append(os.path.join(work, f"calib_{i}.png"))
            cv2.imwrite(paths[-1], im)
        service = serve_mod.DetectorService(params, spec, device=dev,
                                            calib_images=paths)
        service.warmup()
        srv = serve_mod.serve(service, "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        set_counts_zero(conv_int8.conv3x3_int8)
        try:
            served = []
            for im in images[:2]:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{srv.server_address[1]}/detect"
                    f"?thresh={THRESH}",
                    data=cv2.imencode(".png", im)[1].tobytes(),
                    method="POST")
                t = time.perf_counter()
                with urllib.request.urlopen(req, timeout=600) as r:
                    payload = json.loads(r.read())
                served.append((payload["count"], time.perf_counter() - t))
        finally:
            srv.shutdown()
            srv.server_close()
            shutil.rmtree(work, ignore_errors=True)
        serve_launches = conv_int8.conv3x3_int8.launches
        card_plain_calls = plain_calls[0]
    finally:
        conv_int8.conv3x3_int8_reference = reference

    # the yardstick of detect_many's agreement: int8 against fp32
    cfg.TPU.PRECISION = "float32"
    det32 = TorchDetector(params, spec, dev)
    vs_fp32 = [_rule(a, det32.detect(im, THRESH)[0][0], 0.0)
               for a, im in zip(singles, dm_images)]
    cfg.TPU.PRECISION = "int8"
    del det32
    # the port's int8 CPU path on the card's stem outputs, same qstate
    cpu_det = TorchDetector(params, spec, "cpu")
    cpu_det.qstate = {"scales": dict(det.qstate["scales"]),
                      "qw": {k: v.cpu() for k, v in det.qstate["qw"].items()},
                      "s_w": {k: v.cpu() for k, v in
                              det.qstate["s_w"].items()}}
    replay = iter(recorded)
    tdm.fused_stem = lambda *args, **kwargs: next(replay)
    try:
        t = time.perf_counter()
        cpu = cpu_det.detect(images[0], THRESH)[0][0]
        cpu_s = time.perf_counter() - t
    finally:
        tdm.fused_stem = run_stem
    agree, fwd, bwd = _rule(dets, cpu, INT8_MATCH_MIN)
    n_levels = len(cfg.TEST.SCALES)
    per_forward = len(tdm.int8_layer_names(spec)) + 2     # the head thrice
    want = {"conv3x3_int8": n_levels * per_forward, "fused_stem": n_levels,
            "bbox_vote": 1}
    say("int8_detect", image=0, hw=[h, w], dets=int(dets.shape[0]),
        checks_ok=bool(ok), deterministic=deterministic, warm_walls_s=walls,
        fp32_walls_s=fp32_walls, max_memory_allocated_bytes=peak,
        launches=counts, launches_expected=want, calibrate_s=calib_s,
        amax=amax, device_split=split, int8_vs_fp32_logits_corr=corr,
        corr_min=INT8_CORR_MIN, card_vs_cpu={
            "dets_cpu": int(cpu.shape[0]), "match_card_in_cpu": fwd,
            "match_cpu_in_card": bwd, "rule_holds": agree,
            "match_min": INT8_MATCH_MIN, "cpu_seconds": cpu_s,
            "cpu_stem": "the card's K1 outputs, replayed"},
        dynamic={"dets": int(dyn.shape[0]), "wall_s": dyn_wall,
                 "conv3x3_int8_launches": dyn_launches},
        timing="host clock after torch.cuda.synchronize(); peak: "
               "max_memory_allocated in the timed detect")
    say("int8_detect_many", images=len(dm_images), max_batch=4,
        wall_s=many_wall, images_per_s=len(dm_images) / many_wall,
        max_memory_allocated_bytes=many_peak, launches=many_counts,
        rule_holds=[r[0] for r in many_rule],
        min_match=min(min(r[1], r[2]) for r in many_rule),
        match=[[r[1], r[2]] for r in many_rule],
        match_min=INT8_MANY_MATCH_MIN, count_diffs=[
            len(a) - len(b) for a, b in zip(many, singles)],
        int8_vs_fp32_match=[[r[1], r[2]] for r in vs_fp32],
        reference="per-image int8 detect")
    say("int8_serve", calib_images=len(paths), responses=served,
        conv3x3_int8_launches=serve_launches,
        plain_q1_calls_on_the_card=card_plain_calls)
    if not (ok and deterministic and agree and corr > INT8_CORR_MIN
            and counts == want and split["device_ms"]["q1"] > 0
            and split["q1_shapes_as_modelled"]):
        raise AssertionError("the int8 detect fails its checks")
    if not (dyn_launches > 0 and many_counts["conv3x3_int8"] > 0
            and serve_launches > 0 and all(r[0] for r in many_rule)):
        raise AssertionError("an int8 path missed Q1 or disagrees")
    if card_plain_calls:
        raise AssertionError("an int8 path on the card reached Q1's plain "
                             "version")
    entry["launches"] = counts["conv3x3_int8"]
    entry["launches_path"] = "int8_detect"
    entry["launches_dynamic_detect"] = dyn_launches
    entry["launches_detect_many"] = many_counts["conv3x3_int8"]
    entry["launches_serve"] = serve_launches
    return entry


def bf16_conv_check(dev):
    """The 1×1 convolutions and the deconv of the forward at the 1408×1872
    level (batch 2), as the bf16 forward runs them on the card (cuDNN on
    bf16 tensors), against the fp32 sum of the same bf16 products (TF32
    off) rounded to bf16 once (``conv_map.bf16_vs_fp32``; the bf16 cliff
    map checks every 3×3 shape the same way): at most
    BF16_CONV_MAX_DIFFER of the outputs differ, each within its bound.
    Returns the worst share."""
    from smallhardface_tpu_torch.models import layers
    from smallhardface_tpu_torch.tools import conv_map
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    hb, wb = INT8_LEVEL
    shapes = [("conv5_256", 512, 256, hb // 16, wb // 16),
              ("conv4_256", 512, 256, hb // 8, wb // 8),
              ("cls_score_k", 128, 2, hb // 8, wb // 8),
              ("bbox_pred_k", 128, 4, hb // 8, wb // 8),
              ("conv5_256_up", 256, 256, hb // 16, wb // 16)]
    rows, worst = [], 0.0
    with torch.inference_mode():
        for name, C, O, H, W in shapes:
            x = (torch.randn((2, C, H, W), device=dev, generator=gen)
                 * 3).to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            if name == "conv5_256_up":
                # four exact products of the dyadic bilinear weights a pixel
                w = torch.from_numpy(np.ascontiguousarray(
                    layers.bilinear_kernel(2, C).transpose(3, 2, 0, 1))).to(
                    dev)
                got = layers.upsample2x_bilinear(x, w)
                ref = layers.upsample2x_bilinear(x.float(), w).to(
                    torch.bfloat16)
                row = {"differ_share": (got != ref).float().mean().item(),
                       "max_err_over_bound": (0.0 if torch.equal(got, ref)
                                              else math.inf),
                       "dtype": str(got.dtype)}
            else:
                w = (torch.randn((O, C, 1, 1), device=dev, generator=gen)
                     * math.sqrt(2 / C))
                row = conv_map.bf16_vs_fp32(x, w, 1, padding=0)
            rows.append({"layer": name, "shape": [2, C, O, H, W], **row})
            worst = max(worst, row["differ_share"])
            del x, w
    torch.cuda.empty_cache()
    say("bf16_conv_vs_fp32", level=list(INT8_LEVEL), rows=rows,
        max_differ_share=worst, limit_differ_share=BF16_CONV_MAX_DIFFER,
        reference="fp32 cuDNN (TF32 off) on the same bf16 values, rounded "
                  "to bf16 once")
    if any(r["dtype"] != "torch.bfloat16"
           or r["differ_share"] > BF16_CONV_MAX_DIFFER
           or r["max_err_over_bound"] > 1.0 for r in rows):
        raise AssertionError("a bf16 convolution disagrees with its fp32 "
                             "sum rounded once")
    return worst


def _loose_match(a, b):
    """The bf16 drift test's rule: the fraction of rows of `a` with an IoU
    > 0.6, |Δscore| < 0.1 partner in `b`."""
    if len(a) == 0:
        return 1.0 if len(b) == 0 else 0.0
    from smallhardface_tpu_torch.ops import bbox_np
    iou = bbox_np.bbox_overlaps(a[:, :4], b[:, :4])
    best = iou.argmax(axis=1)
    hit = (iou[np.arange(len(a)), best] > 0.6) & (
        np.abs(a[:, 4] - b[best, 4]) < 0.1)
    return float(hit.mean())


def _bf16_rule(a, b, min_match=BF16_MATCH_MIN):
    """(holds, loose a→b, loose b→a, strict a→b, strict b→a): the counts
    within max(3, BF16_COUNT_SLACK) and each side matched at min_match by
    the loose rule; the golden tests' strict rule beside it."""
    fwd, bwd = _loose_match(a, b), _loose_match(b, a)
    ok = (abs(len(a) - len(b)) <= max(3, BF16_COUNT_SLACK * len(b))
          and min(fwd, bwd) >= min_match)
    return ok, fwd, bwd, _match_fraction(a, b), _match_fraction(b, a)


def bf16_phase(cfg, tdm, params, images, dm_images, dev, stem, nms_device,
               fp32_dets):
    """The bf16 mode on the card (TPU.PRECISION = "bfloat16", the flagship
    config): its convolutions against the fp32 sums rounded once
    (``bf16_conv_check``), then warm ``detect`` of the three images (walls,
    peak, K1's and V1's launches, the device split and idle share), image
    0 against the port's bf16 CPU path (plain, and fed the card's K1
    outputs), bf16 against the fp32 detections (``fp32_dets``, printed),
    ``detect_many`` at max_batch 4 against per-image bf16 ``detect`` and
    one service request. Returns K1's and V1's launch counts of a detect
    and of the detect_many run."""
    import threading
    import urllib.request
    import cv2
    from smallhardface_tpu_torch import serve as serve_mod
    from smallhardface_tpu_torch.detect import TorchDetector
    conv_share = bf16_conv_check(dev)
    cfg.TPU.PRECISION = "bfloat16"
    spec = tdm.build_spec(cfg)
    det = TorchDetector(params, spec, dev)
    fns = (stem.fused_stem, nms_device.bbox_vote_device)

    def timed_detect(im):
        torch.cuda.synchronize()
        t = time.perf_counter()
        dets = det.detect(im, THRESH)[0][0]
        torch.cuda.synchronize()
        return dets, time.perf_counter() - t

    # the first detect of each image: cuDNN picks its bf16 algorithms
    first_walls = [timed_detect(im)[1] for im in images]
    set_counts_zero(*fns)
    torch.cuda.reset_peak_memory_stats()
    dets0, wall = timed_detect(images[0])
    peak = torch.cuda.max_memory_allocated()
    counts = {"fused_stem": stem.fused_stem.launches,
              "route_writes": stem.fused_stem.route_writes,
              "bbox_vote": nms_device.bbox_vote_device.launches}
    walls0, again = [wall], []
    for _ in range(BF16_WALL_REPS - 1):
        d, wall = timed_detect(images[0])
        walls0.append(wall)
        again.append(d)
    deterministic = all(np.array_equal(d, dets0) for d in again)
    split = detect_device_split(det, images[0],
                                float(np.median(walls0)) * 1e3)
    bf16_dets, per_image = [dets0], []
    for i, im in enumerate(images):
        if i:
            runs = [timed_detect(im) for _ in range(2)]
            bf16_dets.append(runs[0][0])
            deterministic = deterministic and np.array_equal(
                runs[0][0], runs[1][0])
        dets = bf16_dets[i]
        h, w = im.shape[:2]
        ok = (dets.ndim == 2 and dets.shape[1] == 5
              and np.isfinite(dets).all() and (dets[:, 4] > THRESH).any()
              and (dets[:, :4] >= 0).all()
              and (dets[:, 2] <= w + 8).all() and (dets[:, 3] <= h + 8).all())
        vs32 = _bf16_rule(dets, fp32_dets[i])
        per_image.append({
            "image": i, "hw": [h, w], "dets": int(dets.shape[0]),
            "checks_ok": bool(ok), "dets_fp32": int(len(fp32_dets[i])),
            "bf16_vs_fp32": {"loose": [vs32[1], vs32[2]],
                             "strict": [vs32[3], vs32[4]]},
            "walls_s": walls0 if i == 0 else [r[1] for r in runs]})
    # K1's outputs of one more detect of image 0, for the CPU path below
    recorded = []
    run_stem = tdm.fused_stem

    def record(*args, **kwargs):
        out = run_stem(*args, **kwargs)
        recorded.append(out.cpu())
        return out
    tdm.fused_stem = record
    try:
        det.detect(images[0], THRESH)
    finally:
        tdm.fused_stem = run_stem

    # detect_many at max_batch 4 against per-image bf16 detect
    singles = [det.detect(im, THRESH)[0][0] for im in dm_images]
    det.detect_many(dm_images, THRESH, max_batch=4)                # warm
    set_counts_zero(*fns)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    many = [d[0] for d in det.detect_many(dm_images, THRESH, max_batch=4)]
    torch.cuda.synchronize()
    many_wall = time.perf_counter() - t
    many_peak = torch.cuda.max_memory_allocated()
    many_counts = {"fused_stem": stem.fused_stem.launches,
                   "bbox_vote": nms_device.bbox_vote_device.launches}
    many_rules = [_bf16_rule(a, b) for a, b in zip(many, singles)]

    # one request to the service
    service = serve_mod.DetectorService(params, spec, device=dev)
    srv = serve_mod.serve(service, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        service.warmup()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/detect"
            f"?thresh={THRESH}",
            data=cv2.imencode(".png", images[0])[1].tobytes(),
            method="POST")
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            payload = json.loads(r.read())
        served_s = time.perf_counter() - t
    finally:
        srv.shutdown()
        srv.server_close()
    served = np.asarray(payload["detections"], np.float32).reshape(-1, 5)
    served_ok = (len(served) == len(dets0)
                 and _match_fraction(served, dets0) == 1.0
                 and _match_fraction(dets0, served) == 1.0)
    del service, det
    torch.cuda.empty_cache()

    # the port's bf16 CPU path on image 0: plain, and fed the card's K1
    cpu_det = TorchDetector(params, spec, "cpu")
    t = time.perf_counter()
    cpu = cpu_det.detect(images[0], THRESH)[0][0]
    cpu_s = time.perf_counter() - t
    replay = iter(recorded)
    tdm.fused_stem = lambda *args, **kwargs: next(replay)
    try:
        cpu_fed = cpu_det.detect(images[0], THRESH)[0][0]
    finally:
        tdm.fused_stem = run_stem
    cfg.TPU.PRECISION = "float32"
    card_cpu = _bf16_rule(dets0, cpu, BF16_CPU_MATCH_MIN)
    card_fed = _bf16_rule(dets0, cpu_fed, BF16_CPU_MATCH_MIN)
    n_levels = len(cfg.TEST.SCALES)
    want = {"fused_stem": n_levels, "route_writes": 0, "bbox_vote": 1}
    say("bf16_detect", images=per_image, deterministic=deterministic,
        first_walls_s=first_walls, warm_walls_s=walls0,
        median_wall_s=float(np.median(walls0)),
        max_memory_allocated_bytes=peak, launches=counts,
        launches_expected=want, device_split=split,
        card_vs_cpu={"dets_cpu": int(len(cpu)),
                     "loose": [card_cpu[1], card_cpu[2]],
                     "strict": [card_cpu[3], card_cpu[4]],
                     "rule_holds": card_cpu[0], "cpu_seconds": cpu_s,
                     "fed_the_card_k1": {
                         "dets_cpu": int(len(cpu_fed)),
                         "loose": [card_fed[1], card_fed[2]],
                         "strict": [card_fed[3], card_fed[4]],
                         "rule_holds": card_fed[0]}},
        match_min=BF16_CPU_MATCH_MIN, conv_max_differ_share=conv_share,
        timing="host clock after torch.cuda.synchronize(); peak: "
               "max_memory_allocated in a warm detect of image 0; split: "
               "torch.profiler over two detects, per detect")
    say("bf16_detect_many", images=len(dm_images), max_batch=4,
        match_min=BF16_MATCH_MIN,
        wall_s=many_wall, images_per_s=len(dm_images) / many_wall,
        max_memory_allocated_bytes=many_peak, launches=many_counts,
        rule_holds=[r[0] for r in many_rules],
        loose=[[r[1], r[2]] for r in many_rules],
        strict=[[r[3], r[4]] for r in many_rules],
        count_diffs=[len(a) - len(b) for a, b in zip(many, singles)],
        reference="per-image bf16 detect")
    say("bf16_serve", dets=int(len(served)), latency_s=served_s,
        rows_match_detect=served_ok)
    if not (all(p["checks_ok"] for p in per_image) and deterministic
            and counts == want and split["device_ms"]["k1"] > 0
            and split["device_ms"]["conv"] > 0 and card_cpu[0]):
        raise AssertionError("the bf16 detect fails its checks")
    if not (all(r[0] for r in many_rules) and served_ok
            and many_counts["fused_stem"] > 0
            and many_counts["bbox_vote"] > 0):
        raise AssertionError("bf16 detect_many or the bf16 service "
                             "disagrees or missed a kernel")
    return counts, many_counts


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
                      "route_writes": stem.fused_stem.route_writes,
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
    if counts != {"fused_stem": 1, "route_writes": 1, "fused_stem_grad": 1,
                  "max_iou": 1}:
        raise AssertionError(f"full-tree step launches: {counts}")
    if not all(math.isfinite(r) and r <= GRAD_TOL[True]
               for r in ratio.values()):
        raise AssertionError("K2's conv1 gradients disagree in the step")
    torch.cuda.empty_cache()
    return counts


class _InlineExecutor:
    """A ThreadPoolExecutor stand-in that runs each job at submit: the
    training loop's serial order (``train_prefetch``)."""

    def __init__(self, *args, **kwargs):
        pass

    def submit(self, fn, *args, **kwargs):
        from concurrent.futures import Future
        fut = Future()
        fut.set_result(fn(*args, **kwargs))
        return fut

    def shutdown(self, *args, **kwargs):
        pass


class _TrainingClock:
    """Host clocks around the training loop's parts, set up by patching
    the names ``train_net`` looks up at call time, and restored on exit:
    the loader's draws (``RoIDataLoader.plan_minibatch``) and renders
    (``train_loop.render_minibatch``) per image, the prefetch worker's
    whole job per batch and the main thread's wait for it (the executors
    ``train_loop.ThreadPoolExecutor`` makes), the main thread's time to
    queue a step (``grad_step`` and ``solver.apply_update``), and the
    snapshot writes. ``inline``: the executors run each job at submit
    (the serial order), and the worker's job and the wait go untimed."""

    def __init__(self, inline=False):
        from concurrent.futures import ThreadPoolExecutor
        self.spent = {"draw": [], "render": [], "worker": [], "wait": [],
                      "queue": [], "save": 0.0, "first_draw": None}
        self._depth = 0
        spent = self.spent

        class TimedExecutor(ThreadPoolExecutor):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                self.timed = kwargs.get("thread_name_prefix") == \
                    "shf-prefetch"

            def submit(self, fn, *args, **kwargs):
                if not self.timed:
                    return super().submit(fn, *args, **kwargs)

                def job():
                    t = time.perf_counter()
                    try:
                        return fn(*args, **kwargs)
                    finally:
                        spent["worker"].append(time.perf_counter() - t)
                fut = super().submit(job)
                result = fut.result

                def timed_result(timeout=None):
                    t = time.perf_counter()
                    try:
                        return result(timeout)
                    finally:
                        spent["wait"].append(time.perf_counter() - t)
                fut.result = timed_result
                return fut

        self.executor = _InlineExecutor if inline else TimedExecutor

    def _timed(self, fn, key):
        spent = self.spent

        def run(*args, **kwargs):
            t = time.perf_counter()
            if key == "draw" and spent["first_draw"] is None:
                spent["first_draw"] = t
            try:
                return fn(*args, **kwargs)
            finally:
                spent[key].append(time.perf_counter() - t)
        return run

    def _timed_write(self, fn):
        def write(*args):
            t = time.perf_counter()
            self._depth += 1
            try:
                fn(*args)
            finally:
                self._depth -= 1        # _save_final calls _save
                if not self._depth:
                    self.spent["save"] += time.perf_counter() - t
        return write

    def __enter__(self):
        from smallhardface_tpu_torch.train import solver, train_loop
        from smallhardface_tpu_torch.train.loader import RoIDataLoader
        self._saved = [
            (RoIDataLoader, "plan_minibatch", self._timed, "draw"),
            (train_loop, "render_minibatch", self._timed, "render"),
            (train_loop, "grad_step", self._timed, "queue"),
            (solver, "apply_update", self._timed, "queue"),
            (train_loop, "_save", self._timed_write, None),
            (train_loop, "_save_final", self._timed_write, None),
            (train_loop, "ThreadPoolExecutor", None, None)]
        self._saved = [(obj, name, getattr(obj, name), wrap, key)
                       for obj, name, wrap, key in self._saved]
        for obj, name, orig, wrap, key in self._saved:
            if wrap is None:
                setattr(obj, name, self.executor)
            elif key is None:
                setattr(obj, name, wrap(orig))
            else:
                setattr(obj, name, wrap(orig, key))
        return self.spent

    def __exit__(self, *exc):
        for obj, name, orig, _, _ in self._saved:
            setattr(obj, name, orig)
        return False


def loader_split(cfg, roidb, seq):
    """Where a render's host time goes, and what rendering an iteration's
    images at once gains: the training run's plans (a fresh loader, the
    same scales) rendered one by one with the loader's steps timed
    (decode and flip, the distortion and its HSV round trip, the host
    downscale), then each iteration's pair on two threads, as
    ``train_net`` renders them."""
    from concurrent.futures import ThreadPoolExecutor
    from smallhardface_tpu_torch.train import loader
    size = int(cfg.TRAIN.ITERSIZE)
    ld = loader.RoIDataLoader(roidb)
    plans = [[ld.plan_minibatch(int(k)) for _ in range(size)] for k in seq]
    steps = {"_read_image": "decode", "apply_distortion": "distortion",
             "bgr_to_hsv": "hsv", "hsv_to_bgr": "hsv",
             "resize_linear": "downscale"}
    spent = {}
    saved = {name: getattr(loader, name) for name in steps}

    def timed(fn, key):
        def run(*args):
            t = time.perf_counter()
            try:
                return fn(*args)
            finally:
                spent[key] = spent.get(key, 0.0) + time.perf_counter() - t
        return run

    rows = []
    try:
        for name, key in steps.items():
            setattr(loader, name, timed(saved[name], key))
        for batch in plans:
            for plan in batch:
                spent.clear()
                t = time.perf_counter()
                loader.render_minibatch(plan)
                rows.append(dict({k: 1e3 * v for k, v in spent.items()},
                                 total=1e3 * (time.perf_counter() - t)))
    finally:
        for name, fn in saved.items():
            setattr(loader, name, fn)
    pair_ms = []
    with ThreadPoolExecutor(max_workers=size) as pool:
        for batch in plans:
            t = time.perf_counter()
            list(pool.map(loader.render_minibatch, batch))
            pair_ms.append(1e3 * (time.perf_counter() - t))
    serial = [sum(r["total"] for r in rows[i:i + size])
              for i in range(0, len(rows), size)]
    total = sum(r["total"] for r in rows)
    say("train_loader_split", images=len(rows),
        render_ms_per_image=[r["total"] for r in rows],
        share_of_render={k: sum(r.get(k, 0.0) for r in rows) / total
                         for k in ("decode", "distortion", "hsv",
                                   "downscale")},
        serial_ms_per_iteration=serial, parallel_ms_per_iteration=pair_ms,
        parallel_gain=sum(serial) / sum(pair_ms),
        cpu_count=os.cpu_count(),
        timing="host walls; hsv (the BGR<->HSV round trip) is part of "
               "distortion; the parallel pairs run after the serial pass")


def train_path(cfg, tdm, stem, iou, dev, work):
    """The slice's path: train_net at the flagship configuration, with its
    prefetch thread, then the same run in the serial order and a resume
    from the iteration-3 snapshot. The first run's split (``_TrainingClock``,
    host clocks; the device's busy time under torch.profiler, device events
    only): the worker's draws and renders per image and its job per batch,
    the main thread's wait for the fetch (the exposed loader) and its time
    to queue a step, the snapshot writes, the idle share and the iteration
    wall. Returns the launch counts of the first run."""
    from torch.profiler import ProfilerActivity, profile
    from smallhardface_tpu_torch.io import checkpoint
    from smallhardface_tpu_torch.train import train_loop
    from smallhardface_tpu_torch.utils.timer import device_busy_s
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
                     "hook_interval_s": now - clock["t"],
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
    with _TrainingClock() as spent:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            clock["t"] = t_start = time.perf_counter()
            model = train_loop.train_net(roidb, first, None, TRAIN_ITERS,
                                         device=dev, progress_hook=hook)
            torch.cuda.synchronize()
            train_wall = time.perf_counter() - t_start
    busy = device_busy_s(prof)
    size = int(cfg.TRAIN.ITERSIZE)
    ms = {k: [1e3 * v for v in spent[k]]
          for k in ("draw", "render", "worker", "wait")}
    queue_ms = [1e3 * (spent["queue"][i] + spent["queue"][i + 1])
                for i in range(0, len(spent["queue"]), 2)]
    setup = spent["first_draw"] - t_start
    loop = train_wall - setup - spent["save"]
    split = {"draw_ms_per_image": ms["draw"],
             "render_ms_per_image": ms["render"],
             "worker_ms_per_batch": ms["worker"],
             "worker_ms_per_iteration": sum(ms["worker"]) / TRAIN_ITERS,
             "exposed_wait_ms_per_iteration_each": ms["wait"],
             "exposed_wait_ms_per_iteration": sum(ms["wait"]) / TRAIN_ITERS,
             "queue_step_ms_per_iteration_each": queue_ms,
             "queue_step_ms_per_iteration": sum(queue_ms) / TRAIN_ITERS,
             "device_busy_ms_per_iteration": 1e3 * busy / TRAIN_ITERS,
             "iteration_wall_s": loop / TRAIN_ITERS,
             "setup_s": setup, "snapshot_writes_s": spent["save"],
             "device_busy_s": busy, "idle_share": 1.0 - busy / train_wall,
             "idle_share_iterations": 1.0 - busy / loop,
             "exposed_share_iterations": sum(ms["wait"]) / 1e3 / loop,
             "images_per_iteration": size,
             "timing": "host walls (perf_counter) in the worker and on the "
                       "main thread; the iteration wall is the run's less "
                       "its set-up and snapshot writes; device busy = union "
                       "of the device events under torch.profiler (device "
                       "activity only)"}
    counts = {"fused_stem": stem.fused_stem.launches,
              "route_writes": stem.fused_stem.route_writes,
              "fused_stem_grad": stem.fused_stem_grad.launches,
              "max_iou": iou.max_iou.launches}
    micro = TRAIN_ITERS * size
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
    # the loop hands an iteration's metrics to the hook one iteration late
    # (at once on a snapshot iteration), so the hook's intervals pair up
    # around snapshots; the run's wall is the number to read
    say("train_path", iterations=TRAIN_ITERS, micro_batches=micro,
        wall_s=train_wall, s_per_iteration=train_wall / TRAIN_ITERS,
        split=split,
        scales_visited=sorted({r["scale"] for r in rows}), launches=counts,
        losses_finite=all(math.isfinite(v) for v in losses),
        frozen_changed=frozen_moved, trainable_unchanged=trainable_still)
    if not all(math.isfinite(v) for v in losses) or len(rows) != TRAIN_ITERS:
        raise AssertionError("training losses are not all finite")
    if frozen_moved or trainable_still:
        raise AssertionError("frozen or trainable leaves misbehaved")
    if (counts["fused_stem"] != micro or counts["max_iou"] != micro
            or counts["fused_stem_grad"] != 0 or counts["route_writes"] != 0):
        raise AssertionError(f"training launches: {counts}")
    if (len(ms["worker"]) != TRAIN_ITERS or len(ms["render"]) != micro
            or split["exposed_wait_ms_per_iteration"]
            >= split["worker_ms_per_iteration"]):
        raise AssertionError("the loader did not overlap the steps")
    del model
    torch.cuda.empty_cache()

    # the serial order: the executors run each job at submit, so every
    # batch is built before its step is queued and no render runs beside
    # the main thread; then the thread again
    again = {}
    for key in ("inline", "thread"):
        out = os.path.join(work, f"run_{key}")
        os.makedirs(out)
        with _TrainingClock(inline=key == "inline") as spent:
            t0 = time.perf_counter()
            train_loop.train_net(roidb, out, None, TRAIN_ITERS, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        queue = 1e3 * sum(spent["queue"]) / TRAIN_ITERS
        again[key] = {
            "final_npz_bit_identical": _same_npz(
                os.path.join(first, "final.npz"),
                os.path.join(out, "final.npz")),
            "wall_s": wall, "snapshot_writes_s": spent["save"],
            "iteration_wall_s": (wall - (spent["first_draw"] - t0)
                                 - spent["save"]) / TRAIN_ITERS,
            "queue_step_ms_per_iteration": queue,
            "render_ms_per_image": 1e3 * sum(spent["render"]) / micro}
        torch.cuda.empty_cache()
    say("train_prefetch", iterations=TRAIN_ITERS, **again,
        timing="host walls, not under the profiler, after the profiled "
               "run; iteration wall = the run's less its set-up and "
               "snapshot writes")
    if not all(v["final_npz_bit_identical"] for v in again.values()):
        raise AssertionError("the threaded and the serial runs differ")
    loader_split(cfg, roidb, seq)

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


SPATIAL_TRAIN_K, SPATIAL_TRAIN_ITERS = 2, 3   # the flagship run over a unit
SPATIAL_GRAD_KS = (2, 4)    # the full-tree micro-batch and K4's backward
# the steps over a unit against one device. cuDNN sums the shards' shapes
# in another order, so not to the bit. Losses: the spatial forward's rtol
# 1e-4 (tests/test_torch_port_spatial.py). Weights: each leaf's update
# (final - init) within UPDATE_TOL of the leaf's largest update, frozen
# leaves equal to the bit. The random-init heads leave OHEM's negatives
# nearly tied, so the shards' last bits swap a few sampled anchors and the
# updates part by more than the sums' rounding: 1.06e-3 of the update
# peak (conv4_3/w), in two whole runs of this phase on an NVIDIA H100 80GB
# HBM3 at 700 W (an elementwise rtol 1e-3 + atol 1e-6 came to 0.89 of
# itself at weights near 0). A lost shard at k = 2 drops about half of
# every update, so it would read near 0.5: the limit sits between.
TRAIN_RTOL, UPDATE_TOL = 1e-4, 1e-2


def _k4_backward(stem, spatial, args, valid, k, dev):
    """K4's gradient over k shards of ``dev`` on (x, dy, w1, b1, w2, b2):
    the four weight gradients, with the forward kept for timing."""
    x, dy, *ws = args
    leaves = [w.detach().clone().requires_grad_() for w in ws]
    out = torch.cat(stem.fused_stem_spatial(spatial.split(x, [dev] * k),
                                            *leaves, valid_hw=valid), 1)
    grads = torch.autograd.grad(out, leaves, dy, retain_graph=True)
    return grads, out, leaves


def spatial_train(cfg, tdm, stem, iou, dev, work):
    """Spatial training on one card (``train_net`` over the unit ``[dev] *
    k``, one shard after another: exactness and overhead, no scaling):

    - SPATIAL_TRAIN_ITERS flagship iterations at k = SPATIAL_TRAIN_K
      beside the same run on one device, from the same init and data:
      losses within TRAIN_RTOL, each leaf's update within UPDATE_TOL of
      its peak, frozen leaves equal to the bit; each run
      under torch.profiler with its wall, device busy time, idle share,
      peak memory, halo bytes, and K1's launches per micro-batch (k over
      the unit, K2's 0: conv1 is frozen), the counts set to 0 just before
      each run and read just after;
    - the full-tree micro-batch of ``full_tree_grad`` (800 scale, every
      parameter taking a gradient) over k = SPATIAL_GRAD_KS: K1, its
      routing and K2 once per shard, K3 once; the conv1 gradients against
      one device's K2 within GRAD_TOL;
    - K4's backward alone at that micro-batch's shape and extent on the
      small-integer recipe: equal to the bit to one K2 over the whole
      image; its backward's wall, K2's device time per backward
      (torch.profiler) and the plain backward's time beside one K2's.

    Returns {"counts": full-tree launches per k, "k4": K4's backward entry
    fields, "flagship": the unit run's counts}. Fails after printing when a
    check does."""
    from torch.profiler import ProfilerActivity, profile
    from smallhardface_tpu_torch.io.weights import params_to_numpy
    from smallhardface_tpu_torch.parallel import spatial
    from smallhardface_tpu_torch.train import targets, train_loop
    from smallhardface_tpu_torch.train.loader import RoIDataLoader
    from smallhardface_tpu_torch.utils.timer import device_busy_s
    t_phase = time.perf_counter()
    failed = []
    fns = (stem.fused_stem, stem.fused_stem_grad, stem.fused_stem_spatial,
           iou.max_iou)

    def counts():
        return {"fused_stem": stem.fused_stem.launches,
                "route_writes": stem.fused_stem.route_writes,
                "fused_stem_grad": stem.fused_stem_grad.launches,
                "fused_stem_spatial": stem.fused_stem_spatial.launches,
                "max_iou": iou.max_iou.launches}

    # ---- the flagship run over a unit against one device ----
    _flagship(cfg)
    rng = np.random.RandomState(SEED + 4)
    roidb = face_roidb(rng, [(768, 1024), (1024, 768), (768, 1024),
                             (1024, 768)])
    micro = SPATIAL_TRAIN_ITERS * int(cfg.TRAIN.ITERSIZE)
    runs = {}
    for k in (1, SPATIAL_TRAIN_K):
        out = os.path.join(work, f"spatial_train_k{k}")
        os.makedirs(out)
        rows = []
        set_counts_zero(*fns)
        spatial.halo.bytes = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model = train_loop.train_net(
                roidb, out, None, SPATIAL_TRAIN_ITERS,
                device=dev if k == 1 else [dev] * k,
                progress_hook=lambda it, m: rows.append(np.concatenate(
                    [m["cls_loss"].ravel(), m["reg_loss"].ravel()])))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = device_busy_s(prof)
        runs[k] = {"losses": np.stack(rows),
                   "params": params_to_numpy(model.tree()),
                   "wall_s": wall, "device_busy_s": busy,
                   "idle_share": 1.0 - busy / wall,
                   "max_memory_allocated_bytes":
                       torch.cuda.max_memory_allocated(),
                   "halo_bytes_per_micro_batch": spatial.halo.bytes / micro,
                   "launches": counts()}
        del model, prof
        torch.cuda.empty_cache()
    one, unit = runs[1], runs[SPATIAL_TRAIN_K]
    loss_err = float(np.max(np.abs(unit["losses"] - one["losses"])
                            / np.abs(one["losses"])))
    worst, leaves, frozen_differ = 0.0, [], []
    init = params_to_numpy(tdm.init_params(
        torch.Generator().manual_seed(int(cfg.RNG_SEED)), tdm.build_spec(cfg)))
    for name, leaf in one["params"].items():
        for key, v in leaf.items():
            diff = float(np.abs(unit["params"][name][key] - v).max())
            update = float(np.abs(v - init[name][key]).max())
            if update == 0.0:
                if diff:
                    frozen_differ.append(f"{name}/{key}")
                continue
            worst = max(worst, diff / update)
            leaves.append((diff / update, f"{name}/{key}", diff, update))
    leaves.sort(reverse=True)
    per_micro = {k: {name: c / micro for name, c in r["launches"].items()}
                 for k, r in runs.items()}
    say("spatial_train_flagship", k=SPATIAL_TRAIN_K,
        iterations=SPATIAL_TRAIN_ITERS, micro_batches=micro,
        devices=[str(dev)] * SPATIAL_TRAIN_K,
        losses_max_rel_err=loss_err, losses_rtol=TRAIN_RTOL,
        updates_worst_diff_over_peak=worst, updates_tol=UPDATE_TOL,
        worst_leaves=[dict(zip(("diff_over_update_peak", "leaf",
                                "max_abs_diff", "max_abs_update"), r))
                      for r in leaves[:4]],
        frozen_leaves_differ=frozen_differ,
        launches_per_micro_batch={str(k): v for k, v in per_micro.items()},
        **{f"k{k}": {f: r[f] for f in (
            "wall_s", "device_busy_s", "idle_share",
            "max_memory_allocated_bytes", "halo_bytes_per_micro_batch")}
           for k, r in runs.items()},
        timing="the whole train_net call (set-up and the snapshot writes "
               "included) on the host clock; device busy = union of the "
               "device events under torch.profiler")
    c = unit["launches"]
    if (loss_err > TRAIN_RTOL or worst > UPDATE_TOL or frozen_differ
            or c["fused_stem"] != SPATIAL_TRAIN_K * micro
            or c["fused_stem_spatial"] != SPATIAL_TRAIN_K * micro
            or c["fused_stem_grad"] or c["route_writes"]
            or c["max_iou"] != micro or not unit["halo_bytes_per_micro_batch"]):
        failed.append("the flagship run over a unit")

    # ---- the full-tree micro-batch over units ----
    spec = tdm.build_spec(cfg)
    rng = np.random.RandomState(SEED + 3)
    sample = RoIDataLoader(face_roidb(rng, [(768, 1024)])).get_minibatch(1)
    arrays, _, bucket = train_loop.assemble_batch(
        [sample], 1, list(cfg.TPU.MAX_GT_BUCKETS))
    for key in ("data", "gt", "gt_mask"):
        arrays[key] = torch.from_numpy(arrays[key]).to(dev)
    params = tdm.init_params(torch.Generator().manual_seed(SEED), spec)
    grads, tree_counts = {}, {}
    for k in (1,) + SPATIAL_GRAD_KS:
        model = tdm.Detector(params, spec, dev, trainable=True)
        for p in model.parameters():
            p.requires_grad_(True)
        loss_fn = train_loop.LossFn(targets.from_cfg(cfg), dev, [dev] * k)
        set_counts_zero(*fns)
        train_loop.grad_step(model, loss_fn, arrays, bucket[2:4], 1)
        torch.cuda.synchronize()
        tree_counts[k] = counts()
        grads[k] = {f"{name}/{key}": model.params[name][key].grad.clone()
                    for name in ("conv1_1", "conv1_2") for key in ("w", "b")}
        del model
    ratio = {k: max(((grads[k][n] - grads[1][n]).abs().max()
                     / grads[1][n].abs().max()).item() for n in grads[1])
             for k in SPATIAL_GRAD_KS}
    say("spatial_train_full_tree", scale=int(cfg.TRAIN.SCALES.SHORT_SIDE[1]),
        bucket=list(bucket), launches={str(k): v for k, v in
                                       tree_counts.items()},
        conv1_max_err_over_peak={str(k): v for k, v in ratio.items()},
        tol_over_peak=GRAD_TOL[True],
        reference="the same micro-batch on one device (one K1, one K2)")
    for k in SPATIAL_GRAD_KS:
        want = {"fused_stem": k, "route_writes": k, "fused_stem_grad": k,
                "fused_stem_spatial": k, "max_iou": 1}
        if tree_counts[k] != want or not ratio[k] <= GRAD_TOL[True]:
            failed.append(f"the full-tree micro-batch at k={k}")

    # ---- K4's backward alone: to the bit on integers, its times ----
    B, (H, W) = 1, bucket[2:4]
    vh, vw = (int(v) * 8 for v in arrays["valid_hw"][0])
    valid = (vh, vw)
    arrs = grad_inputs(np.random.RandomState(SEED + 17), (B, H, W, 3), valid,
                       integer=True)
    # dy is 0 beyond the valid pooled extent, where K2 reads none
    # (pallas_stem.py:520-525) and the plain autograd would
    arrs[1][:, (vh + 1) // 2:] = 0.0
    arrs[1][:, :, (vw + 1) // 2:] = 0.0
    args = [torch.from_numpy(a).to(dev, torch.float32) for a in arrs]
    x, dy, *ws = args
    _, route = stem._stem_kernel(x, *ws, valid, with_route=True)
    one_k2 = stem.fused_stem_grad(x, dy, *ws, valid_hw=valid, route=route)
    k2_call = lambda: stem.fused_stem_grad(  # noqa: E731
        x, dy, *ws, valid_hw=valid, route=route)
    k2_device = sum(kernel_ms(k2_call, GRAD_KERNELS).values())
    k4_rows, k4_entry = [], None
    for k in SPATIAL_GRAD_KS:
        got, out, leaves = _k4_backward(stem, spatial, args, valid, k, dev)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(got, one_k2))
        backward = lambda: torch.autograd.grad(  # noqa: E731
            out, leaves, dy, retain_graph=True)
        row = {"k": k, "bit_equal_to_one_k2": equal,
               "backward_ms": median_ms(backward, n=10),
               "backward_device_ms": sum(kernel_ms(
                   backward, GRAD_KERNELS).values())}
        run_plain = stem.fused_stem
        stem.fused_stem = (lambda x_, *a, valid_hw=None:
                           stem.fused_stem_reference(x_, *a, valid_hw))
        try:
            _, plain_out, plain_leaves = _k4_backward(stem, spatial, args,
                                                      valid, k, dev)
            # cuDNN's float32 algorithms need not sum exactly; in float64
            # without cuDNN every sum of these integers is
            with torch.backends.cudnn.flags(enabled=False):
                plain, _, _ = _k4_backward(stem, spatial,
                                           [a.double() for a in args],
                                           valid, k, dev)
        finally:
            stem.fused_stem = run_plain
        row["plain_bit_equal"] = all(
            torch.equal(a.double(), b) for a, b in zip(got, plain))
        row["plain_fp32_max_abs_diff"] = max(
            (a - b).abs().max().item() for a, b in zip(got, torch.autograd.grad(
                plain_out, plain_leaves, dy, retain_graph=True)))
        row["backward_plain_ms"] = median_ms(
            lambda: torch.autograd.grad(plain_out, plain_leaves, dy,
                                        retain_graph=True), n=5, warmup=1)
        # the bound of the function (K2 over the image, stem_grad_time's)
        # and, apart, that of the strips with their redundant halo rows
        for name, p in (("backward_bound", B * H * W),
                        ("backward_strips_bound",
                         B * (H + 2 * stem.TH * (k - 1)) * W)):
            row[f"{name}_ms"], row[f"{name}_by"] = split_bound_ms(
                4 * (3 * p + 64 * p // 4) + 64 * p // 4,
                2 * (2 * 27) * 64 * p, 2 * (2 * 576) * 64 * p)
        k4_rows.append(row)
        if not equal:
            failed.append(f"K4's backward at k={k} is not one K2's")
        if not row["plain_bit_equal"]:
            failed.append(f"K4's backward at k={k} is not the plain one")
        if k == SPATIAL_GRAD_KS[-1]:
            k4_entry = dict(row)
        del got, out, leaves, plain, plain_out, plain_leaves
    say("spatial_train_k4_backward", shape=[B, H, W, 3], valid_hw=valid,
        inputs="small integers", rows=k4_rows, one_k2_device_ms=k2_device,
        reference="one K2 over the whole image on K1's routing, and the "
                  "plain backward of the same strips in float64 (to the "
                  "bit on integers); plain_fp32_max_abs_diff: the plain "
                  "one in float32, whose time is given",
        timing="wall: median of 10 CUDA-event walls of the backward alone "
               "(autograd.grad over the kept graph); device: K2's five "
               "kernels under torch.profiler, per backward")
    del args, x, dy, ws, route, one_k2
    torch.cuda.empty_cache()
    say("spatial_train", seconds=time.perf_counter() - t_phase,
        note="one card: the shards run one after another; exactness and "
             "overhead, no scaling")
    if failed:
        raise AssertionError(f"spatial_train phase: {failed}")
    return {"counts": tree_counts, "k4": k4_entry,
            "flagship": unit["launches"]}


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


def _check_agreement(phase, card, cpu, **fields):
    """Print the golden tests' match rule between the card's and the CPU's
    detections; returns whether it holds."""
    fwd, bwd = _match_fraction(card, cpu), _match_fraction(cpu, card)
    ok = (min(fwd, bwd) >= MATCH_MIN and abs(len(card) - len(cpu))
          <= max(2, COUNT_SLACK * len(cpu)))
    say(phase, dets_gpu=len(card), dets_cpu=len(cpu), match_gpu_in_cpu=fwd,
        match_cpu_in_gpu=bwd, rule_holds=ok, **fields)
    return ok


def stem_per_detect(det, image, stem, n=3):
    """K1's device time in one warm ``detect`` of `image`: its launches'
    durations under torch.profiler, per detect, by kernel and summed.
    Returns the sum."""
    before = stem.fused_stem.launches
    ms = kernel_ms(lambda: det.detect(image, THRESH), STEM_KERNELS, n=n,
                   warmup=1)
    per_detect = (stem.fused_stem.launches - before) // (n + 1)
    say("stem_per_detect", image=0, launches_per_detect=per_detect,
        device_ms=ms, device_ms_sum=sum(ms.values()),
        timing=f"K1's kernels' durations in {n} detects under "
               "torch.profiler, per detect")
    return sum(ms.values())


def detect_split(det, image, nms_device, thresh, reps=3):
    """Where one image's detect goes, each stage timed on the host clock
    after a synchronisation, medians of reps: the pyramid (preprocess,
    forward, decode, merge), the top-VOTE_CAP selection, V1 and the copy of
    its rows; beside them the host path's copy of every kept row and its
    float64 vote."""
    from smallhardface_tpu_torch.detect import _host_vote, top_rows
    stages = {k: [] for k in ("pyramid", "top_rows", "vote_device",
                              "readback", "host_readback", "host_vote")}
    for _ in range(reps):
        torch.cuda.synchronize()
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        boxes, scores, keep = det.merged_candidates(image, THRESH)
        mark()
        dets, n = top_rows(boxes, scores, keep, det.vote_cap)
        mark()
        out, n_out = nms_device.bbox_vote_device(dets, n, thresh)
        mark()
        voted = out[:int(n_out)].cpu().numpy()
        mark()
        rows = torch.cat([boxes, scores[:, None]], 1)[keep].cpu().numpy()
        mark()
        host = _host_vote(rows)
        mark()
        for k, a, b in zip(stages, marks, marks[1:]):
            stages[k].append(b - a)
    say("detect_split", image=0, above_thresh=len(rows),
        voted_rows=len(voted), host_voted_rows=len(host),
        **{f"{k}_s": float(np.median(v)) for k, v in stages.items()},
        timing=f"host clock after torch.cuda.synchronize(), median of {reps}")


def vote_phase(det, images, nms_device, thresh):
    """V1 against its plain version on the card: integer boxes with dyadic
    scores (equal to the bit), the top-VOTE_CAP candidates of each image as
    the detection path votes them, and a crowd. Comparison launches: the
    wrapper's count is not read here. Returns V1's entry of the kernels
    line, timed on the first image's candidates."""
    from smallhardface_tpu_torch.detect import top_rows
    from smallhardface_tpu_torch.ops.vote_cases import (
        chain_dets, crowd_dets, integer_dets, one_cluster_dets)
    dev = det.device
    rng = np.random.RandomState(SEED + 6)
    cases = [("integer", torch.from_numpy(integer_dets(rng, 512)).to(dev),
              512, thresh)]
    for i, im in enumerate(images):
        boxes, scores, keep = det.merged_candidates(im, THRESH)
        dets, n = top_rows(boxes, scores, keep, det.vote_cap)
        cases.append((f"image{i}", dets, int(n), thresh))
    cases.append(("crowd", torch.from_numpy(crowd_dets(rng, 2048)).to(dev),
                  2048, thresh))
    # the longest chain (2048 singleton steps, no overlap) and one cluster
    # that takes all 2048 rows
    cases.append(("no_overlap", torch.from_numpy(chain_dets(2048)).to(dev),
                  2048, thresh))
    cases.append(("one_cluster", torch.from_numpy(one_cluster_dets(
        rng, 2048)).to(dev), 2048, thresh))
    # boxes spread over 200 centres, many short clusters, at the IoU
    # threshold 0.4 of tests/test_nms_device.py
    for v in (2048, 512):
        cases.append((f"scattered{v}", torch.from_numpy(crowd_dets(
            np.random.RandomState(1), v, centres=200, spread=40)).to(dev), v,
            0.4))
    entry, worst = None, 0.0
    for name, dets, n, thresh in cases:
        n_t = torch.tensor(n, dtype=torch.int32, device=dev)
        got, n_got = nms_device.bbox_vote_device(dets, n_t, thresh)
        want, n_want, steps, pairs = nms_device.greedy_steps(
            dets, n_t, thresh, vote=True)
        torch.cuda.synchronize()
        k = int(n_want)
        same_n = int(n_got) == k
        scores_equal = same_n and torch.equal(got[:k, 4], want[:k, 4])
        peak = float(dets[:n, :4].abs().max()) if n else 1.0
        err = float((got[:k, :4] - want[:k, :4]).abs().max()) if (
            same_n and k) else 0.0
        bit_equal = torch.equal(got, want)
        call = lambda: nms_device.bbox_vote_device(dets, n_t, thresh)  # noqa: E731
        ms = median_ms(call)
        device_ms = graph_ms(call, reps=20)
        plain_ms = median_ms(lambda: nms_device.bbox_vote_device_reference(
            dets, n_t, thresh), n=3, warmup=1)
        v = dets.shape[0]
        # each row read once and each output row written once; about 25
        # fp32 operations for each remaining row of each step
        bnd, by = bound_ms(40 * v + 8, 25 * pairs)
        say("vote_vs_plain", case=name, rows=v, candidates=n, iou_thresh=thresh,
            n_out=int(n_got), n_out_plain=k, clusters=steps,
            iou_pairs=pairs, bit_equal=bit_equal, scores_equal=scores_equal,
            max_abs_box_err=err, box_tol=VOTE_BOX_TOL * peak,
            kernel_ms=ms, device_ms=device_ms, plain_ms=plain_ms,
            us_per_cluster=1e3 * device_ms / max(steps, 1), bound_ms=bnd,
            bound_by=by, library_ms=None,
            timing="wall: median of 20 CUDA-event walls of one wrapper "
                   "call; device: 20 calls in one CUDA graph, median of 5 "
                   "replays, per call; plain: median of 3 walls")
        if not (same_n and scores_equal and err <= VOTE_BOX_TOL * peak):
            raise AssertionError(f"V1 disagrees with its plain version on "
                                 f"{name}")
        if name in ("integer", "no_overlap") and not bit_equal:
            raise AssertionError(f"V1 is not equal to the bit on {name}")
        if name.startswith("image"):
            worst = max(worst, err)
        if name == "image0":
            entry = {"name": "bbox_vote", "route": "cuda",
                     "source": "smallhardface_tpu_torch/csrc/vote.cu",
                     "replaces": "smallhardface_tpu/ops/nms_jax.py:70",
                     "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                     "bound_ms": bnd, "bound_by": by, "library_ms": None,
                     "clusters": steps}
    entry["max_abs_err"] = worst
    return entry


def pyramid_card_vs_cpu(params, spec, image, card, detector_cls):
    """The full five-level pyramid with flip of one image: the card's
    detections (from the detection phase) against the port's CPU path, by
    the golden tests' rule."""
    t = time.perf_counter()
    cpu = detector_cls(params, spec, "cpu").detect(image, THRESH)[0][0]
    ok = _check_agreement("pyramid_card_vs_cpu", card, cpu,
                          hw=list(image.shape[:2]),
                          cpu_seconds=time.perf_counter() - t)
    if not ok:
        raise AssertionError("the card's full pyramid disagrees with the "
                             "CPU path")


def detect_peak(det, image):
    """The device memory peak of one warm ``detect`` of `image` (after a
    first one), beside its wall."""
    det.detect(image, THRESH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    det.detect(image, THRESH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    say("detect_peak", image=0, wall_s=wall, max_memory_allocated_bytes=peak,
        limit_bytes=DETECT_PEAK_LIMIT)
    if peak >= DETECT_PEAK_LIMIT:
        raise AssertionError(f"a warm detect peaks at {peak} bytes")


def k1_batched_extents(stem, dev):
    """K1 on an 8-image batch with eight extents in one launch against its
    plain version (equal to the bit on the small-integer recipe, within
    RTOL on floats) and against eight single-image launches (equal to the
    bit), at a small shape on integers and at the 600 level's bucket
    (640×896) on floats, where it is timed beside the eight launches."""
    rng = np.random.RandomState(SEED + 8)
    for shape, integer in (((8, 64, 128, 3), True), ((8, 640, 896, 3), False)):
        B, H, W, _ = shape
        ext = [(int(rng.randint(0, H // 16 + 1)) * 16 - 2 * (i % 2),
                int(rng.randint(0, W // 16 + 1)) * 16) for i in range(B)]
        ext = [(max(h, 0), w) for h, w in ext]
        ext[0] = (H, W)
        x, _, *ws = grad_inputs(rng, shape, None, integer)
        args = [torch.from_numpy(a).to(dev, torch.float32) for a in [x] + ws]
        vh = torch.tensor([e[0] for e in ext], device=dev)
        vw = torch.tensor([e[1] for e in ext], device=dev)
        with torch.no_grad():
            got = stem.fused_stem(*args, valid_hw=(vh, vw))
            singles = [stem.fused_stem(args[0][i:i + 1].contiguous(),
                                       *args[1:], valid_hw=e)
                       for i, e in enumerate(ext)]
        same_singles = all(torch.equal(got[i:i + 1], one)
                           for i, one in enumerate(singles))
        fields = {}
        if integer:
            want = stem.fused_stem_reference(
                *[torch.from_numpy(a).to(dev) for a in [x] + ws], (vh, vw))
            ok = torch.equal(got.double(), want)
            fields["bit_equal_plain"] = ok
        else:
            want = stem.fused_stem_reference(*args, (vh, vw))
            scale = max(want.abs().max().item(), 1.0)
            bad = 0
            for i, (h, w) in enumerate(ext):
                g, r = got[i, :h // 2, :w // 2], want[i, :h // 2, :w // 2]
                bad += int(((g - r).abs() > RTOL * r.abs()
                            + RTOL * scale).sum())
            ok = bad == 0
            args_c = [a.contiguous() for a in args]
            fields.update(
                n_outside_tol=bad, rtol=RTOL,
                batched_device_ms=graph_ms(lambda: stem.fused_stem(
                    *args_c, valid_hw=(vh, vw)), reps=20),
                single_launches_device_ms=graph_ms(lambda: [
                    stem.fused_stem(args_c[0][i:i + 1], *args_c[1:],
                                    valid_hw=e)
                    for i, e in enumerate(ext)], reps=5))
        say("k1_batched_extents", shape=list(shape), extents=ext,
            inputs="small integers" if integer else "floats",
            bit_equal_single_launches=same_singles, **fields,
            timing="device: calls in one CUDA graph, median of 5 replays, "
                   "per call")
        if not (ok and same_singles):
            raise AssertionError(f"K1 with per-image extents disagrees at "
                                 f"{shape}")
        del args, got, want, singles
    torch.cuda.empty_cache()


def v1_batched(det, images, nms_device, thresh):
    """V1 over the three detection images' real top-VOTE_CAP candidate sets
    as one launch, equal to the bit to three single launches, with its
    device time beside theirs. Comparison launches."""
    from smallhardface_tpu_torch.detect import top_rows
    sets = []
    for im in images:
        boxes, scores, keep = det.merged_candidates(im, THRESH)
        sets.append(top_rows(boxes, scores, keep, det.vote_cap))
    v = max(d.shape[0] for d, _ in sets)        # rows beyond n are not read
    sets = [(torch.nn.functional.pad(d, (0, 0, 0, v - d.shape[0])), c)
            for d, c in sets]
    dets = torch.stack([d for d, _ in sets]).contiguous()
    n = torch.stack([c for _, c in sets]).contiguous()
    got, n_got = nms_device.bbox_vote_device(dets, n, thresh)
    singles = [nms_device.bbox_vote_device(d, c, thresh) for d, c in sets]
    torch.cuda.synchronize()
    same = all(torch.equal(o, got[i]) and int(c) == int(n_got[i])
               for i, (o, c) in enumerate(singles))
    batched_ms = graph_ms(lambda: nms_device.bbox_vote_device(
        dets, n, thresh), reps=20)
    single_ms = [graph_ms(lambda d=d, c=c: nms_device.bbox_vote_device(
        d, c, thresh), reps=20) for d, c in sets]
    say("v1_batched", images=len(images), rows=list(dets.shape[:2]),
        candidates=n.tolist(), n_out=n_got.tolist(),
        bit_equal_single_launches=same, batched_device_ms=batched_ms,
        single_device_ms=single_ms, single_device_ms_sum=sum(single_ms),
        timing="20 calls in one CUDA graph, median of 5 replays, per call")
    if not same:
        raise AssertionError("V1 batched disagrees with single launches")
    return batched_ms


def _rule(a, b, min_match):
    """Counts within max(2, 2 %) and each side matched at min_match."""
    fwd, bwd = _match_fraction(a, b), _match_fraction(b, a)
    return (abs(len(a) - len(b)) <= max(2, COUNT_SLACK * len(b))
            and min(fwd, bwd) >= min_match), fwd, bwd


def detect_many_phase(det, stem, nms_device):
    """The slice's main path: ``detect_many`` on eight seeded synthetic
    WIDER-sized images (width 1024; DM_HEIGHTS make a bucket group of four,
    one of three and one of one) at max_batch 1, 2 and 4, against
    per-image ``detect`` on the card, with images per second and peak
    memory beside sequential ``detect`` and test_net's three-in-flight
    pipeline. The launch counts of the first max_batch 4 run are read.
    Returns them."""
    from collections import deque
    from smallhardface_tpu_torch.test_runner import PIPELINE_DEPTH
    rng = np.random.RandomState(SEED + 9)
    images = [make_image(rng, h, 1024) for h in DM_HEIGHTS]
    keys = [det._prep(im)["key"] for im in images]
    groups = sorted(sum(k == key for k in keys) for key in set(keys))
    if groups[-1] < 4 or len(groups) < 2:
        raise AssertionError(f"detect_many's images form groups {groups}")

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, torch.cuda.max_memory_allocated()

    def pipelined():
        out, pending = [None] * len(images), deque()
        for i, im in enumerate(images):
            pending.append((i, det.detect_async(im, THRESH)))
            if len(pending) > PIPELINE_DEPTH:
                j, h = pending.popleft()
                out[j] = det.finalize_async(h, THRESH)[0]
        while pending:
            j, h = pending.popleft()
            out[j] = det.finalize_async(h, THRESH)[0]
        return out

    singles = [det.detect(im, THRESH)[0][0] for im in images]   # warm
    runs = {"sequential": lambda: [det.detect(im, THRESH)[0][0]
                                   for im in images],
            "pipelined_3": pipelined}
    for mb in DM_MAX_BATCH:
        runs[f"max_batch_{mb}"] = lambda mb=mb: [
            d[0] for d in det.detect_many(images, THRESH, max_batch=mb)]
    stats, counts, worst = {}, None, 0
    for name, fn in runs.items():
        fn()                                                   # warm
        if name == f"max_batch_{DM_MAX_BATCH[-1]}":
            set_counts_zero(stem.fused_stem, nms_device.bbox_vote_device,
                            nms_device.nms_device)
            fn()
            counts = {"fused_stem": stem.fused_stem.launches,
                      "route_writes": stem.fused_stem.route_writes,
                      "bbox_vote": nms_device.bbox_vote_device.launches,
                      "nms": nms_device.nms_device.launches}
        walls, peaks = [], []
        for _ in range(2):
            out, wall, peak = timed(fn)
            walls.append(wall)
            peaks.append(peak)
        stats[name] = {"walls_s": walls,
                       "images_per_s": len(images) / min(walls),
                       "max_memory_allocated_bytes": max(peaks)}
        if name.startswith("max_batch"):
            diffs, ok, fwd, bwd = [], True, 1.0, 1.0
            for a, b in zip(out, singles):
                good, f, bk = _rule(a, b, DM_MATCH_MIN)
                ok, fwd, bwd = ok and good, min(fwd, f), min(bwd, bk)
                diffs.append(len(a) - len(b))
            stats[name].update(rule_holds=ok, min_match_batched_in_single=fwd,
                               min_match_single_in_batched=bwd,
                               count_diffs=diffs)
            worst = max(worst, max(abs(d) for d in diffs))
            if not ok:
                raise AssertionError(f"detect_many at {name} disagrees with "
                                     "per-image detect")
    groups_of = {mb: sum(-(-keys.count(k) // mb) for k in set(keys))
                 for mb in DM_MAX_BATCH}
    want = {"fused_stem": len(det._prep(images[0])["levels"])
            * groups_of[DM_MAX_BATCH[-1]],
            "route_writes": 0, "bbox_vote": groups_of[DM_MAX_BATCH[-1]],
            "nms": 0}
    say("detect_many", heights=list(DM_HEIGHTS), width=1024,
        group_sizes=groups, dets_per_image=[len(d) for d in singles],
        largest_count_diff=worst, match_min=DM_MATCH_MIN,
        launches=counts, launches_expected=want, **stats,
        timing="host clock after torch.cuda.synchronize(), all 8 images, "
               "after a warm run; peak: max_memory_allocated in the run")
    if counts != want:
        raise AssertionError(f"detect_many launches {counts}, expected "
                             f"{want}")
    return counts, images


def serve_phase(params, spec, images, dev):
    """DetectorService on the card behind serve() on 127.0.0.1:0: healthz,
    four concurrent requests to a micro-batching service against a
    per-request one (the same counts, every row matched), a bad body (400),
    and the median request latency of each."""
    import threading
    import urllib.error
    import urllib.request
    import cv2
    from smallhardface_tpu_torch import serve as serve_mod
    bodies = [cv2.imencode(".png", im)[1].tobytes() for im in images[:4]]

    def start(**kwargs):
        service = serve_mod.DetectorService(params, spec, device=dev,
                                            **kwargs)
        service.warmup()
        srv = serve_mod.serve(service, "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv, f"http://127.0.0.1:{srv.server_address[1]}"

    def post(url, body):
        t = time.perf_counter()
        req = urllib.request.Request(url + f"/detect?thresh={THRESH}",
                                     data=body, method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            payload = json.loads(r.read())
        return np.asarray(payload["detections"], np.float32).reshape(
            -1, 5), time.perf_counter() - t

    def concurrent(url):
        post(url, bodies[0])                                   # warm
        got = [None] * len(bodies)

        def hit(i):
            got[i] = post(url, bodies[i])
        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return got

    servers = []
    try:
        plain, url_plain = start()
        servers.append(plain)
        batched, url_batched = start(batch_window_ms=SERVE_WINDOW_MS,
                                     max_batch=4)
        servers.append(batched)
        with urllib.request.urlopen(url_batched + "/healthz") as r:
            health = json.loads(r.read())
        want = concurrent(url_plain)
        got = concurrent(url_batched)
        try:
            urllib.request.urlopen(urllib.request.Request(
                url_batched + "/detect", data=b"not an image",
                method="POST"), timeout=600)
            bad_code = 200
        except urllib.error.HTTPError as e:
            bad_code = e.code
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
    same = [len(a) == len(b) and _match_fraction(a, b) == 1.0
            and _match_fraction(b, a) == 1.0
            for (a, _), (b, _) in zip(got, want)]
    say("serve", healthz=health, bad_body_status=bad_code,
        counts_batched=[len(a) for a, _ in got],
        counts_per_request=[len(b) for b, _ in want],
        every_row_matched_each_way=same, batch_window_ms=SERVE_WINDOW_MS,
        latency_s_batched=[t for _, t in got],
        latency_s_per_request=[t for _, t in want],
        median_latency_s_batched=float(np.median([t for _, t in got])),
        median_latency_s_per_request=float(np.median([t for _, t in want])),
        timing="host clock around each HTTP request, four at once")
    if not (health.get("backend") == "cuda" and health.get("status") == "ok"
            and bad_code == 400 and all(same)):
        raise AssertionError("the service's batched responses differ from "
                             "its per-request ones, or its checks fail")


def cliff_map(dev, dtype=torch.float32):
    """Every 3×3 convolution of the forward, as the forward runs it
    (``layers.conv3x3``), at each distinct shape of the pyramid levels of
    five WIDER-sized images, exact and bucketed, at batch 2, 4 and 8
    (``tools/conv_map.py``), on ``dtype`` inputs: its device time beside
    its bound in that dtype (fp32 on the CUDA cores, bf16 on the tensor
    cores) and the memory it adds. The rows go to output/cliff_map.json
    (cliff_map_bf16.json); the line gives each layer's worst, the shapes
    over the limits, the slowest shapes against their bound and the
    largest ``conv4_fuse_final_dim_red`` shape. Fails where a convolution
    adds more than CLIFF_MAX_ADDED bytes, or, in fp32, where one whose
    bound is at least CLIFF_FLOOR_MS takes more than CLIFF_MAX_OF_BOUND
    times its bound (bf16 reports that share and holds the memory only);
    in bf16 also where a shape's outputs differ from the fp32 sum of the
    same bf16 products rounded once beyond BF16_CONV_MAX_DIFFER or their
    bound (``conv_map.bf16_vs_fp32``)."""
    from smallhardface_tpu_torch.models import layers
    from smallhardface_tpu_torch.tools import conv_map
    bf16 = dtype == torch.bfloat16
    t = time.perf_counter()
    rows = conv_map.conv_map(dev, log=lambda row: None, dtype=dtype)
    phase = "cliff_map_bf16" if bf16 else "cliff_map"
    with open(os.path.join(_output_dir(), phase + ".json"), "w") as f:
        json.dump(rows, f)
    layers_worst = {}
    for r in rows:
        for name in r["layers"]:
            w = layers_worst.setdefault(name, {"of_bound": 0.0,
                                               "added_bytes": 0})
            w["of_bound"] = max(w["of_bound"], r["of_bound"])
            w["added_bytes"] = max(w["added_bytes"], r["added_bytes"])
    over = [r for r in rows if r["added_bytes"] > CLIFF_MAX_ADDED or (
        not bf16 and r["bound_ms"] >= CLIFF_FLOOR_MS
        and r["of_bound"] > CLIFF_MAX_OF_BOUND) or (
        bf16 and (r["differ_share"] > BF16_CONV_MAX_DIFFER
                  or r["max_err_over_bound"] > 1.0))]
    numerics = {} if not bf16 else {
        "max_differ_share": max(r["differ_share"] for r in rows),
        "max_err_over_bound": max(r["max_err_over_bound"] for r in rows),
        "limit_differ_share": BF16_CONV_MAX_DIFFER,
        "reference": "fp32 cuDNN (TF32 off) on the same bf16 values, "
                     "rounded to bf16 once"}
    floor = [r for r in rows if r["bound_ms"] < CLIFF_FLOOR_MS]
    above = [r for r in rows if r["bound_ms"] >= CLIFF_FLOOR_MS]
    cliff = [r for r in rows if r["shape"] == [2, 512, 128, 176, 234, 1]]
    worst = sorted(above, key=lambda r: -r["of_bound"])[:5]
    say(phase, shapes=len(rows), seconds=time.perf_counter() - t,
        dtype=str(dtype).split(".")[1], taps_min_flop=layers.TAPS_MIN_FLOP,
        max_of_bound_above_floor=max((r["of_bound"] for r in above),
                                     default=0.0),
        worst_of_bound_above_floor=[
            {k: r[k] for k in ("shape", "layers", "ms", "bound_ms",
                               "of_bound", "added_bytes")} for r in worst],
        max_of_bound=max(r["of_bound"] for r in rows),
        max_added_bytes=max(r["added_bytes"] for r in rows),
        sum_device_ms=sum(r["ms"] for r in rows), by_layer=layers_worst,
        conv4_fuse_final_dim_red_176x234=cliff,
        under_floor={"shapes": len(floor),
                     "over_limit": sum(r["of_bound"] > CLIFF_MAX_OF_BOUND
                                       for r in floor),
                     "max_of_bound": max((r["of_bound"] for r in floor),
                                         default=0.0),
                     "max_ms": max((r["ms"] for r in floor), default=0.0)},
        over_limits=over, limit_of_bound=CLIFF_MAX_OF_BOUND, **numerics,
        limit_added_bytes=CLIFF_MAX_ADDED, floor_bound_ms=CLIFF_FLOOR_MS,
        timing="device: calls in one CUDA graph, median of 3 replays; "
               "bound: 2·B·H·W·9·C·O FLOP at "
               + ("989 TFLOP/s (bf16)" if bf16 else "67 TFLOP/s")
               + " or the bytes at 3.35 TB/s, the larger")
    if over or not cliff:
        raise AssertionError(f"{len(over)} convolutions of the map are over "
                             "its limits")


SPATIAL_KS = (2, 4)         # units of the spatial phase, on one card
# K4 against one K1: the largest level at batch 2, whole and with a valid
# height inside shard 2 of 4 (rows 704..1055) and shard 1 of 2
SPATIAL_STEM = (((2, 1408, 1872, 3), None), ((2, 1408, 1872, 3), (1000, 1800)))
SPATIAL_RTOL, SPATIAL_ATOL = 1e-4, 1e-3     # tests/test_spatial_shard.py:52


def _rows_close(a, b, rtol, atol):
    """(holds, largest |Δ|): a and b hold as many rows, and each row of a,
    in descending score order, has a distinct partner in b within
    atol + rtol·|b| in every column, the nearest one not yet taken (the
    matching of tests/test_spatial_shard.py:104-111; a sort by columns
    would split rows whose scores tie to the last bits)."""
    if a.shape != b.shape:
        return False, None
    taken = np.zeros(len(b), bool)
    worst = 0.0
    for row in a[np.argsort(-a[:, 4], kind="stable")]:
        d = np.abs(b - row)
        over = (d - rtol * np.abs(b) - atol).max(axis=1)
        over[taken] = np.inf
        j = int(np.argmin(over))
        if over[j] > 0:
            return False, float(d[j].max())
        taken[j] = True
        worst = max(worst, float(d[j].max()))
    return True, worst


def spatial_phase(cfg, tdm, params, images, det, fp32_dets, dev, stem,
                  nms_device, conv_int8):
    """Spatial H-sharding of detection on one card, its shards run one
    after another on ``dev`` repeated k = 2 and 4 times (exactness, halo
    routing and overhead; no scaling follows from one card):

    - K4 (``ops/stem.fused_stem_spatial``) against one K1 over the whole
      image at SPATIAL_STEM, pooled rows equal to the bit, and against the
      plain stem within RTOL; at the whole shape its wall, device time
      (CUDA graph) and the plain K4's time beside one K1's, with the
      redundant halo rows and the strips' bound;
    - the 3×3 convolutions at the shard shapes of image 0's five levels
      (``tools/conv_map.shard_convs``): those below TAPS_MIN_FLOP (cuDNN's)
      timed for the FFT cliff, against CLIFF_MAX_ADDED and
      CLIFF_MAX_OF_BOUND;
    - fp32 ``detect`` of image 0 over each unit against the one-device
      ``detect`` (``fp32_dets``), sorted rows at SPATIAL_RTOL / ATOL: warm
      wall, device time and idle share (torch.profiler), peak memory, K1's
      launches (5·k), V1's and the halo bytes per ``detect``; the counts
      set to 0 just before and read just after;
    - calibrated int8 and bf16 at k = 2 against their one-device runs, by
      the rules ``detect_many`` is held to in those precisions;
    - the command line's and the service's refusal of a unit of 2 on a
      one-card machine.

    Returns K4's entry of the kernels line. Fails after printing when a
    check does."""
    from smallhardface_tpu_torch import serve as serve_mod
    from smallhardface_tpu_torch import test_runner
    from smallhardface_tpu_torch.config import CONFIG_DIR, cfg_from_file
    from smallhardface_tpu_torch.detect import TorchDetector
    from smallhardface_tpu_torch.models import layers
    from smallhardface_tpu_torch.parallel import spatial
    from smallhardface_tpu_torch.tools import conv_map
    t_phase = time.perf_counter()
    failed = []
    snapshot = copy.deepcopy(cfg)

    # ---- K4 against one K1 ----
    rng = np.random.RandomState(SEED + 16)
    entry = None
    for shape, valid in SPATIAL_STEM:
        x, w1, b1, w2, b2 = stem_inputs(rng, shape, valid, dev)
        ws = (w1, b1, w2, b2)
        B, H, W, _ = shape
        with torch.no_grad():
            whole = stem.fused_stem(x, *ws, valid_hw=valid)
            plain = stem.fused_stem_reference(x, *ws, valid)
            vh, vw = valid or (H, W)
            for k in SPATIAL_KS:
                shards = spatial.split(x, [dev] * k)
                k4 = lambda: stem.fused_stem_spatial(  # noqa: E731
                    shards, *ws, valid_hw=valid)
                got = torch.cat(k4(), 1)
                torch.cuda.synchronize()
                equal = torch.equal(got, whole)
                err = (got - plain)[:, :vh // 2, :vw // 2].abs()
                peak = plain[:, :vh // 2, :vw // 2].abs().max().item()
                fields = {}
                if valid is None:
                    run_plain = stem.fused_stem

                    def plain_k4():
                        stem.fused_stem = (  # noqa: E731
                            lambda x_, *a, valid_hw=None:
                            stem.fused_stem_reference(x_, *a, valid_hw))
                        try:
                            return k4()
                        finally:
                            stem.fused_stem = run_plain
                    extra = 2 * stem.TH * (k - 1)
                    p = B * (H + extra) * W
                    strips_bound, _ = split_bound_ms(
                        4 * (3 * p + 64 * B * H * W // 4), 2 * 27 * 64 * p,
                        2 * 576 * 64 * p)
                    fields = dict(
                        ms=median_ms(k4), device_ms=graph_ms(k4, reps=5),
                        k1_device_ms=graph_ms(
                            lambda: stem.fused_stem(x, *ws), reps=5),
                        plain_ms=median_ms(plain_k4, n=5, warmup=1),
                        redundant_rows=extra,
                        redundant_share=extra / H,
                        strips_bound_ms=strips_bound)
                say("spatial_k4", shape=list(shape), valid_hw=valid, k=k,
                    bit_equal_to_one_k1=equal, max_abs_err_vs_plain=err.max(
                    ).item(), max_abs_ref=peak, rtol=RTOL,
                    atol=f"{RTOL}*max|ref|", **fields)
                if not equal or (err > RTOL * plain[
                        :, :vh // 2, :vw // 2].abs() + RTOL * peak).any():
                    failed.append(f"K4 k={k} at {shape} valid {valid}")
                if valid is None and k == SPATIAL_KS[-1]:
                    n_bytes = 4 * (3 * B * H * W + 64 * B * H * W // 4)
                    bnd, by = split_bound_ms(n_bytes, 2 * 27 * 64 * B * H * W,
                                             2 * 576 * 64 * B * H * W)
                    entry = {
                        "name": "fused_stem_spatial", "route": "cuda",
                        "source": "smallhardface_tpu_torch/csrc/stem.cu",
                        "wrapper": "smallhardface_tpu_torch/ops/stem.py:"
                                   "fused_stem_spatial",
                        "replaces": "smallhardface_tpu/ops/pallas_stem.py:250",
                        "k": k, "max_abs_err": err.max().item(),
                        "max_abs_err_vs_one_k1": (got - whole).abs().max(
                        ).item(),
                        "ms": fields["ms"], "device_ms": fields["device_ms"],
                        "plain_ms": fields["plain_ms"], "bound_ms": bnd,
                        "bound_by": by, "library_ms": None}
        del x, whole, plain, got, shards
        torch.cuda.empty_cache()

    # ---- the cuDNN cliff at the shard shapes ----
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shapes = {}
    for li, (hb, wb) in enumerate(conv_map.level_shapes(IMAGE_SIZES[0])):
        for k in SPATIAL_KS:
            for name, c, o, h, w, d, halo in conv_map.shard_convs(hb, wb, k):
                shapes.setdefault((2, c, o, h, w, d, halo), []).append(
                    f"L{li}/k{k}/{name}")
    rows, n_taps = [], 0
    with torch.inference_mode():
        for (B, c, o, h, w, d, halo), where in shapes.items():
            h_out = h - sum(halo)
            if 18.0 * B * h_out * w * c * o >= layers.TAPS_MIN_FLOP:
                n_taps += 1
                continue
            x, wt, bias = conv_map.inputs((B, c, o, h, w, d), dev, gen)
            first, wall, device, added = conv_map.time_call(
                lambda: layers.conv3x3(x, wt, bias, dilation=d, halo=halo))
            bnd = conv_map.bound_ms(B, c, o, h_out, w)[0]
            rows.append({"shape": [B, c, o, h, w, d], "halo": list(halo),
                         "where": where, "ms": device, "bound_ms": bnd,
                         "of_bound": device / bnd, "added_bytes": added,
                         "first_ms": first})
            del x, wt, bias
    torch.cuda.empty_cache()
    over = [r for r in rows if r["added_bytes"] > CLIFF_MAX_ADDED or (
        r["bound_ms"] >= CLIFF_FLOOR_MS
        and r["of_bound"] > CLIFF_MAX_OF_BOUND)]
    say("spatial_cliff", image=0, ks=list(SPATIAL_KS),
        cudnn_shapes=len(rows), taps_shapes=n_taps,
        max_added_bytes=max(r["added_bytes"] for r in rows),
        max_of_bound=max(r["of_bound"] for r in rows),
        max_first_call_ms=max(r["first_ms"] for r in rows),
        worst=sorted(rows, key=lambda r: -r["of_bound"])[:4],
        over_limits=over, limit_added_bytes=CLIFF_MAX_ADDED,
        limit_of_bound=CLIFF_MAX_OF_BOUND, floor_bound_ms=CLIFF_FLOOR_MS,
        timing="conv_map.time_call: device from a CUDA graph")
    if over:
        failed.append(f"{len(over)} shard convolutions over the cliff limits")

    # ---- fp32 detection over each unit against one device ----
    fns = (stem.fused_stem, stem.fused_stem_spatial,
           nms_device.bbox_vote_device)
    one_split = detect_device_split(det, images[0], 1.0)
    k4_counts = {}
    for k in SPATIAL_KS:
        det_k = TorchDetector(params, tdm.build_spec(cfg),
                              spatial_devices=[dev] * k)
        det_k.detect(images[0], THRESH)                     # cold
        set_counts_zero(*fns)
        spatial.halo.bytes = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        dets = det_k.detect(images[0], THRESH)[0][0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        counts = {"fused_stem": stem.fused_stem.launches,
                  "fused_stem_spatial": stem.fused_stem_spatial.launches,
                  "bbox_vote": nms_device.bbox_vote_device.launches,
                  "halo_bytes": spatial.halo.bytes}
        k4_counts[k] = counts["fused_stem_spatial"]
        split = detect_device_split(det_k, images[0], wall * 1e3)
        close, diff = _rows_close(dets, fp32_dets, SPATIAL_RTOL,
                                  SPATIAL_ATOL)
        say("spatial_detect", image=0, k=k, devices=[str(dev)] * k,
            dets=int(dets.shape[0]), one_device_dets=int(fp32_dets.shape[0]),
            rows_close=bool(close), max_abs_diff_matched=diff,
            rtol=SPATIAL_RTOL, atol=SPATIAL_ATOL, wall_s=wall,
            device_ms=split["device_ms_sum"], device_split_ms=split[
                "device_ms"], idle_share=split["idle_share"],
            one_device_ms=one_split["device_ms_sum"],
            one_device_split_ms=one_split["device_ms"],
            max_memory_allocated_bytes=peak, launches=counts,
            timing="wall: one warm detect on the host clock; device: the "
                   "union-free sum of its kernels under torch.profiler, "
                   "per detect of 2")
        if not close or counts["fused_stem"] != 5 * k or counts[
                "fused_stem_spatial"] != 5 * k or counts["bbox_vote"] != 1:
            failed.append(f"spatial detect k={k}")
        del det_k
        torch.cuda.empty_cache()

    # ---- calibrated int8 and bf16 at k = 2 against one device ----
    cfg_from_file(os.path.join(CONFIG_DIR, "smallhardface-int8.toml"))
    cfg.TEST.SCALES = list(INT8_SCALES)
    cfg.TEST.FLIP = True
    cfg.TEST.NMS_METHOD = "BBOX_VOTE"
    spec = tdm.build_spec(cfg)
    one = TorchDetector(params, spec, dev)
    one.calibrate_int8(images[:1])
    sharded = TorchDetector(params, spec, spatial_devices=[dev] * 2)
    sharded.calibrate_int8(images[:1])
    scales_rel = max(abs(sharded.qstate["scales"][n]
                         / one.qstate["scales"][n] - 1.0)
                     for n in one.qstate["scales"])
    own = sharded.detect(images[0], THRESH)[0][0]
    # held on one qstate, as detect_many is held against detect: a grid
    # step that moves in its last bit moves every int8 value near a
    # rounding edge, and the chain triples such flips at every link
    sharded.qstate = one.qstate
    pair = []
    for d in (one, sharded):
        set_counts_zero(conv_int8.conv3x3_int8, *fns)
        pair.append((d.detect(images[0], THRESH)[0][0],
                     conv_int8.conv3x3_int8.launches,
                     stem.fused_stem_spatial.launches))
    del one, sharded
    good, fwd, bwd = _rule(pair[1][0], pair[0][0], INT8_MANY_MATCH_MIN)
    _, own_fwd, own_bwd = _rule(own, pair[0][0], 0.0)
    say("spatial_int8", image=0, k=2, dets=[len(p[0]) for p in pair],
        matched=[fwd, bwd], min_match=INT8_MANY_MATCH_MIN, holds=bool(good),
        q1_launches=[p[1] for p in pair], k4_launches=pair[1][2],
        calibration_max_rel_diff=scales_rel,
        own_calibration_dets=len(own),
        own_calibration_matched=[own_fwd, own_bwd],
        rule="detect_many's int8 rule: counts within max(2, 2 %), each "
             "side matched; on the one-device qstate (the spatial "
             "calibration's own detections printed, not bounded)")
    if not good or pair[1][1] != 2 * pair[0][1] or pair[1][2] != 10:
        failed.append("spatial int8")
    cfg.clear()
    cfg.update(copy.deepcopy(snapshot))
    cfg.TPU.PRECISION = "bfloat16"
    spec = tdm.build_spec(cfg)
    bf = [TorchDetector(params, spec, dev if unit is None else None,
                        spatial_devices=unit).detect(images[0], THRESH)[0][0]
          for unit in (None, [dev] * 2)]
    ok, lf, lb, sf, sb = _bf16_rule(bf[1], bf[0])
    say("spatial_bf16", image=0, k=2, dets=[len(b) for b in bf],
        loose_matched=[lf, lb], strict_matched=[sf, sb],
        min_match=BF16_MATCH_MIN, holds=bool(ok),
        rule="detect_many's bf16 rule (_bf16_rule)")
    if not ok:
        failed.append("spatial bf16")
    cfg.clear()
    cfg.update(copy.deepcopy(snapshot))

    # ---- the refusals of a unit of 2 on a one-card machine ----
    refusals = {}
    cfg.TPU.SPATIAL_DEVICES = 2
    for where, call in (
            ("test_net", lambda: test_runner.run_inference(
                None, params, None, THRESH, device=dev)),
            ("serve", lambda: serve_mod.DetectorService(
                params, tdm.build_spec(cfg), device=dev))):
        try:
            call()
            refusals[where] = None
        except ValueError as e:
            refusals[where] = str(e)
    cfg.clear()
    cfg.update(copy.deepcopy(snapshot))
    cards = torch.cuda.device_count()
    say("spatial_refusals", cards=cards, **refusals)
    if cards == 1 and not all(refusals.values()):
        failed.append("a unit of 2 on one card was not refused")
    say("spatial", seconds=time.perf_counter() - t_phase,
        k4_launches_per_detect={str(k): v for k, v in k4_counts.items()},
        note="one card: the shards run one after another; exactness and "
             "overhead, no scaling")
    if failed:
        raise AssertionError(f"spatial phase: {failed}")
    entry["launches"] = k4_counts[SPATIAL_KS[-1]]
    entry["launches_path"] = f"spatial_detect k={SPATIAL_KS[-1]}"
    entry["launches_k2"] = k4_counts[SPATIAL_KS[0]]
    return entry


def wider_tree(work):
    """The seeded synthetic WIDER tree (scripts/synth_wider.py) of the
    command-line phases, under ``work``."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import synth_wider
    root = os.path.join(work, "wider")
    synth_wider.build(root, n_images=EVAL_IMAGES, im_size=EVAL_SIZE,
                      seed=SEED)
    return root


def eval_cli(cfg, stem, iou, nms_device, root):
    """Train-then-test from the command line on the synthetic WIDER tree
    ``root``: the files and the result line it must give, the seconds per
    image of test_net and the launch counts; the same test with
    TPU.EVAL_BATCH 2, and with the run's final.caffemodel as TEST.MODEL
    (its weights and detections equal to final.npz's to the bit). Returns
    the counts."""
    from smallhardface_tpu_torch import __main__ as cli
    from smallhardface_tpu_torch import test_runner
    from smallhardface_tpu_torch.config import CONFIG_DIR
    from smallhardface_tpu_torch.io import caffemodel
    from smallhardface_tpu_torch.io.weights import load_params
    exp_dir = f"chip_smoke_eval_{os.getpid()}"
    stats = {}
    run_inference = test_runner.run_inference

    def timed(imdb, *args, **kwargs):
        t = time.perf_counter()
        dets = run_inference(imdb, *args, **kwargs)
        torch.cuda.synchronize()
        stats["test_net_s_per_image"] = (time.perf_counter() - t) / len(imdb)
        return dets

    fns = (stem.fused_stem, stem.fused_stem_grad, iou.max_iou,
           nms_device.bbox_vote_device, nms_device.nms_device)
    test_runner.run_inference = timed
    set_counts_zero(*fns)
    t = time.perf_counter()
    try:
        result = cli.main([
            "--train", "true", "--test", "true", "--device", "cuda",
            "--conf", os.path.join(CONFIG_DIR, "smallhardface.toml"),
            "--amend", "DATA_DIR", root, "EXP_DIR", exp_dir,
            "TRAIN.ITERS", str(EVAL_ITERS), "TEST.DB", "wider_val",
            "TEST.NO_CACHE", "False"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = dict(zip(("fused_stem", "fused_stem_grad", "max_iou",
                           "bbox_vote", "nms"), (f.launches for f in fns)))
        out = os.path.join(REPO, "output", exp_dir)
        found = {name: sorted(os.path.relpath(os.path.join(r, name), out)
                              for r, _, files in os.walk(out)
                              if name in files)
                 for name in ("final.npz", "final.caffemodel",
                              "detections.pkl", "result.tar.gz",
                              "cfgs.txt", "stderr.log")}
        first_stats = dict(stats)
        # the same weights and images again, with TPU.EVAL_BATCH 2
        with open(os.path.join(out, found["detections.pkl"][0]), "rb") as f:
            one_by_one = pickle.load(f)[1]
        set_counts_zero(*fns)
        batch_result = cli.main([
            "--train", "false", "--test", "true", "--device", "cuda",
            "--conf", os.path.join(CONFIG_DIR, "smallhardface.toml"),
            "--amend", "DATA_DIR", root, "EXP_DIR", exp_dir + "_batch",
            "TEST.DB", "wider_val", "TEST.NO_CACHE", "False",
            "TEST.MODEL", os.path.join(out, found["final.npz"][0]),
            "TPU.EVAL_BATCH", "2"])
        torch.cuda.synchronize()
        batch_counts = dict(zip(("fused_stem", "fused_stem_grad", "max_iou",
                                 "bbox_vote", "nms"),
                                (f.launches for f in fns)))
        batch_out = os.path.join(REPO, "output", exp_dir + "_batch")
        pkl, = [os.path.join(r, "detections.pkl")
                for r, _, files in os.walk(batch_out)
                if "detections.pkl" in files]
        with open(pkl, "rb") as f:
            batched = pickle.load(f)[1]
        batch_stats = dict(stats)
        # the trained weights through final.caffemodel: the same file
        # loaded, then the same test with it as TEST.MODEL
        npz = os.path.join(out, found["final.npz"][0])
        caffe = os.path.join(out, found["final.caffemodel"][0])
        from_npz = load_params(npz)
        from_caffe = caffemodel.load_into_params(caffe, from_npz,
                                                 strict=True)
        caffe_equal = all(torch.equal(from_caffe[n][k], v)
                          for n, leaf in from_npz.items()
                          for k, v in leaf.items())
        set_counts_zero(*fns)
        caffe_result = cli.main([
            "--train", "false", "--test", "true", "--device", "cuda",
            "--conf", os.path.join(CONFIG_DIR, "smallhardface.toml"),
            "--amend", "DATA_DIR", root, "EXP_DIR", exp_dir + "_caffemodel",
            "TEST.DB", "wider_val", "TEST.NO_CACHE", "False",
            "TEST.MODEL", caffe, "TPU.EVAL_BATCH", "1"])
        torch.cuda.synchronize()
        caffe_counts = dict(zip(("fused_stem", "bbox_vote"), (
            stem.fused_stem.launches, nms_device.bbox_vote_device.launches)))
        pkl, = [os.path.join(r, "detections.pkl") for r, _, files in
                os.walk(os.path.join(REPO, "output", exp_dir + "_caffemodel"))
                if "detections.pkl" in files]
        with open(pkl, "rb") as f:
            via_caffe = pickle.load(f)[1]
    finally:
        test_runner.run_inference = run_inference
        for d in (exp_dir, exp_dir + "_batch", exp_dir + "_caffemodel"):
            shutil.rmtree(os.path.join(REPO, "output", d), ignore_errors=True)
    micro = EVAL_ITERS * int(cfg.TRAIN.ITERSIZE)
    want = {"fused_stem": micro + len(cfg.TEST.SCALES) * EVAL_IMAGES,
            "fused_stem_grad": 0, "max_iou": micro, "bbox_vote": EVAL_IMAGES,
            "nms": 0}
    say("eval_cli", result=result, files=found, launches=counts,
        launches_expected=want, wall_s=wall, **first_stats)
    if not re.fullmatch(r"Easy: [0-9.]+, Medium: [0-9.]+, Hard: [0-9.]+",
                        str(result)):
        raise AssertionError(f"eval_cli gave no Easy/Medium/Hard line: "
                             f"{result!r}")
    if not all(found[n] for n in ("final.npz", "final.caffemodel",
                                  "detections.pkl", "result.tar.gz")):
        raise AssertionError(f"eval_cli is missing files: {found}")
    if counts != want:
        raise AssertionError(f"eval_cli launches {counts}, expected {want}")
    rules = [_rule(a, b, DM_MATCH_MIN) for a, b in zip(batched, one_by_one)]
    batches = EVAL_IMAGES // 2          # one bucket key: no image left over
    want = {"fused_stem": len(cfg.TEST.SCALES) * batches,
            "fused_stem_grad": 0, "max_iou": 0, "bbox_vote": batches,
            "nms": 0}
    say("eval_cli_eval_batch", eval_batch=2, result=batch_result,
        images=len(batched), rule_holds=[r[0] for r in rules],
        min_match=[min(r[1], r[2]) for r in rules],
        count_diffs=[len(a) - len(b) for a, b in zip(batched, one_by_one)],
        launches=batch_counts, launches_expected=want, **batch_stats)
    if len(batched) != EVAL_IMAGES or not all(r[0] for r in rules):
        raise AssertionError("EVAL_BATCH 2 detections differ from "
                             "EVAL_BATCH 1's")
    if batch_counts != want:
        raise AssertionError(f"eval_cli with EVAL_BATCH 2 launches "
                             f"{batch_counts}, expected {want}")
    same = (len(via_caffe) == len(one_by_one)
            and all(np.array_equal(a, b)
                    for a, b in zip(via_caffe, one_by_one)))
    want = {"fused_stem": len(cfg.TEST.SCALES) * EVAL_IMAGES,
            "bbox_vote": EVAL_IMAGES}
    say("eval_cli_caffemodel", model=found["final.caffemodel"][0],
        result=caffe_result, loads_equal_to_final_npz=caffe_equal,
        detections_equal_to_the_bit=same, launches=caffe_counts,
        launches_expected=want)
    if not (caffe_equal and same and caffe_result == result
            and caffe_counts == want):
        raise AssertionError("test_net through final.caffemodel differs "
                             "from final.npz's")
    return counts



# the first phase of auto_resume: a device-side assert from a plain torch
# op (an index out of range on the card), then the ops that follow it in
# the same process, each with its class, its message and the port's
# classifier. cuBLAS's and cuDNN's handles and K3's library are made
# before the fault, as in a training run; a matmul and a convolution in
# a new thread, whose handles are made after the fault, are printed too
STICKY_CODE = r"""
import json, threading, torch
from smallhardface_tpu_torch import __main__ as cli
from smallhardface_tpu_torch.ops import iou
dev = torch.device("cuda", 0)
iou.IOU.load()
anchors = torch.rand(256, 4, device=dev)
anchors[:, 2:] += anchors[:, :2]
gt = anchors[:8].clone()
mask = torch.ones(8, dtype=torch.bool, device=dev)
m = torch.randn(64, 64, device=dev)
x = torch.randn(1, 3, 16, 16, device=dev)
w = torch.randn(8, 3, 3, 3, device=dev)
m @ m
torch.nn.functional.conv2d(x, w)
torch.cuda.synchronize()
rows = []


def attempt(op, fn):
    try:
        fn()
        torch.cuda.synchronize()
        rows.append({"op": op, "class": None})
    except Exception as e:
        rows.append({"op": op, "class": type(e).__module__ + "."
                     + type(e).__qualname__, "message": str(e),
                     "device_fault": cli._device_fault(e)})


small = torch.zeros(4, device=dev)
attempt("index_out_of_range", lambda: small[torch.tensor([10], device=dev)])
attempt("add_after", lambda: small + 1)
attempt("matmul_after", lambda: m @ m)
attempt("conv2d_after", lambda: torch.nn.functional.conv2d(x, w))
attempt("max_iou_after", lambda: iou.max_iou(anchors, gt, mask))
for op, fn in (("matmul_new_thread_after", lambda: m @ m),
               ("conv2d_new_thread_after",
                lambda: torch.nn.functional.conv2d(x, w))):
    thread = threading.Thread(target=attempt, args=(op, fn))
    thread.start()
    thread.join()
print("STICKY " + json.dumps(rows))
"""
AR_TIMEOUT = 300            # seconds for any one command of auto_resume


def _ar_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("SHF_AUTO_RESUME_LEFT", "SHF_FAULT_ITER",
                        "SHF_FAULT_TEST")}
    env.update(extra)
    return env


def _ar_start(work, tag, amend, train=True, env=None, stderr=None):
    """``python -m smallhardface_tpu_torch --device cuda`` at the flagship
    config, started; stdout (the config) and stderr to files under
    ``work/<tag>`` unless ``stderr`` is a pipe. Returns (process, the run's
    output root, start time on the performance counter and since the
    epoch)."""
    from smallhardface_tpu_torch.config import CONFIG_DIR
    root = os.path.join(work, tag)
    os.makedirs(root)
    cmd = [sys.executable, "-m", "smallhardface_tpu_torch", "--device",
           "cuda", "--train", "true" if train else "false", "--test",
           "false" if train else "true", "--conf",
           os.path.join(CONFIG_DIR, "smallhardface.toml"), "--amend",
           "ROOT_DIR", root, "EXP_DIR", "ar", "NAME", "ar",
           "TRAIN.PRETRAINED", "", "TRAIN.SNAPSHOT", "2"] + amend
    out = open(os.path.join(root, "stdout.txt"), "w")
    err = stderr or open(os.path.join(root, "stderr.txt"), "w")
    t0, t0_epoch = time.perf_counter(), time.time()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env or _ar_env(), stdout=out,
                            stderr=err, text=True)
    out.close()
    if stderr is None:
        err.close()
    return proc, root, t0, t0_epoch


def _ar_wait(started, rc=0):
    """Wait for a started command; its wall, its run directories (each
    with its log) and its stderr. Raises unless it exits with ``rc``."""
    proc, root, t0, _ = started
    try:
        proc.wait(timeout=AR_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    dirs = sorted(os.path.dirname(p) for p in glob.glob(os.path.join(
        root, "output", "ar", "*", "ar_*", "stderr.log")))
    err_path = os.path.join(root, "stderr.txt")
    err = open(err_path).read() if os.path.exists(err_path) else ""
    if proc.returncode != rc:
        raise AssertionError(f"{root}: exit {proc.returncode}, expected "
                             f"{rc}:\n{err[-3000:]}")
    return wall, dirs, err


def _log_times(path):
    """(seconds since the epoch, message) of each line of a run's log."""
    from smallhardface_tpu_torch.__main__ import LOG_DATEFMT
    rows = []
    for line in open(path):
        m = re.match(r"(\S+),(\d+) ", line)
        if m:
            t = time.mktime(time.strptime(m.group(1), LOG_DATEFMT))
            rows.append((t + int(m.group(2)) / 1e3, line))
    return rows


def _first(rows, text):
    return next(t for t, line in rows if text in line)


def _same_npz(a, b):
    a, b = np.load(a), np.load(b)
    return sorted(a.files) == sorted(b.files) and all(
        np.array_equal(a[k], b[k]) for k in a.files)


def _one(dirs, name):
    found = [os.path.join(d, name) for d in dirs
             if os.path.exists(os.path.join(d, name))]
    if len(found) != 1:
        raise AssertionError(f"want one {name}, found {found}")
    return found[0]


def auto_resume_phase(work, root):
    """TRAIN.AUTO_RESUME and the signals through ``python -m
    smallhardface_tpu_torch --device cuda`` at the flagship config on the
    synthetic WIDER tree ``root``: a real sticky fault and what follows it;
    a fault injected at iteration 4 relaunched from the iteration-2
    snapshot, equal to the bit to an unfaulted run; SIGINT, a snapshot and
    a resume equal to the bit to a straight run; a fault in the evaluation
    relaunched with training off, its detections equal to the bit to an
    unfaulted evaluation's. Commands whose walls are not read run side by
    side."""
    data = ["DATA_DIR", root, "TRAIN.RESUME", ""]
    t_phase = time.perf_counter()
    query = subprocess.run(
        [sys.executable, "-m", "smallhardface_tpu_torch.tools.device_query"],
        cwd=REPO, capture_output=True, text=True, timeout=AR_TIMEOUT)
    say("device_query", rc=query.returncode,
        output=query.stdout.strip().splitlines())
    if query.returncode != 0 or "capability=9.0" not in query.stdout:
        raise AssertionError(f"device_query: {query.stderr[-2000:]}")
    control = _ar_start(work, "control", data + ["TRAIN.ITERS", "4"])
    straight = _ar_start(work, "straight", data + ["TRAIN.ITERS", "6"])
    sticky = subprocess.run([sys.executable, "-c", STICKY_CODE], cwd=REPO,
                            capture_output=True, text=True,
                            timeout=AR_TIMEOUT, env=_ar_env())
    line = [ln for ln in sticky.stdout.splitlines()
            if ln.startswith("STICKY ")]
    rows = json.loads(line[0][len("STICKY "):]) if line else []
    say("auto_resume_sticky", rc=sticky.returncode, ops=rows)
    if (len(rows) != 7 or not all(r["class"] and r["device_fault"]
                                  for r in rows[:5])):
        raise AssertionError(f"the sticky fault was not classified as one: "
                             f"{rows} {sticky.stderr[-2000:]}")
    ctl_wall, ctl_dirs, _ = _ar_wait(control)
    straight_wall, straight_dirs, _ = _ar_wait(straight)

    # a fault injected at iteration 4, relaunched from the iteration-2
    # snapshot; alone on the card, for its walls
    faulted = _ar_start(work, "faulted",
                        data + ["TRAIN.ITERS", "4", "TRAIN.AUTO_RESUME", "1"],
                        env=_ar_env(SHF_FAULT_ITER="4"))
    flt_wall, flt_dirs, _ = _ar_wait(faulted)
    if len(flt_dirs) != 2:
        raise AssertionError(f"want the faulted and the relaunched run "
                             f"directories: {flt_dirs}")
    # both processes log to the command's stderr (execve keeps it)
    lines = _log_times(os.path.join(faulted[1], "stderr.txt"))
    t_exec, source = next((t, ln) for t, ln in lines
                          if "relaunching from" in ln)
    second = [(t, ln) for t, ln in lines if t >= t_exec][1:]
    same = _same_npz(_one(ctl_dirs, "final.npz"), _one(flt_dirs, "final.npz"))
    relaunch = {
        "start_to_exec_s": t_exec - faulted[3],
        "exec_to_first_log_line_s": second[0][0] - t_exec,
        "exec_to_resumed_s": _first(second, "Resumed from") - t_exec,
        "exec_to_iter_3_line_s": _first(second, "iter 3/4") - t_exec,
        "exec_to_end_s": faulted[3] + flt_wall - t_exec,
        "control_start_to_first_log_line_s": _log_times(os.path.join(
            control[1], "stderr.txt"))[0][0] - control[3]}
    say("auto_resume_train", fault_iter=4, snapshot=2,
        relaunched_from=os.path.basename(source.split()[-1]),
        run_dirs=len(flt_dirs), final_npz_bit_identical=same,
        faulted_command_wall_s=flt_wall, control_wall_s=ctl_wall,
        relaunch=relaunch)
    if not same:
        raise AssertionError("the relaunched run's final.npz differs from "
                             "the unfaulted run's")

    # SIGINT once the first "iter" line is out: a snapshot and a stop
    signalled = _ar_start(work, "signal", data + ["TRAIN.ITERS", "6"],
                          stderr=subprocess.PIPE)
    proc, sent = signalled[0], None
    for line in proc.stderr:
        if sent is None and " iter " in line and "/6 cls_loss" in line:
            proc.send_signal(signal.SIGINT)
            sent = time.perf_counter() - signalled[2]
    sig_wall, sig_dirs, _ = _ar_wait(signalled)
    log = open(os.path.join(sig_dirs[0], "stderr.log")).read()
    stop = re.search(r"Stopping at iteration (\d+) on signal", log)
    snaps = sorted(int(m) for m in re.findall(
        r"_iter_(\d+)\.npz", " ".join(os.listdir(sig_dirs[0]))))
    if sent is None or stop is None or snaps[-1] != int(stop.group(1)):
        raise AssertionError(f"no stop on SIGINT: sent {sent}, snapshots "
                             f"{snaps}")
    resumed = _ar_start(work, "resumed", [
        "DATA_DIR", root, "TRAIN.ITERS", "6", "TRAIN.RESUME",
        os.path.join(sig_dirs[0], f"ar_iter_{snaps[-1]}.npz")])

    # a fault in the evaluation, relaunched with training off, beside an
    # unfaulted evaluation of the same weights
    model = _one(ctl_dirs, "final.npz")
    evaluate = ["DATA_DIR", root, "TEST.DB", "wider_val", "TEST.NO_CACHE",
                "False", "TEST.MODEL", model]
    eval_plain = _ar_start(work, "eval_plain", evaluate, train=False)
    eval_fault = _ar_start(work, "eval_fault",
                           evaluate + ["TRAIN.AUTO_RESUME", "1"],
                           train=False, env=_ar_env(SHF_FAULT_TEST="1"))
    res_wall, res_dirs, _ = _ar_wait(resumed)
    same_resume = _same_npz(_one(straight_dirs, "final.npz"),
                            _one(res_dirs, "final.npz"))
    say("auto_resume_signal", sigint_after_s=sent, stopped_at=int(
        stop.group(1)), snapshots=snaps, final_npz_bit_identical=same_resume,
        signalled_wall_s=sig_wall, straight_wall_s=straight_wall,
        resumed_wall_s=res_wall)
    if not same_resume:
        raise AssertionError("the run resumed after SIGINT differs from the "
                             "straight run")
    plain_wall, plain_dirs, _ = _ar_wait(eval_plain)
    fault_wall, fault_dirs, _ = _ar_wait(eval_fault)
    logs = "".join(open(os.path.join(d, "stderr.log")).read()
                   for d in fault_dirs)
    with open(_one(plain_dirs, "detections.pkl"), "rb") as f:
        want = pickle.load(f)
    with open(_one(fault_dirs, "detections.pkl"), "rb") as f:
        got = pickle.load(f)
    same_dets = len(got) == len(want) and all(
        len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
        for a, b in zip(got, want))
    say("auto_resume_eval", run_dirs=len(fault_dirs),
        relaunched="relaunching eval" in logs,
        injected="SHF_FAULT_TEST" in logs, images=len(got[1]),
        detections_bit_identical=same_dets, faulted_wall_s=fault_wall,
        unfaulted_wall_s=plain_wall,
        phase_wall_s=time.perf_counter() - t_phase)
    if not (same_dets and len(fault_dirs) == 2 and "relaunching eval" in logs):
        raise AssertionError("the relaunched evaluation differs")

DP_ITERS = 3                # iterations of each data-parallel command
DP_TIMEOUT = 300            # seconds for any one data-parallel command
# the first step of the two ranks against the in-process oracle: the
# largest difference of a leaf's update over the update's peak
DP_ORACLE_TOL = 1e-4


def _dp_amend(root, run_root, snapshot):
    """The --amend pairs of the data-parallel commands."""
    return ["DATA_DIR", root, "ROOT_DIR", run_root, "EXP_DIR", "dp", "NAME",
            "dp", "TRAIN.ITERS", str(DP_ITERS), "TRAIN.SNAPSHOT",
            str(snapshot), "TRAIN.PRETRAINED", "", "TRAIN.RESUME", "",
            "TEST.DB", "wider_val", "TEST.NO_CACHE", "False"]


def _dp_command(ranks, amend, train=True):
    """The user's command at the flagship config: ``python -m
    torch.distributed.run --standalone --nproc_per_node <ranks> -m
    smallhardface_tpu_torch --device cuda ... --amend <amend>``, or without
    the launcher when ``ranks`` is 0."""
    from smallhardface_tpu_torch.config import CONFIG_DIR
    launcher = [sys.executable]
    if ranks:
        launcher += ["-m", "torch.distributed.run", "--standalone",
                     "--nproc_per_node", str(ranks)]
    return launcher + [
        "-m", "smallhardface_tpu_torch", "--device", "cuda", "--train",
        "true" if train else "false", "--test", "true", "--conf",
        os.path.join(CONFIG_DIR, "smallhardface.toml"), "--amend"] + amend


def _dp_start(work, tag, cmd, env):
    """Start ``cmd`` with its output in files under ``work/<tag>``; its
    runs write under ``work/<tag>/root``."""
    base = os.path.join(work, tag)
    os.makedirs(base)
    out = open(os.path.join(base, "stdout.txt"), "w")
    err = open(os.path.join(base, "stderr.txt"), "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=out, stderr=err,
                            text=True)
    out.close()
    err.close()
    return proc, base, t0


def _dp_wait(started):
    """Wait for a started command: its wall and its train and test run
    directories. Raises unless it exits 0."""
    proc, base, t0 = started
    try:
        proc.wait(timeout=DP_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        err = open(os.path.join(base, "stderr.txt")).read()
        raise AssertionError(f"{base}: exit {proc.returncode}:\n"
                             f"{err[-4000:]}")
    dirs = {}
    for phase, db in (("train", "wider_train"), ("test", "wider_val")):
        found = glob.glob(os.path.join(base, "root", "output", "dp", db,
                                       "dp_*"))
        if len(found) > 1:
            raise AssertionError(f"{base}: ranks wrote to {found}")
        dirs[phase] = found[0] if found else None
    return wall, dirs


def _train_summary(path):
    """The "train summary" JSON a rank of ``train_net`` logs at its end."""
    with open(path) as f:
        for line in f:
            if "train summary " in line:
                return json.loads(line.split("train summary ", 1)[1])
    raise AssertionError(f"no train summary in {path}")


def _dets_equal(a_path, b_path):
    with open(a_path, "rb") as f:
        a = pickle.load(f)
    with open(b_path, "rb") as f:
        b = pickle.load(f)
    return len(a) == len(b) and all(
        len(x) == len(y) and all(np.array_equal(u, v) for u, v in zip(x, y))
        for x, y in zip(a, b))


def dp_oracle(cfg, tdm, dev, amend, snapshot_1):
    """The first step of the two-rank run in this one process: both ranks'
    first batches (rank r's loader, the bucket of the two), each rank's
    micro-batch sums, their sum divided by 2 × ITERSIZE, one solver step.
    Returns, per trainable leaf, max |update − the run's update| over
    max |update|, with the run's iteration-1 snapshot."""
    from smallhardface_tpu_torch.config import (CONFIG_DIR, cfg_from_file,
                                                cfg_from_list)
    from smallhardface_tpu_torch.datasets.factory import get_imdb
    from smallhardface_tpu_torch.io import checkpoint, weights
    from smallhardface_tpu_torch.train import solver, targets, train_loop
    from smallhardface_tpu_torch.train.loader import (
        RoIDataLoader, render_minibatch)
    cfg_from_file(os.path.join(CONFIG_DIR, "smallhardface.toml"))
    cfg_from_list(amend)
    roidb = train_loop.get_training_roidb(get_imdb(cfg.TRAIN.DB))
    spec = tdm.build_spec(cfg)
    model = tdm.Detector(train_loop._init_params(spec, ""), spec, dev,
                         trainable=True)
    params = model.tree()
    before = {n: {k: v.detach().clone() for k, v in leaf.items()}
              for n, leaf in params.items()}
    solver_type = str(cfg.TRAIN.SOLVER_TYPE)
    opt_state = solver.init_state(before, solver_type)
    size = int(cfg.TRAIN.ITERSIZE)
    scale = int(np.random.RandomState(int(cfg.RNG_SEED)).randint(
        0, len(cfg.TRAIN.SCALES.SHORT_SIDE), size=DP_ITERS)[0])
    samples = []
    for r in range(2):
        loader = RoIDataLoader(roidb, rank=r)
        plans = [loader.plan_minibatch(scale) for _ in range(size)]
        samples.append([render_minibatch(p) for p in plans])
    dims = np.maximum(*[train_loop._batch_dims(s) for s in samples])
    loss_fn = train_loop.LossFn(targets.from_cfg(cfg), dev)
    sums = []

    def keep(grads):
        sums.append([g.clone() for g in grads])
        return 1
    for r in range(2):
        arrays, _, bucket = train_loop.assemble_batch(
            samples[r], size, list(cfg.TPU.MAX_GT_BUCKETS), raw_dims=dims)
        batch = dict(arrays)
        for k in ("data", "gt", "gt_mask"):
            batch[k] = torch.from_numpy(arrays[k]).to(dev)
        train_loop.grad_step(model, loss_fn, batch, bucket[2:4], size, keep)
    trainable = [p for p in model.parameters() if p.grad is not None]
    for p, a, b in zip(trainable, *sums):
        p.grad = (a + b) / (2 * size)
    lr_mults, decay_mults = tdm.param_multipliers(spec)
    solver.apply_update(
        params, {n: {k: v.grad for k, v in leaf.items()}
                 for n, leaf in params.items()},
        opt_state, solver_type=solver_type,
        rate=solver.learning_rate(0, cfg), lr_mults=lr_mults,
        decay_mults=decay_mults, weight_decay=float(cfg.TRAIN.WEIGHT_DECAY),
        momentum=float(cfg.TRAIN.MOMENTUM), iteration=0)
    run = weights.params_from_numpy(checkpoint.load(snapshot_1)[0])
    errs = {}
    for n, leaf in params.items():
        for k, v in leaf.items():
            if lr_mults[n][k] == 0:
                continue
            want = (v.detach() - before[n][k]).double()
            got = (run[n][k].to(dev) - before[n][k]).double()
            errs[f"{n}/{k}"] = ((got - want).abs().max()
                                / want.abs().max().clamp_min(1e-30)).item()
    frozen_equal = all(torch.equal(run[n][k].to(dev), before[n][k])
                       for n, leaf in params.items() for k in leaf
                       if lr_mults[n][k] == 0)
    return errs, frozen_equal, scale, [int(d) for d in dims]


def dp_phases(cfg, tdm, dev, pristine, root, work, smi):
    """Data-parallel training and evaluation through the user's command
    (``python -m torch.distributed.run ... -m smallhardface_tpu_torch``)
    at the flagship config on the synthetic WIDER tree ``root``.
    ``dp_nccl_world1``: one rank over NCCL beside the same command without
    the launcher, final.npz equal to the bit and the detections row for
    row. ``dp_two_ranks_one_card``: two ranks on this card over gloo
    (``SHF_DIST_BACKEND=gloo``) with ``SHF_TRAIN_PROFILE=1``: the ranks'
    weights digests, rank 0 the only writer, the snapshot's two sampler
    states, the first step against ``dp_oracle``, detections.pkl against
    one process's ``test_net`` of the same final.npz, K1's and K3's
    launches per rank, the all-reduce's bytes and time per iteration, each
    rank's iteration walls and the card's idle share. Returns the two
    ranks' launch counts."""
    from smallhardface_tpu_torch import __main__ as cli
    from smallhardface_tpu_torch.config import (CONFIG_DIR, cfg_from_file,
                                                cfg_from_list)
    from smallhardface_tpu_torch.io import checkpoint
    t_phase = time.perf_counter()
    env = {k: v for k, v in _ar_env().items()
           if k not in ("SHF_DIST_BACKEND", "SHF_TRAIN_PROFILE")}

    def amend(tag, snapshot):
        return _dp_amend(root, os.path.join(work, tag, "root"), snapshot)
    cfg.clear()
    cfg.update(copy.deepcopy(pristine))
    cfg_from_file(os.path.join(CONFIG_DIR, "smallhardface.toml"))
    cfg_from_list(amend("dp_nccl1", 2))
    size = int(cfg.TRAIN.ITERSIZE)
    want_launches = {"fused_stem": DP_ITERS * size,
                     "max_iou": DP_ITERS * size}
    cfg.clear()
    cfg.update(copy.deepcopy(pristine))

    # ---- dp_nccl_world1, side by side with the command alone ----
    torch.cuda.empty_cache()
    nccl = _dp_start(work, "dp_nccl1",
                     _dp_command(1, amend("dp_nccl1", 2)), env)
    alone = _dp_start(work, "dp_alone",
                      _dp_command(0, amend("dp_alone", 2)), env)
    nccl_wall, nccl_dirs = _dp_wait(nccl)
    alone_wall, alone_dirs = _dp_wait(alone)
    summary = _train_summary(os.path.join(nccl_dirs["train"], "stderr.log"))
    same = _same_npz(os.path.join(nccl_dirs["train"], "final.npz"),
                     os.path.join(alone_dirs["train"], "final.npz"))
    same_dets = _dets_equal(
        os.path.join(nccl_dirs["test"], "detections.pkl"),
        os.path.join(alone_dirs["test"], "detections.pkl"))
    console = open(os.path.join(work, "dp_nccl1", "stderr.txt")).read()
    reported = re.findall(r"rank 0 of 1 on (\S+), backend (\w+)", console)
    say("dp_nccl_world1", nvidia_smi=smi, backend=summary["backend"],
        world=summary["world"], process_group_reported=reported,
        final_npz_bit_identical=same, detections_row_for_row=same_dets,
        launches=summary["launches"], launches_expected=want_launches,
        allreduce_bytes=summary["allreduce_bytes"],
        allreduce_ms=summary["allreduce_ms"],
        iteration_wall_s=summary["iteration_wall_s"],
        command_wall_s=nccl_wall, alone_command_wall_s=alone_wall,
        timing="both commands at once on the card")
    if not (summary["backend"] == "nccl" and summary["world"] == 1
            and same and same_dets
            and summary["launches"] == want_launches):
        raise AssertionError("dp_nccl_world1 failed its checks")

    # ---- dp_two_ranks_one_card, alone on the card ----
    env2 = dict(env, SHF_DIST_BACKEND="gloo", SHF_TRAIN_PROFILE="1")
    two = _dp_start(work, "dp_gloo2",
                    _dp_command(2, amend("dp_gloo2", 1)), env2)
    two_wall, dirs = _dp_wait(two)
    logs = [os.path.join(dirs[ph], name) for ph in ("train",)
            for name in ("stderr.log", "stderr.rank1.log")]
    sums = [_train_summary(p) for p in logs]
    digests = [s["weights_sha256"] for s in sums]
    wrote = [re.findall(r"Wrote snapshot to: \S+/(\S+\.npz)", open(p).read())
             for p in logs]
    files = sorted(os.listdir(dirs["train"]))
    states = pickle.loads(np.asarray(checkpoint.load(os.path.join(
        dirs["train"], "dp_iter_2.npz"))[3]["loader_state"]).tobytes())
    launches = [s["launches"] for s in sums]
    # the ranks time-slice the card (two processes, no MPS): the card's
    # busy time is the sum of theirs
    busy = [s["device_busy_s"] for s in sums]
    loop = [s["loop_wall_s"] for s in sums]
    reduce_ms = [s["allreduce_ms"] for s in sums]
    errs, frozen_equal, scale, dims = dp_oracle(
        cfg, tdm, dev, amend("dp_gloo2", 1),
        os.path.join(dirs["train"], "dp_iter_1.npz"))
    cfg.clear()
    cfg.update(copy.deepcopy(pristine))
    worst = max(errs, key=errs.get)
    # one process's test_net of the same final.npz
    cli.main(_dp_command(0, amend("dp_one", 2) + [
        "TEST.MODEL", os.path.join(dirs["train"], "final.npz")],
        train=False)[3:])
    one_test, = glob.glob(os.path.join(work, "dp_one", "root", "output",
                                       "dp", "wider_val", "dp_*"))
    cfg.clear()
    cfg.update(copy.deepcopy(pristine))
    same_dets = _dets_equal(os.path.join(dirs["test"], "detections.pkl"),
                            os.path.join(one_test, "detections.pkl"))
    say("dp_two_ranks_one_card", nvidia_smi=smi,
        backend=[s["backend"] for s in sums],
        world=[s["world"] for s in sums],
        weights_sha256=digests, weights_equal=len(set(digests)) == 1,
        snapshots_written_by_rank=wrote, train_files=files,
        sampler_states_in_snapshot=len(states),
        first_step_vs_oracle={"max_err_over_update_peak": errs[worst],
                              "leaf": worst, "tol": DP_ORACLE_TOL,
                              "leaves_bit_equal": sum(
                                  e == 0.0 for e in errs.values()),
                              "leaves": len(errs),
                              "frozen_leaves_unchanged": frozen_equal,
                              "scale_index": scale, "raw_dims": dims},
        detections_vs_one_process_row_for_row=same_dets,
        launches=launches, launches_expected_per_rank=want_launches,
        allreduce_bytes=[s["allreduce_bytes"] for s in sums],
        allreduce_ms=reduce_ms,
        allreduce_ms_per_iteration=[sum(m) / len(m) for m in reduce_ms],
        iteration_wall_s=[s["iteration_wall_s"] for s in sums],
        loop_wall_s=loop, device_busy_s=busy,
        rank_idle_share=[None if b is None else 1.0 - b / w
                         for b, w in zip(busy, loop)],
        card_idle_share=(None if None in busy
                         else 1.0 - sum(busy) / max(loop)),
        command_wall_s=two_wall,
        timing="alone on the card; busy from torch.profiler in each rank "
               "(SHF_TRAIN_PROFILE=1); every iteration writes a snapshot")
    ok = (len(set(digests)) == 1
          and [s["backend"] for s in sums] == ["gloo", "gloo"]
          and wrote[1] == []
          and sorted(wrote[0]) == sorted(
              [f"dp_iter_{k}.npz" for k in range(1, DP_ITERS + 1)]
              + ["final.npz"])
          and "stderr.rank1.log" in files and len(states) == 2
          and errs[worst] <= DP_ORACLE_TOL and frozen_equal and same_dets
          and launches == [want_launches] * 2)
    if not ok:
        raise AssertionError("dp_two_ranks_one_card failed its checks")
    say("dp_phases", seconds=time.perf_counter() - t_phase, nvidia_smi=smi)
    return launches


# the tools phase: benchmark's shape, layer_time's, train_time's and
# perf_probe's; the per-layer scopes' least share of the forward's device
# time; ap_parity's dry run on a small synthetic tree (the CPU test's
# amends: two small scales, no flip, at most 100 rows a level, so the
# device vote takes every row the host vote takes)
TOOLS_BENCH = ["--height", "608", "--width", "912", "--iters", "5"]
TOOLS_LAYER = ["--size", "1408", "1920", "--reps", "3"]
TOOLS_TRAIN = (768, 1024)
TOOLS_PROBE = ["--size", "608", "912", "--iters", "3", "--batch", "2"]
SCOPE_COVERAGE_MIN = 0.95
AP_DRY_RUN = ["synth", "synth", "--dry-run", "--n-images", "4",
              "--amend", "TEST.SCALES", "[60,120]", "TEST.FLIP", "False",
              "TPU.TEST_BUCKET", "32", "TEST.N_DETS_PER_MODULE", "100",
              "TPU.VOTE_CAP", "1024"]


def _quiet(main, argv):
    """main(argv) with its printed tables kept out of the smoke's output;
    returns (its result, what it printed)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    return result, buf.getvalue()


def _stage_fields(split):
    """A stage split's printed fields: per stage device ms, host ms,
    launches and host µs per launch; the run's busy ms and idle share."""
    return {"stages": {k: {f: (round(v, 4) if isinstance(v, float) else v)
                           for f, v in r.items()}
                       for k, r in split["stages"].items()},
            "wall_ms": split["wall_ms"],
            "device_busy_ms": split["device_busy_ms"],
            "idle_share": split["idle_share"],
            "outside": split.get("outside")}


def tools_phase(cfg, pristine, tdm, params, image, plain_rows, dev, smi,
                work):
    """The port's per-stage timing tools on the card: benchmark's forward
    in fp32 and bf16 and forward+backward at 1×608×912; layer_time at
    1×1408×1920 (the per-layer table, whose scopes must hold at least
    SCOPE_COVERAGE_MIN of the forward's device time, --bisect, and
    --int8-chain with Q1's launches) and --train at 1×608×912;
    pyramid_time's split of a warm fp32 ``detect`` of image 0 at the
    detection phase's configuration (its rows equal to a plain
    ``detect``'s); train_time's split of the flagship step at 768×1024;
    perf_probe at 608×912 (``detect_many`` of two images); ``ap_parity
    --dry-run synth synth`` on 4 synthetic images, PARITY OK required.
    Every line carries the card's name and power limit. Returns the
    launches the in-process tools made per kernel (ap_parity's evaluations
    are processes of their own: their launches are not counted here)."""
    import tempfile as tf

    from smallhardface_tpu_torch.config import CONFIG_DIR, cfg_from_file
    from smallhardface_tpu_torch.detect import TorchDetector
    from smallhardface_tpu_torch.ops import conv_int8, iou, nms_device, stem
    from smallhardface_tpu_torch.tools import (ap_parity, benchmark,
                                               layer_time, perf_probe,
                                               pyramid_time, train_time)
    t_phase = time.perf_counter()
    counted = (stem.fused_stem, nms_device.bbox_vote_device, iou.max_iou,
               conv_int8.conv3x3_int8)
    names = ("fused_stem", "bbox_vote", "max_iou", "conv3x3_int8")
    launches = dict.fromkeys(names, 0)
    # launches the profiler reported no device event for, per tool line
    # (``measure.Trace.lost``): printed, not held, since a fresh process
    # on the card already shows 6-7 in a bf16 forward of 98 launches
    lost = {}

    def count(fn):
        set_counts_zero(*counted)
        out = fn()
        got = dict(zip(names, (f.launches for f in counted)))
        for k, v in got.items():
            launches[k] += v
        return out, got

    def restore(flagship=True):
        cfg.clear()
        cfg.update(copy.deepcopy(pristine))
        if flagship:
            cfg_from_file(os.path.join(CONFIG_DIR, "smallhardface.toml"))

    # benchmark: forward fp32, forward bf16, forward+backward fp32
    for extra in ([], ["--bf16"], ["--train"]):
        t = time.perf_counter()
        (res, _), got = count(lambda: _quiet(
            benchmark.main, TOOLS_BENCH + extra + ["--device", dev.type]))
        say("tools_benchmark", mode=res["mode"], precision=res["precision"],
            shape=res["shape"], mean_ms=res["mean_ms"], p50_ms=res["p50_ms"],
            min_ms=res["min_ms"], device_ms=res["device_ms"],
            launches=res["launches"], host_ms=res["host_ms"],
            host_us_per_launch=res["host_us_per_launch"],
            idle_share=res["idle_share"], kernel_launches=got,
            lost_device_events=res["lost_device_events"],
            seconds=time.perf_counter() - t, nvidia_smi=smi)
        lost[f"benchmark {res['mode']} {res['precision']}"] = res[
            "lost_device_events"]
        if not got["fused_stem"]:
            raise AssertionError("benchmark ran no K1")
    # layer_time: the per-layer table and --bisect, then --int8-chain
    t = time.perf_counter()
    (res, _), got = count(lambda: _quiet(
        layer_time.main, TOOLS_LAYER + ["--bisect", "--device", dev.type]))
    top = sorted(res["layers"].items(),
                 key=lambda kv: -(kv[1]["fwd_ms"] or 0))[:6]
    say("tools_layer_time", size=res["size"], fwd_device_ms=res["fwd_ms"],
        scoped_share=res["coverage"], coverage_min=SCOPE_COVERAGE_MIN,
        outside=res["outside"],
        top_layers={n: {k: r[k] for k in ("fwd_ms", "launches", "gflop",
                                           "tflops", "bound_ms", "of_bound")}
                    for n, r in top},
        bisect=[[r["stage"], r["cum_ms"], r["delta_ms"]]
                for r in res["bisect"]],
        full=res["full"], method=res["bisect_method"], kernel_launches=got,
        lost_device_events=res["lost"], seconds=time.perf_counter() - t,
        nvidia_smi=smi)
    lost["layer_time"] = res["lost"]
    if not (res["coverage"] or 0) >= SCOPE_COVERAGE_MIN:
        raise AssertionError(f"the per-layer scopes hold {res['coverage']} "
                             f"of the forward's device time")
    # --train at benchmark's shape: the backward's share grouped by the
    # forward scope of its autograd nodes (printed, not held)
    t = time.perf_counter()
    (res, _), got = count(lambda: _quiet(
        layer_time.main, ["--size", "608", "912", "--train", "--device",
                          dev.type]))
    top = sorted(res["layers"].items(),
                 key=lambda kv: -(kv[1]["bwd_ms"] or 0))[:4]
    say("tools_layer_time_train", size=res["size"],
        fwd_device_ms=res["fwd_ms"], bwd_device_ms=res["bwd_ms"],
        scoped_share=res["coverage"], bwd_scoped_share=res["bwd_coverage"],
        top_backward={n: [r["fwd_ms"], r["bwd_ms"]] for n, r in top},
        kernel_launches=got, lost_device_events=res["lost"],
        seconds=time.perf_counter() - t, nvidia_smi=smi)
    lost["layer_time --train"] = res["lost"]
    t = time.perf_counter()
    (res, _), got = count(lambda: _quiet(
        layer_time.main, TOOLS_LAYER + ["--int8-chain", "--device",
                                        dev.type]))
    say("tools_layer_time_int8_chain", size=res["size"],
        rows=[[r["stage"], r["int8_ms"], r["fp32_ms"], r["floor_ms"]]
              for r in res["rows"]],
        int8_device_ms=res["int8_device_ms"],
        fp32_device_ms=res["fp32_device_ms"],
        int8_wall_ms=res["int8_wall_ms"], fp32_wall_ms=res["fp32_wall_ms"],
        floor_ms=res["floor_ms"], q1_launches_per_chain=res["q1_launches"],
        copy_gb_per_s=res["copy_bytes_per_s"] / 1e9, kernel_launches=got,
        lost_device_events=res["lost"], seconds=time.perf_counter() - t,
        nvidia_smi=smi)
    lost["layer_time --int8-chain"] = res["lost"]
    if not got["conv3x3_int8"] or not res["q1_launches"]:
        raise AssertionError("layer_time --int8-chain ran no Q1")
    # pyramid_time: a warm fp32 detect of image 0, the detection phase's
    # configuration
    restore()
    cfg.TEST.SCALES = [100, 300, 600, 1000, 1400]
    cfg.TEST.FLIP = True
    cfg.TEST.NMS_METHOD = "BBOX_VOTE"
    t = time.perf_counter()
    det = TorchDetector(params, tdm.build_spec(cfg), dev)
    split, got = count(lambda: pyramid_time.split_detect(
        det, image, reps=5))
    again = det.detect(image, THRESH)[0][0]
    same_as_detect_phase = bool(np.array_equal(again, plain_rows))
    say("tools_pyramid_time", image=0, levels=split["levels"],
        dets=split["dets"], rows_equal_plain_detect=split["rows_equal"],
        rows_equal_detect_phase=same_as_detect_phase,
        kernel_launches=got, seconds=time.perf_counter() - t,
        nvidia_smi=smi, **_stage_fields(split))
    lost["pyramid_time"] = split["lost_device_events"]
    if not split["rows_equal"] or not got["bbox_vote"]:
        raise AssertionError("pyramid_time's detect differs from a plain "
                             "one, or ran no V1")
    del det
    torch.cuda.empty_cache()
    # train_time: the flagship step at 768×1024
    restore()
    t = time.perf_counter()
    step = train_time.Step(cfg, dev, train_time.make_samples(*TOOLS_TRAIN,
                                                             1))
    split, got = count(lambda: train_time.split_step(step, 5))
    # cls_loss + reg_loss of each step (one micro-batch), every step from
    # the same weights: the same loss to the bit
    losses = [m[0][0] + m[1][0] for m in split["metrics"]]
    say("tools_train_time", size=list(TOOLS_TRAIN), iter_size=1,
        bucket=list(step.bucket), peak_bytes=split["peak_bytes"],
        losses=losses, kernel_launches=got,
        seconds=time.perf_counter() - t, nvidia_smi=smi,
        **_stage_fields(split))
    lost["train_time"] = split["lost_device_events"]
    if (not got["max_iou"] or not np.isfinite(losses).all()
            or len(set(losses)) != 1):
        raise AssertionError("train_time ran no K3, or its losses are not "
                             "finite and equal")
    del step
    torch.cuda.empty_cache()
    # perf_probe at one size
    restore()
    t = time.perf_counter()
    (lines, _), got = count(lambda: _quiet(
        perf_probe.main, TOOLS_PROBE + ["--device", dev.type]))
    for line in lines:
        fields = {k: v for k, v in line.items()
                  if k not in ("card", "device", "stages", "walls_ms")}
        if "stages" in line:
            fields.update(_stage_fields(line))
        say("tools_perf_probe", **fields)
        if "lost_device_events" in line:
            lost[f"perf_probe {line['probe']}"] = line["lost_device_events"]
    say("tools_perf_probe_done", kernel_launches=got,
        seconds=time.perf_counter() - t, nvidia_smi=smi)
    if not (got["conv3x3_int8"] and got["bbox_vote"]):
        raise AssertionError("perf_probe ran no Q1 or no V1")
    torch.cuda.empty_cache()
    # ap_parity's dry run: its tree goes under work, its runs too
    restore(flagship=False)
    t = time.perf_counter()
    saved_tmp = tf.tempdir
    tf.tempdir = work
    try:
        rc, text = _quiet(ap_parity.main, AP_DRY_RUN + [
            "ROOT_DIR", os.path.join(work, "ap_parity"),
            "--device", dev.type])
    finally:
        tf.tempdir = saved_tmp
    aps = [ln for ln in text.splitlines() if "path AP" in ln
           or "PARITY" in ln or "match-rate" in ln or "matched" in ln]
    say("tools_ap_parity", returncode=rc, lines=aps,
        seconds=time.perf_counter() - t, nvidia_smi=smi)
    if rc != 0 or "PARITY OK" not in text:
        raise AssertionError(f"ap_parity --dry-run: rc {rc}\n{text[-3000:]}")
    restore(flagship=False)
    say("tools", seconds=time.perf_counter() - t_phase,
        kernel_launches=launches, lost_device_events=lost, nvidia_smi=smi)
    return launches


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
