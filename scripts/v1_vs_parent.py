#!/usr/bin/env python3
"""Device time of the final vote V1 (smallhardface_tpu_torch/csrc/vote.cu)
against an earlier source of it, on one NVIDIA card, in turns.

    git show <rev>:smallhardface_tpu_torch/csrc/vote.cu > runs/vote_parent.cu
    python3 scripts/v1_vs_parent.py runs/vote_parent.cu

Both sources are built with the port's nvcc flags for V1 (no fused
multiply-add, IEEE division; ops/nms_device.py) and called through their
C entry points, shf_bbox_vote (and shf_nms on one case), on the same
inputs into buffers that hold this source's scratch after the rows (the
earlier source reads none of it). The cases: the top-2048 candidate sets
of chip_smoke.py's three detection images (its random weights and
images, from its seed), each alone and the three as one batch; a crowd of
2048 boxes about six centres; 2048 and 512 boxes scattered over 200
centres; 2048 boxes that overlap nothing (2048 steps); 2048 that form one
cluster; 512 integer boxes with dyadic scores. In every case the two
outputs and counts must be equal to the bit. Each is timed as 20 calls
captured in one CUDA graph, replayed between two CUDA events (median of 5
replays, per call), in the order earlier, this, this, earlier. Prints the
card's name and power limit, one JSON line per case (device ms of each,
the clusters of the plain loop, this source's microseconds a cluster and
its device time in each of its three launches under torch.profiler, the
bound) and a summary: image 0's time against the 0.5 ms target and the
cases where this source is slower than the earlier one by more than
SLOWER_MS. Exits nonzero without a card or where the outputs differ.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

REPS = 20
# this source's launches, for its split by phase (torch.profiler)
PHASES = {"mask": "vote_mask_kernel", "walk": "vote_walk_kernel",
          "emit": "vote_emit_kernel"}
TARGET_MS = 0.5     # image 0's device time the redesign aims at
SLOWER_MS = 0.01    # how much slower than the earlier source a case may be


def candidate_sets():
    """chip_smoke.py's detector and images: each image's top-VOTE_CAP
    candidates as the detection path votes them, and the vote's IoU
    threshold."""
    import chip_smoke as cs
    from smallhardface_tpu_torch.config import CONFIG_DIR, cfg, cfg_from_file
    from smallhardface_tpu_torch.detect import TorchDetector, top_rows
    from smallhardface_tpu_torch.models import detector as tdm
    cfg_from_file(os.path.join(CONFIG_DIR, "smallhardface.toml"))
    cfg.TEST.SCALES = [100, 300, 600, 1000, 1400]
    cfg.TEST.FLIP = True
    cfg.TEST.NMS_METHOD = "BBOX_VOTE"
    spec = tdm.build_spec(cfg)
    params = tdm.init_params(torch.Generator().manual_seed(cs.SEED), spec)
    for k in tdm.ANCHOR_SCALES:
        params[f"cls_score_{k}"]["b"] = torch.tensor([cs.CLS_BIAS,
                                                      -cs.CLS_BIAS])
    det = TorchDetector(params, spec, torch.device("cuda", 0))
    rng = np.random.RandomState(cs.SEED)
    images = [cs.make_image(rng, h, w) for h, w in cs.IMAGE_SIZES]
    sets = []
    with torch.no_grad():
        for im in images:
            boxes, scores, keep = det.merged_candidates(im, cs.THRESH)
            sets.append(top_rows(boxes, scores, keep, det.vote_cap))
    return sets, float(cfg.TEST.NMS_THRESH)


def phase_us(fn, n=10):
    """Device microseconds per call of fn in each of PHASES' kernels, from
    n calls under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = dict.fromkeys(PHASES, 0.0)
    for ev in prof.key_averages():
        for label, name in PHASES.items():
            if f"::{name}<" in ev.key:      # templates, anonymous namespace
                us[label] += ev.self_device_time_total / n
    return us


def main(argv):
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    import chip_smoke as cs
    from smallhardface_tpu_torch.ops import cuda_build, nms_device, stem
    from smallhardface_tpu_torch.ops.vote_cases import (
        chain_dets, crowd_dets, integer_dets, one_cluster_dets)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    earlier = cuda_build.CudaLibrary(
        "vote_earlier", os.path.abspath(argv[0]),
        dict.fromkeys(("shf_bbox_vote", "shf_nms"), nms_device._SIGNATURE),
        extra_flags=nms_device.VOTE.flags[len(cuda_build.NVCC_FLAGS):])
    cuda_build.build_all([earlier, nms_device.VOTE, stem.STEM])
    libs = {"earlier": earlier.load(), "this": nms_device.VOTE.load()}
    print("v1_vs_parent_build: " + json.dumps({
        lib.name: [ln.strip() for ln in lib.log.splitlines()
                   if "registers" in ln or "spill" in ln]
        for lib in (earlier, nms_device.VOTE)}), flush=True)
    dev = torch.device("cuda", 0)

    sets, vote_thresh = candidate_sets()
    cases = []
    for i, (d, n) in enumerate(sets):
        cases.append((f"image{i}", d.contiguous(), n, vote_thresh, True))
    cases.append(("nms_image0", sets[0][0].contiguous(), sets[0][1],
                  vote_thresh, False))
    v = max(d.shape[0] for d, _ in sets)
    batch = torch.stack([torch.nn.functional.pad(d, (0, 0, 0, v - d.shape[0]))
                         for d, _ in sets]).contiguous()
    cases.append(("batched3", batch, torch.stack([n for _, n in sets]),
                  vote_thresh, True))
    rng = np.random.RandomState(cs.SEED + 6)
    host = [("crowd", crowd_dets(rng, 2048), vote_thresh),
            ("scattered2048", crowd_dets(np.random.RandomState(1), 2048,
                                         centres=200, spread=40), 0.4),
            ("scattered512", crowd_dets(np.random.RandomState(1), 512,
                                        centres=200, spread=40), 0.4),
            ("no_overlap", chain_dets(2048), vote_thresh),
            ("one_cluster", one_cluster_dets(rng, 2048), vote_thresh),
            ("integer512", integer_dets(rng, 512), vote_thresh)]
    for name, d, thresh in host:
        cases.append((name, torch.from_numpy(d).to(dev), torch.tensor(
            d.shape[0], dtype=torch.int32, device=dev), thresh, True))

    rows = {}
    for name, dets, n, thresh, vote in cases:
        b = dets.shape[0] if dets.dim() == 3 else 1
        v = dets.shape[-2]
        entry = "shf_bbox_vote" if vote else "shf_nms"
        bufs = {k: torch.empty(b * (5 * v + nms_device.scratch_words(v)),
                               device=dev) for k in libs}
        counts = {k: torch.empty(n.shape, dtype=torch.int32, device=dev)
                  for k in libs}

        def run(which):
            lib = earlier if which == "earlier" else nms_device.VOTE
            lib.check(getattr(libs[which], entry)(
                dets.data_ptr(), n.data_ptr(), b, v, thresh,
                bufs[which].data_ptr(), counts[which].data_ptr(),
                torch.cuda.current_stream().cuda_stream), which)

        run("earlier")
        run("this")
        torch.cuda.synchronize()
        same = (torch.equal(bufs["earlier"][:b * v * 5],
                            bufs["this"][:b * v * 5])
                and torch.equal(counts["earlier"], counts["this"]))
        if not same:
            raise AssertionError(f"the two sources differ on {name}")
        times = {"earlier": [], "this": []}
        for which in ("earlier", "this", "this", "earlier"):
            times[which].append(cs.graph_ms(lambda: run(which), reps=REPS,
                                            n=5))
        phases = phase_us(lambda: run("this"))
        steps = pairs = 0
        for d, c in (zip(dets, n) if b > 1 else [(dets, n)]):
            _, _, s, p = nms_device.greedy_steps(d, c, thresh, vote)
            steps, pairs = steps + s, pairs + p
        bnd, by = cs.bound_ms(40 * v * b + 8 * b, 25 * pairs)
        row = {"case": name, "images": b, "rows": v,
               "candidates": n.tolist(), "iou_thresh": thresh,
               "method": "BBOX_VOTE" if vote else "NMS",
               "n_out": counts["this"].tolist(), "clusters": steps,
               "iou_pairs": pairs, "bit_equal": True,
               "earlier_device_ms": times["earlier"],
               "this_device_ms": times["this"],
               "this_us_per_cluster": 1e3 * min(times["this"])
               / max(steps, 1),
               "earlier_us_per_cluster": 1e3 * min(times["earlier"])
               / max(steps, 1),
               "this_phase_us": phases, "bound_ms": bnd, "bound_by": by}
        rows[name] = row
        print("v1_vs_parent: " + json.dumps(row), flush=True)
    slower = [r["case"] for r in rows.values()
              if min(r["this_device_ms"])
              > max(r["earlier_device_ms"]) + SLOWER_MS]
    print("v1_vs_parent_summary: " + json.dumps({
        "image0_this_ms": rows["image0"]["this_device_ms"],
        "image0_earlier_ms": rows["image0"]["earlier_device_ms"],
        "image0_target_ms": TARGET_MS,
        "image0_within_target": max(rows["image0"]["this_device_ms"])
        <= TARGET_MS,
        "batched3_this_ms": rows["batched3"]["this_device_ms"],
        "batched3_earlier_ms": rows["batched3"]["earlier_device_ms"],
        "slower_than_earlier_by_more_than_ms": SLOWER_MS,
        "slower_cases": slower,
        "timing": f"{REPS} calls in one CUDA graph, median of 5 replays, "
                  "per call; in turns earlier, this, this, earlier"}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
