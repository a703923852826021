"""The tests' tiny cells: a skeletal backbone, two small image shapes and
small pyramid and training scales, written as workload and configuration
files into a folder, as a later cell would be added."""

from __future__ import annotations

import json
import os

SKELETAL = (("conv1", 8, 1), ("conv2", 32, 1), ("conv3", 32, 1),
            ("conv4", 32, 1), ("conv5", 32, 1))
POOL = {"images": 8, "shapes": "64x96,96x64", "faces": "2-6",
        "face_px": "8-30"}
CONFIGS = {
    "tiny-fp32": ("smallhardface.toml",
                  ["TEST.SCALES", "[50, 90]",
                   "TEST.PYRAMID_BASE_SIZE", "[64, 96]"]),
    "tiny-int8": ("smallhardface-int8.toml",
                  ["TEST.SCALES", "[50, 90]",
                   "TEST.PYRAMID_BASE_SIZE", "[64, 96]"]),
    "tiny-trainer": ("smallhardface.toml", ["TRAIN.SCALES.SHORT_SIDE",
                                          "[48, 64, 96]",
                                          "TRAIN.SCALES.MAX_SIZE", "200"]),
}
CELLS = {
    "tiny-eval": dict(config="tiny-fp32", driver="eval_pipeline", **POOL,
                      pipeline_depth=3, thresh=0.05, check_images=3,
                      trace_images=3),
    "tiny-b4": dict(config="tiny-int8", driver="eval_batched", **POOL,
                    eval_batch=4, thresh=0.05, check_images=6,
                    trace_groups=2),
    "tiny-train": dict(config="tiny-trainer", driver="train_step", **POOL,
                       pool_iters=4, trace_iters=3),
}


def write(folder):
    for name, (toml, amend) in CONFIGS.items():
        with open(os.path.join(folder, f"{name}.json"), "w") as f:
            json.dump({"toml": f"smallhardface_tpu/configs/{toml}",
                       "amend": amend, "source": "test", "reduced": [],
                       "assumed": []}, f)
    for name, cell in CELLS.items():
        with open(os.path.join(folder, f"{name}.json"), "w") as f:
            json.dump(dict(cell, traffic="tiny", chips=1, why="test"), f)
    return folder


def run(folder, cell, monkeypatch, trace=0, seconds=2.0, seed=2 ** 31 + 17):
    """One run of a tiny cell on the CPU through ``run.run_cell``."""
    import torch
    from portbench import run as prun
    from smallhardface_tpu_torch.models import detector as dm
    monkeypatch.setattr(dm, "VGG_STAGES", SKELETAL)
    args = prun.parse(["--workload", cell, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace),
                       "--workloads", folder])
    return prun.run_cell(args, torch.device("cpu"), stages=SKELETAL)
