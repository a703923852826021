"""One-command WIDER AP parity harness of the port.

Counterpart of ``smallhardface_tpu/tools/ap_parity.py`` (:54-198). When
real WIDER data and the reference's trained ``final.caffemodel`` are at
hand, proving AP parity against the published numbers (95.7/94.9/89.7,
the reference's README.md:5-7) is ONE command:

  python -m smallhardface_tpu_torch.tools.ap_parity <wider_root> <weights>

It (1) validates the WIDER layout, (2) loads the weights into the port's
``Detector`` tree with a matched/unmatched layer report (fast-fail before
the long evaluations), (3) runs the port's command line evaluation
(``python -m smallhardface_tpu_torch --train false --test true``) TWICE —
the fused device path (default) and ``TPU.HOST_PREPROC True`` (cv2
resize, float32 uploads, float64 host vote — the reference-exact
pipeline) — and (4) prints both AP triples, the port's ``compare_dets``
match table between the two result archives, and the verdict: PARITY OK
when the largest AP difference is at most 0.001 (exit 0), else PARITY
DIVERGENT (exit 1). ``--device`` is passed on to both evaluations.

<wider_root> layout (the reference run recipe, its README.md:93-99):
  WIDER_val/images/<event>/<img>.jpg
  wider_face_split/wider_face_val_bbx_gt.txt
  ground_truth/wider_face_val.mat (+ easy/medium/hard setting mats)
<weights>: a .caffemodel (the reference's trained model, or one written by
either package) or a .npz checkpoint of either package.

--dry-run: no data or weights needed — it builds the synthetic WIDER
layout (``scripts/synth_wider.build``, numpy, cv2 and scipy only) and,
when <weights> is the literal ``synth``, a random-init .caffemodel written
by the port's ``io/caffemodel``, so the whole harness runs on any machine.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONF = os.path.join("smallhardface_tpu", "configs", "smallhardface.toml")
AP_RE = re.compile(r"Easy: ([0-9.]+), Medium: ([0-9.]+), Hard: ([0-9.]+)")
# the largest AP difference between the two pipelines that is parity
AP_TOL = 0.001
SHARED_HEADS = ("head_1", "head_2", "head_4")

_LAYOUT = (
    os.path.join("WIDER_val", "images"),
    os.path.join("wider_face_split", "wider_face_val_bbx_gt.txt"),
    os.path.join("ground_truth", "wider_face_val.mat"),
    os.path.join("ground_truth", "wider_easy_val.mat"),
    os.path.join("ground_truth", "wider_medium_val.mat"),
    os.path.join("ground_truth", "wider_hard_val.mat"),
)


def validate_layout(root):
    missing = [p for p in _LAYOUT
               if not os.path.exists(os.path.join(root, p))]
    if missing:
        raise SystemExit(
            f"{root} is not a WIDER layout — missing: {missing}\n"
            "expected the reference's on-disk structure (its "
            "README.md:93-99): WIDER_val/images/, "
            "wider_face_split/wider_face_val_bbx_gt.txt, "
            "ground_truth/*.mat")


def weights_report(path):
    """Load the weights into a fresh parameter tree of the port's
    ``Detector`` (the spec of the global config: ``main`` loads the
    evaluations' config and amends first) and report the coverage — fails
    fast (before two long evaluations) on an unreadable or mismatched
    file. Returns
    {"matched", "params", "file_layers", "unmatched_file",
    "unmatched_model"} (file_layers None for a .npz)."""
    import torch

    from smallhardface_tpu_torch.config import cfg
    from smallhardface_tpu_torch.models import detector as dm

    spec = dm.build_spec(cfg)
    params = dm.init_params(torch.Generator().manual_seed(0), spec)
    if path.endswith(".caffemodel"):
        from smallhardface_tpu_torch.io import caffemodel
        file_layers = caffemodel.read_caffemodel(path)
        caffemodel.load_into_params(path, params, strict=True,
                                    file_layers=file_layers)
        matched = {("head" if n in SHARED_HEADS else n) for n in file_layers
                   if n in params or n in SHARED_HEADS}
        unmatched_file = sorted(n for n in file_layers
                                if n not in params and n not in SHARED_HEADS)
        unmatched_model = sorted(k for k in params if k not in matched)
        print(f"== weights: {path}")
        print(f"   matched {len(matched)}/{len(params)} model params "
              f"from {len(file_layers)} file layers")
        if unmatched_file:
            print(f"   file layers ignored: {unmatched_file}")
        if unmatched_model:
            print(f"   model params kept at init: {unmatched_model}")
        if len(matched) < len(params):
            print("   WARNING: not all model params came from the file — "
                  "AP will not be parity-grade")
        return {"matched": len(matched), "params": len(params),
                "file_layers": len(file_layers),
                "unmatched_file": unmatched_file,
                "unmatched_model": unmatched_model}
    from smallhardface_tpu_torch.io.weights import load_params
    loaded = load_params(path)
    if set(loaded) != set(params):
        raise ValueError(
            f"{path}: parameter names differ from the model's: "
            f"{sorted(set(loaded) ^ set(params))}")
    for name, leaf in params.items():
        for k, t in leaf.items():
            got = loaded[name].get(k)
            if got is None or tuple(got.shape) != tuple(t.shape):
                raise ValueError(
                    f"{path}: {name}/{k} has shape "
                    f"{None if got is None else tuple(got.shape)}, the "
                    f"model's is {tuple(t.shape)}")
    print(f"== weights: {path} (native checkpoint, all params loaded)")
    return {"matched": len(params), "params": len(params),
            "file_layers": None, "unmatched_file": [],
            "unmatched_model": []}


def run_eval(model, data_dir, exp_dir, extra, cli, device):
    """One evaluation through the port's command line (``cli``: a script
    to run instead of ``-m smallhardface_tpu_torch``, a test hook); returns
    (its result.tar.gz, its (easy, medium, hard) AP or None)."""
    entry = [cli] if cli else ["-m", "smallhardface_tpu_torch"]
    cmd = [sys.executable, *entry, "--train", "false", "--test", "true",
           "--device", device, "--conf", CONF,
           "--amend", "DATA_DIR", data_dir, "TEST.MODEL", model,
           "EXP_DIR", exp_dir, "NAME", "appar"] + extra
    subprocess.run(cmd, cwd=REPO, check=True)
    # honour an amended ROOT_DIR (output lands under <ROOT_DIR>/output)
    root = REPO
    if "ROOT_DIR" in extra:
        root = extra[extra.index("ROOT_DIR") + 1]
    runs = sorted(glob.glob(
        os.path.join(root, "output", exp_dir, "wider_val", "appar_*")))
    if not runs:
        raise SystemExit(
            f"eval finished but no run directory matches "
            f"{root}/output/{exp_dir}/wider_val/appar_* — if extra "
            "--amend pairs override NAME or EXP_DIR the harness cannot "
            "find its output; let ap_parity own those two keys")
    out = runs[-1]
    with open(os.path.join(out, "stderr.log")) as f:
        m = AP_RE.findall(f.read())
    ap = tuple(float(v) for v in m[-1]) if m else None
    return os.path.join(out, "result.tar.gz"), ap


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("wider_root", help="WIDER_FACE root (or `synth` with "
                                      "--dry-run)")
    p.add_argument("weights", help=".caffemodel or .npz (or `synth` with "
                                   "--dry-run)")
    p.add_argument("--dry-run", action="store_true",
                   help="build synthetic data (and weights when `synth`) "
                        "instead of requiring the real artifacts")
    p.add_argument("--n-images", type=int, default=40,
                   help="synthetic image count for --dry-run")
    p.add_argument("--iou", type=float, default=0.5)
    p.add_argument("--score-tol", type=float, default=0.01)
    p.add_argument("--amend", nargs="*", default=[],
                   help="extra KEY VALUE amends for BOTH eval runs")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the evaluations' device (the card by default)")
    p.add_argument("--cli", default="",
                   help="a script to run instead of `-m "
                        "smallhardface_tpu_torch` (test hook: a wrapper "
                        "that shrinks the backbone)")
    args = p.parse_args(argv)
    from smallhardface_tpu_torch.config import (cfg, cfg_from_file,
                                                cfg_from_list)
    # the evaluations' model: the report and the fixture use its spec
    cfg_from_file(os.path.join(REPO, CONF))
    if args.amend:
        cfg_from_list(list(args.amend))

    data = args.wider_root
    if args.dry_run and (data == "synth" or not os.path.isdir(data)):
        data = tempfile.mkdtemp(prefix="ap_parity_synth_")
        sys.path.insert(0, os.path.join(REPO, "scripts"))
        import synth_wider
        synth_wider.build(data, n_images=args.n_images, im_size=256,
                          faces_per_image=2, seed=0)
        print(f"== built synthetic WIDER at {data}")
    validate_layout(data)

    weights = args.weights
    if args.dry_run and weights == "synth":
        import torch

        from smallhardface_tpu_torch.io import caffemodel
        from smallhardface_tpu_torch.models import detector as dm
        spec = dm.build_spec(cfg)
        params = dm.init_params(torch.Generator().manual_seed(3), spec)
        weights = os.path.join(data, "synth.caffemodel")
        caffemodel.export_params(weights, params)
        print(f"== built random-init caffemodel fixture at {weights}")
    if not os.path.exists(weights):
        raise SystemExit(f"weights not found: {weights}")
    weights_report(weights)

    tar_dev, ap_dev = run_eval(weights, data, "ap_parity_dev",
                               list(args.amend), args.cli, args.device)
    tar_host, ap_host = run_eval(
        weights, data, "ap_parity_host",
        list(args.amend) + ["TPU.HOST_PREPROC", "True"], args.cli,
        args.device)

    print(f"== device path AP (easy/medium/hard): {ap_dev}")
    print(f"== host   path AP (easy/medium/hard): {ap_host}")
    print("== reference published (README.md:5-7): (0.957, 0.949, 0.897)")
    subprocess.run(
        [sys.executable, "-m", "smallhardface_tpu_torch.tools.compare_dets",
         tar_dev, tar_host, "--iou", str(args.iou),
         "--score-tol", str(args.score_tol)],
        cwd=REPO, check=True)
    if ap_dev is None or ap_host is None:
        raise SystemExit("could not parse AP from a run log")
    delta = max(abs(a - b) for a, b in zip(ap_dev, ap_host))
    verdict = "OK" if delta <= AP_TOL else "DIVERGENT"
    print(f"== PARITY {verdict}: max AP delta device-vs-host "
          f"{delta:.4f}")
    return 0 if verdict == "OK" else 1


if __name__ == "__main__":
    sys.exit(main())
