"""End-to-end learning proof of the port: train -> final.npz -> test ->
WIDER-protocol AP.

Counterpart of ``scripts/overfit_check.py``. It builds a tiny synthetic
WIDER tree (``scripts/synth_wider.build``: 4 images, 2 face glyphs each,
seed 0), trains the flagship config from random init through the port's
command line (``python -m smallhardface_tpu_torch --train true --test
true``) with the JAX script's ``--conf`` and ``--amend`` pairs, key for
key (a 0.001 base rate dropped at 2/3 of the run, augmentation and
hard-image mining off, no pretrained weights), and reads the AP of the
trained ``final.npz`` on its own training images under the full WIDER
protocol (detections -> per-image txt -> ``wider_eval`` PR/AP) from the
run's ``stderr.log``. It passes when each of easy, medium and hard is
above 0.95.

  python -m smallhardface_tpu_torch.tools.overfit_check [--iters 300]
      [--ndev 1] [--im-size 192] [--device cuda] [--amend KEY VALUE ...]

``--ndev N > 1`` trains data parallel, one process per card under
``python -m torch.distributed.run --standalone --nproc_per_node N``.
``--device cuda`` (the default) fails without a card; ``--device cpu``
runs on the CPU (hours at full width). ``--cli`` runs a script instead of
``-m smallhardface_tpu_torch`` (a test hook: a wrapper that shrinks the
backbone).
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import subprocess
import sys
import tempfile

from smallhardface_tpu_torch.tools.ap_parity import AP_RE

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONF = os.path.join("smallhardface_tpu", "configs", "smallhardface.toml")
NAME, EXP_DIR = "overfit_check", "synth"
N_IMAGES = 4                # the tree's images, trained on and tested on
AP_MIN = 0.95


def command(iters, n_dev, im_size, out_root, data_dir, device="cuda",
            cli="", extra_amends=()):
    """The command line of the run (scripts/overfit_check.py:52-79, with
    the port's entry point and ``--device``)."""
    launch = [sys.executable]
    if n_dev > 1:
        launch += ["-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node", str(n_dev)]
    entry = [cli] if cli else ["-m", "smallhardface_tpu_torch"]
    return launch + entry + [
        "--train", "true", "--test", "true", "--device", device,
        "--conf", CONF,
        "--amend",
        "ROOT_DIR", out_root,
        "DATA_DIR", data_dir,
        "NAME", NAME,
        "EXP_DIR", EXP_DIR,
        "TRAIN.ITERS", str(iters),
        "TRAIN.SNAPSHOT", str(iters),
        "TRAIN.ITERSIZE", "1",
        "TRAIN.SCALES.SHORT_SIDE", f"[{im_size}]",
        "TRAIN.AUGMENT.ENABLE", "False",
        "TRAIN.DISABLE_EASY_IMAGE.ENABLE", "False",
        "TRAIN.LR.BASELR", "0.001",
        "TRAIN.STEPSIZE", str(max(iters * 2 // 3, 1)),
        "TRAIN.PRETRAINED", "",
        "TPU.NUM_DEVICES", str(n_dev),
        "TEST.SCALES", f"[{im_size}]",
        "TEST.MAX_SIZE", str(2 * im_size),
        *extra_amends,
    ]


def run_dirs(out_root):
    """{imdb name: the run directory} of a check's output under
    ``out_root`` (``wider_train``: final.npz; ``wider_val``:
    detections.pkl, result.tar.gz)."""
    return {os.path.basename(os.path.dirname(d)): d for d in sorted(
        glob.glob(os.path.join(out_root, "output", EXP_DIR, "*",
                               f"{NAME}_*")))}


def run(iters=300, n_dev=1, im_size=192, device="cuda", cli="",
        extra_amends=(), work=None, in_process=False, verbose=True):
    """Build the tree, train and test through the command line; returns
    the (easy, medium, hard) AP. The tree goes to ``<work>/wider`` and the
    runs under ``<work>/output`` (``run_dirs(work)``), kept when ``work``
    is given, else in a temporary directory that is removed.
    ``in_process``: call ``__main__.main`` in this process (one process
    only, the port's own entry point), so that its kernel launches count
    here."""
    if device == "cuda":
        from smallhardface_tpu_torch.utils.device import resolve_device
        resolve_device(device)          # no card: raises before any work
    if in_process and (n_dev > 1 or cli):
        raise ValueError("in_process runs one process of the port's own "
                         "command line: n_dev 1 and no cli")
    keep = work is not None
    work = work or tempfile.mkdtemp(prefix="overfit_check_")
    try:
        data_dir = os.path.join(work, "wider")
        sys.path.insert(0, os.path.join(REPO, "scripts"))
        import synth_wider
        synth_wider.build(data_dir, n_images=N_IMAGES, im_size=im_size,
                          faces_per_image=2, seed=0)
        cmd = command(iters, n_dev, im_size, work, data_dir, device, cli,
                      extra_amends)
        if in_process:
            from smallhardface_tpu_torch import __main__ as port_cli
            args = cmd[cmd.index("--train"):]
            args[args.index("--conf") + 1] = os.path.join(REPO, CONF)
            port_cli.main(args)
        else:
            proc = subprocess.run(cmd, cwd=REPO, capture_output=True,
                                  text=True, timeout=7200)
        log_text = ""
        for d in run_dirs(work).values():
            with open(os.path.join(d, "stderr.log")) as f:
                log_text += f.read()
        if not in_process and proc.returncode != 0:
            raise RuntimeError(
                f"CLI failed rc={proc.returncode}\nstdout:\n"
                f"{proc.stdout[-3000:]}\nstderr:\n{proc.stderr[-3000:]}\n"
                f"log:\n{log_text[-5000:]}")
        found = AP_RE.findall(log_text)
        if not found:
            raise RuntimeError(
                f"No AP line found in logs\nlog:\n{log_text[-5000:]}")
        aps = tuple(float(v) for v in found[-1])
        if verbose:
            tail = [ln for ln in log_text.splitlines()
                    if "iter " in ln or "Easy:" in ln]
            print("\n".join(tail[-12:]))
            print(f"AP easy/medium/hard = {aps}")
        return aps
    finally:
        if not keep:
            shutil.rmtree(work, ignore_errors=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--ndev", type=int, default=1,
                   help="ranks (cards) under torch.distributed.run; 1 runs "
                        "one process")
    p.add_argument("--im-size", type=int, default=192)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the run trains and tests (the card by "
                        "default)")
    p.add_argument("--cli", default="",
                   help="a script to run instead of `-m "
                        "smallhardface_tpu_torch` (test hook: a wrapper "
                        "that shrinks the backbone)")
    p.add_argument("--amend", nargs="*", default=[],
                   help="extra KEY VALUE pairs appended to the command "
                        "line's --amend list")
    args = p.parse_args(argv)
    aps = run(iters=args.iters, n_dev=args.ndev, im_size=args.im_size,
              device=args.device, cli=args.cli,
              extra_amends=tuple(args.amend))
    if min(aps) <= AP_MIN:
        raise SystemExit(f"overfit check FAILED: AP={aps}")
    print(f"OVERFIT CHECK PASSED: AP={aps}")


if __name__ == "__main__":
    main()
