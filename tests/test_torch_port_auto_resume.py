"""TRAIN.AUTO_RESUME in the PyTorch port: the relaunch from the newest
snapshot after a sticky CUDA fault, the port's mirror of
tests/test_auto_resume.py.

A sticky CUDA error (an illegal address, a device-side assert) leaves the
process's CUDA context unusable, so the port's command line re-executes
itself (os.execve) with TRAIN.RESUME at the newest snapshot, or with
--train false after a fault in the evaluation. The faults here are the
injected ones (SHF_FAULT_ITER, SHF_FAULT_TEST), raised as a
torch.AcceleratorError with a sticky message:

(a) a fault at iteration 6 with a snapshot at 4 and one relaunch gives two
    run directories and a final.npz equal to the bit to an unfaulted run's;
(b) with no relaunch left the fault exits non-zero;
(c) a fault in the evaluation relaunches with --train false and trains
    nothing again;
(d) the --train rewrite gives what train_test._argv_train_false gives;
(e) the classifier: sticky CUDA errors are faults, running out of memory
    and non-sticky errors are not;
(f) ``python -m smallhardface_tpu_torch`` at the flagship widths comes
    back through ``-m`` after a fault (sys.orig_argv);
(g) main() called with an explicit argv re-raises and never execs.

Every CLI run is a subprocess on the CPU with its own timeout; (a)-(c)
run the skeletal network of tests/test_torch_port_train.py through a
wrapper script that the relaunch re-executes too.
"""

import copy
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = "smallhardface_tpu/configs/smallhardface.toml"
SKELETAL = (("conv1", 8, 1), ("conv2", 8, 1), ("conv3", 16, 1),
            ("conv4", 16, 1), ("conv5", 16, 1))

# The relaunch re-executes this wrapper (sys.orig_argv), so the skeletal
# backbone and the training bucket survive it; the WIDER evaluation's
# spawned pool imports it again, hence the __main__ guard.
WRAPPER = r"""
import sys
sys.path.insert(0, {repo!r})
from smallhardface_tpu_torch.models import detector as tdm
from smallhardface_tpu_torch.train import train_loop as ttl
tdm.VGG_STAGES = {stages!r}
ttl.BUCKET = 32
if __name__ == "__main__":
    from smallhardface_tpu_torch.__main__ import main
    main()
"""


def _env(fault_iter=0, fault_test=False):
    env = dict(os.environ)
    for k in ("SHF_AUTO_RESUME_LEFT", "SHF_FAULT_ITER", "SHF_FAULT_TEST"):
        env.pop(k, None)
    if fault_iter:
        env["SHF_FAULT_ITER"] = str(fault_iter)
    if fault_test:
        env["SHF_FAULT_TEST"] = "1"
    return env


def _amend(out_root, data_dir, iters, snapshot, auto_resume):
    return ["ROOT_DIR", out_root, "DATA_DIR", data_dir, "NAME", "ar",
            "EXP_DIR", "synth", "TRAIN.ITERS", str(iters),
            "TRAIN.SNAPSHOT", str(snapshot), "TRAIN.ITERSIZE", "1",
            "TRAIN.SCALES.SHORT_SIDE", "[64]", "TRAIN.SCALES.MAX_SIZE", "128",
            "TRAIN.AUGMENT.ENABLE", "False",
            "TRAIN.DISABLE_EASY_IMAGE.ENABLE", "False",
            "TRAIN.PRETRAINED", "", "TRAIN.AUTO_RESUME", str(auto_resume),
            "TPU.MAX_GT_BUCKETS", "[8]"]


def _data(tmp_path, tag):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import synth_wider
    data_dir = str(tmp_path / f"data_{tag}")
    synth_wider.build(data_dir, n_images=4, im_size=64, faces_per_image=1,
                      seed=0)
    return data_dir


def _collect(out_root):
    run_dirs = sorted(glob.glob(os.path.join(
        out_root, "output", "synth", "*", "ar_*")))
    logs = ""
    for d in run_dirs:
        lg = os.path.join(d, "stderr.log")
        if os.path.exists(lg):
            with open(lg) as f:
                logs += f"--- {d}\n" + f.read()
    return run_dirs, logs


def _run_cli(tmp_path, tag, fault_iter, auto_resume, iters=10, snapshot=4,
             do_test=False, fault_test=False):
    data_dir = _data(tmp_path, tag)
    out_root = str(tmp_path / f"out_{tag}")
    wrapper = str(tmp_path / "wrapper.py")
    if not os.path.exists(wrapper):
        with open(wrapper, "w") as f:
            f.write(WRAPPER.format(repo=REPO, stages=SKELETAL))
    cmd = [sys.executable, wrapper, "--train", "true",
           "--test", "true" if do_test else "false", "--device", "cpu",
           "--conf", CONF, "--amend"] + _amend(
               out_root, data_dir, iters, snapshot, auto_resume)
    if do_test:
        cmd += ["TEST.SCALES", "[64]", "TEST.MAX_SIZE", "128",
                "TPU.TEST_BUCKET", "32"]
    proc = subprocess.run(cmd, cwd=REPO, env=_env(fault_iter, fault_test),
                          capture_output=True, text=True, timeout=120)
    return (proc, *_collect(out_root))


def _final(run_dirs):
    finals = [os.path.join(d, "final.npz") for d in run_dirs
              if os.path.exists(os.path.join(d, "final.npz"))]
    assert len(finals) == 1, f"want exactly one final.npz, got {finals}"
    return np.load(finals[0])


def test_fault_then_auto_resume_completes_bit_identical(tmp_path):
    proc, dirs, logs = _run_cli(tmp_path, "ctl", fault_iter=0,
                                auto_resume=0)
    assert proc.returncode == 0, (
        f"control rc={proc.returncode}\n{proc.stderr[-2000:]}\n"
        f"{logs[-3000:]}")
    ctl = _final(dirs)
    assert int(ctl["meta//iteration"]) == 10

    # faulted: at iter 6 (a snapshot exists at 4), one relaunch allowed
    proc, dirs, logs = _run_cli(tmp_path, "flt", fault_iter=6,
                                auto_resume=1)
    assert proc.returncode == 0, (
        f"faulted rc={proc.returncode}\n{proc.stderr[-2000:]}\n"
        f"{logs[-3000:]}")
    assert "injected device fault, SHF_FAULT_ITER" in logs
    assert "relaunching from" in logs and "ar_iter_4.npz" in logs
    assert "Resumed from" in logs
    assert len(dirs) == 2, f"want faulted + relaunched run dirs: {dirs}"
    flt = _final(dirs)
    assert sorted(ctl.files) == sorted(flt.files)
    for k in ctl.files:
        np.testing.assert_array_equal(
            ctl[k], flt[k],
            err_msg=f"{k} differs: fault + auto-resume is not invisible")


def test_fault_without_budget_fails_loudly(tmp_path):
    """TRAIN.AUTO_RESUME 0 (the default) does not swallow the fault."""
    proc, dirs, logs = _run_cli(tmp_path, "nob", fault_iter=2,
                                auto_resume=0, iters=4, snapshot=2)
    assert proc.returncode != 0
    assert "AcceleratorError" in proc.stderr
    assert "injected device fault, SHF_FAULT_ITER" in proc.stderr
    assert "relaunching" not in logs + proc.stderr
    assert len(dirs) == 1
    assert not os.path.exists(os.path.join(dirs[0], "final.npz"))


def test_fault_in_eval_relaunches_without_retraining(tmp_path):
    """A fault during the evaluation after training does not cost the
    training: the relaunch runs with --train false and the trained weights
    as TEST.MODEL, and the WIDER evaluation completes."""
    proc, dirs, logs = _run_cli(tmp_path, "ev", fault_iter=0,
                                auto_resume=1, iters=4, snapshot=4,
                                do_test=True, fault_test=True)
    assert proc.returncode == 0, (
        f"rc={proc.returncode}\n{proc.stderr[-2000:]}\n{logs[-3000:]}")
    assert "injected device fault, SHF_FAULT_TEST" in logs
    assert "relaunching eval" in logs
    assert "Easy:" in logs, "no WIDER AP line: the evaluation never ended"
    finals = [d for d in dirs
              if os.path.exists(os.path.join(d, "final.npz"))]
    assert len(finals) == 1, (
        f"training must run exactly once, final.npz in {finals}")
    assert len([d for d in dirs if "wider_val" in d]) == 2


ARGV_CASES = [
    # space-separated
    ["py", "train_test.py", "--train", "true", "--test", "true",
     "--amend", "A", "1"],
    # the =-form
    ["py", "train_test.py", "--train=true", "--test", "true", "--amend",
     "A", "1"],
    # absent: inserted before --amend
    ["py", "train_test.py", "--test", "true", "--amend", "A", "1"],
    # amend values are REMAINDER, never rewritten even if they look like
    # flags
    ["py", "train_test.py", "--train", "true", "--amend", "LOG.CMD",
     "--train=true"],
]


@pytest.mark.parametrize("argv", ARGV_CASES)
def test_argv_train_false_matches_jax(argv):
    import train_test as tt
    from smallhardface_tpu_torch import __main__ as cli
    assert cli._argv_train_false(argv) == tt._argv_train_false(argv)


def test_argv_train_false_after_dash_m():
    """Under ``python -m`` the program's arguments start after the module
    name: the inserted pair goes there, not between -m and its module."""
    from smallhardface_tpu_torch import __main__ as cli
    argv = ["py", "-u", "-m", "smallhardface_tpu_torch", "--test", "true",
            "--amend", "A", "1"]
    assert cli._argv_train_false(argv, 4) == [
        "py", "-u", "-m", "smallhardface_tpu_torch", "--train", "false",
        "--test", "true", "--amend", "A", "1"]


def _fault_cases():
    from smallhardface_tpu_torch.utils.faults import (
        STICKY_CUDA_ERRORS, injected_fault)
    accel = torch.AcceleratorError
    # the card's message for a device-side assert (torch 2.11, CUDA 12.8)
    card = ("CUDA error: device-side assert triggered\nSearch for "
            "`cudaErrorAssert' in https://docs.nvidia.com/cuda/"
            "cuda-runtime-api/group__CUDART__TYPES.html for more "
            "information.\nCUDA kernel errors might be asynchronously "
            "reported at some other API call, so the stacktrace below "
            "might be incorrect.\n")
    faults = [accel(card), injected_fault("SHF_FAULT_ITER")]
    faults += [accel(f"CUDA error: {s}") for s in STICKY_CUDA_ERRORS]
    faults += [
        # the port's own kernels, through ops/cuda_build.check
        RuntimeError("max_iou: kernel launch failed: device-side assert "
                     "triggered"),
        RuntimeError("fused_stem: kernel launch failed: an illegal memory "
                     "access was encountered"),
        RuntimeError("CUDA error: CUBLAS_STATUS_EXECUTION_FAILED when "
                     "calling `cublasSgemm( handle, opa, opb, m, n, k, "
                     "&alpha, a, lda, b, ldb, &beta, c, ldc)`"),
        RuntimeError("cuDNN error: CUDNN_STATUS_EXECUTION_FAILED"),
        accel("CUDA error: CUBLAS_STATUS_EXECUTION_FAILED"),
    ]
    not_faults = [
        torch.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 9313.23 GiB. GPU 0 has "
            "a total capacity of 79.18 GiB"),
        ValueError("an illegal memory access was encountered"),
        ValueError("CUDA error: device-side assert triggered"),
        NotImplementedError("TPU.SPATIAL_DEVICES=2: spatial sharding is "
                            "not ported yet"),
        RuntimeError("an illegal memory access was encountered"),
        RuntimeError("CUDA error: unspecified launch failure"),
        RuntimeError("shapes do not match"),
        accel("CUDA error: invalid argument"),
        accel("CUDA error: invalid device ordinal\nGPU device may be out of "
              "range, do you have enough GPUs?"),
        RuntimeError("nvcc failed on stem.cu (1)"),
        KeyboardInterrupt(),
    ]
    return ([pytest.param(e, True, id=f"fault-{i}")
             for i, e in enumerate(faults)]
            + [pytest.param(e, False, id=f"not-{i}")
               for i, e in enumerate(not_faults)])


@pytest.mark.parametrize("exc,want", _fault_cases())
def test_device_fault_classifier(exc, want):
    from smallhardface_tpu_torch import __main__ as cli
    assert cli._device_fault(exc) is want


def test_budget_refuses_under_torch_distributed(monkeypatch):
    """More than one process: one re-executing alone would leave its peers
    waiting, so the budget gives no relaunch."""
    from smallhardface_tpu_torch import __main__ as cli
    from smallhardface_tpu_torch.utils.faults import injected_fault
    monkeypatch.setenv("SHF_AUTO_RESUME_LEFT", "2")
    exc = injected_fault("SHF_FAULT_ITER")
    assert cli._auto_resume_budget(exc) == 2
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 4)
    assert cli._auto_resume_budget(exc) is None
    monkeypatch.setenv("SHF_AUTO_RESUME_LEFT", "0")
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 1)
    assert cli._auto_resume_budget(exc) is None


def test_dash_m_relaunch_at_flagship_width(tmp_path):
    """``python -m smallhardface_tpu_torch`` with the full VGG-16: a fault
    at iteration 2 comes back through ``-m`` and finishes from the
    iteration-1 snapshot."""
    data_dir = _data(tmp_path, "m")
    out_root = str(tmp_path / "out_m")
    cmd = [sys.executable, "-m", "smallhardface_tpu_torch", "--train",
           "true", "--test", "false", "--device", "cpu", "--conf", CONF,
           "--amend"] + _amend(out_root, data_dir, 2, 1, 1)
    proc = subprocess.run(cmd, cwd=REPO, env=_env(fault_iter=2),
                          capture_output=True, text=True, timeout=180)
    dirs, logs = _collect(out_root)
    assert proc.returncode == 0, (
        f"rc={proc.returncode}\n{proc.stderr[-2000:]}\n{logs[-3000:]}")
    assert "relaunching from" in logs and "ar_iter_1.npz" in logs
    assert len(dirs) == 2, dirs
    final = _final(dirs)
    assert int(final["meta//iteration"]) == 2
    assert final["params//conv5_3//w"].shape == (3, 3, 512, 512)


def test_explicit_argv_reraises_without_exec(tmp_path, monkeypatch):
    """main(argv) from inside another program has no command line of its
    own: the fault re-raises with a note, and nothing is executed."""
    from smallhardface_tpu_torch import __main__ as cli
    from smallhardface_tpu_torch.config import cfg as tcfg
    from smallhardface_tpu_torch.models import detector as tdm
    from smallhardface_tpu_torch.train import train_loop as ttl

    def no_exec(*args):
        raise AssertionError(f"execve called: {args}")
    monkeypatch.setattr(os, "execve", no_exec)
    monkeypatch.setattr(tdm, "VGG_STAGES", SKELETAL)
    monkeypatch.setattr(ttl, "BUCKET", 32)
    monkeypatch.delenv("SHF_AUTO_RESUME_LEFT", raising=False)
    monkeypatch.setenv("SHF_FAULT_ITER", "2")
    data_dir = _data(tmp_path, "g")
    saved = copy.deepcopy(tcfg)
    try:
        with pytest.raises(torch.AcceleratorError) as info:
            cli.main(["--train", "true", "--test", "false", "--device",
                      "cpu", "--conf", os.path.join(REPO, CONF), "--amend"]
                     + _amend(str(tmp_path / "out_g"), data_dir, 4, 1, 1))
    finally:
        tcfg.clear()
        tcfg.update(saved)
    assert "SHF_FAULT_ITER" in str(info.value)
    assert any("no relaunch" in n for n in info.value.__notes__)
    dirs, _ = _collect(str(tmp_path / "out_g"))
    assert len(dirs) == 1
    assert os.path.exists(os.path.join(dirs[0], "ar_iter_1.npz"))
