"""The port's end-to-end learning proof (smallhardface_tpu_torch/tools/
overfit_check.py) on the CPU:

- its command line against the JAX script's (scripts/overfit_check.py,
  whose subprocess call is replaced by one that captures the command and
  raises): the same ``--train``/``--test``, ``--conf`` and ``--amend``
  pairs in the same order, key for key and value for value (the two
  temporary directories aside), bar the port's ``--device``; over
  ``--ndev`` 2 the port's command runs under ``torch.distributed.run``;
- the tool end to end at skeletal width (a ``--cli`` wrapper that shrinks
  the backbone and the training bucket, as tests/test_torch_port_ap_parity
  .py does): 2 iterations from random init, an (easy, medium, hard) triple
  in [0, 1], ``final.npz`` and ``detections.pkl`` in the run's
  directories;
- its verdict: a triple with a member at or below 0.95 exits non-zero with
  "FAILED", one above it passes;
- ``--device cuda`` without a card exits non-zero before any work.

The full-width 400-iteration run needs the card: ``chip_smoke.py``'s
``overfit`` phase."""

import importlib.util
import os
import subprocess
import sys
import types

import pytest

from smallhardface_tpu_torch.io import checkpoint
from smallhardface_tpu_torch.tools import overfit_check
import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKELETAL = (("conv1", 8, 1), ("conv2", 8, 1), ("conv3", 16, 1),
            ("conv4", 16, 1), ("conv5", 16, 1))
# the command line with the skeletal backbone and a 32-pixel bucket; the
# WIDER evaluation's spawned pool imports the main module again, so the
# entry point is guarded
WRAPPER = r"""
import sys
sys.path.insert(0, {repo!r})
from smallhardface_tpu_torch.models import detector as tdm
from smallhardface_tpu_torch.train import train_loop
tdm.VGG_STAGES = {stages!r}
train_loop.BUCKET = 32
if __name__ == "__main__":
    from smallhardface_tpu_torch import __main__ as cli
    cli.main()
"""


class _Captured(Exception):
    pass


def _capture(module, monkeypatch):
    """Replace ``module``'s subprocess with one whose ``run`` records the
    command and raises."""
    seen = {}

    def run(cmd, **kwargs):
        seen["cmd"] = list(cmd)
        raise _Captured
    monkeypatch.setattr(module, "subprocess", types.SimpleNamespace(run=run))
    return seen


def _split(cmd):
    """(the arguments before --amend, the --amend pairs)."""
    i = cmd.index("--amend")
    rest = cmd[i + 1:]
    return cmd[:i], list(zip(rest[::2], rest[1::2]))


@pytest.mark.parametrize("iters,im_size,ndev",
                         [(300, 192, 1), (400, 192, 2), (3, 256, 1)])
def test_command_matches_the_jax_script(iters, im_size, ndev, tmp_path,
                                        monkeypatch):
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    spec = importlib.util.spec_from_file_location(
        "jax_overfit_check", os.path.join(REPO, "scripts", "overfit_check.py"))
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    jax_seen = _capture(jax_script, monkeypatch)
    with pytest.raises(_Captured):
        jax_script.run(iters=iters, n_dev=ndev, im_size=im_size,
                       verbose=False)
    port_seen = _capture(overfit_check, monkeypatch)
    with pytest.raises(_Captured):
        overfit_check.run(iters=iters, n_dev=ndev, im_size=im_size,
                          device="cpu", work=str(tmp_path / "port"),
                          verbose=False)
    jax_head, jax_pairs = _split(jax_seen["cmd"])
    port_head, port_pairs = _split(port_seen["cmd"])
    assert jax_head[1] == "train_test.py"
    launcher = ["-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", str(ndev)] if ndev > 1 else []
    assert port_head == ([sys.executable] + launcher
                         + ["-m", "smallhardface_tpu_torch"]
                         + jax_head[2:6] + ["--device", "cpu"]
                         + jax_head[6:])
    assert [k for k, _ in port_pairs] == [k for k, _ in jax_pairs]
    for (key, got), (_, want) in zip(port_pairs, jax_pairs):
        if key not in ("ROOT_DIR", "DATA_DIR"):     # temporary directories
            assert got == want, key
    assert dict(port_pairs)["TPU.NUM_DEVICES"] == str(ndev)


def test_skeletal_run_end_to_end(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    cli = str(tmp_path / "cli.py")
    with open(cli, "w") as f:
        f.write(WRAPPER.format(repo=REPO, stages=SKELETAL))
    work = str(tmp_path / "run")
    aps = overfit_check.run(iters=2, device="cpu", cli=cli,
                            extra_amends=("TEST.NO_CACHE", "False"),
                            work=work, verbose=False)
    assert len(aps) == 3 and all(0.0 <= a <= 1.0 for a in aps), aps
    dirs = overfit_check.run_dirs(work)
    assert os.path.exists(os.path.join(dirs["wider_train"], "final.npz"))
    assert os.path.exists(os.path.join(dirs["wider_val"], "detections.pkl"))
    assert checkpoint.load(os.path.join(dirs["wider_train"],
                                        "final.npz"))[2] == 2


@pytest.mark.parametrize("aps,passes", [
    ((0.95, 1.0, 1.0), False), ((1.0, 1.0, 0.0), False),
    ((0.951, 0.96, 1.0), True)])
def test_verdict(aps, passes, monkeypatch, capsys):
    monkeypatch.setattr(overfit_check, "run", lambda **kwargs: aps)
    if passes:
        overfit_check.main(["--device", "cpu"])
        assert f"OVERFIT CHECK PASSED: AP={aps}" in capsys.readouterr().out
    else:
        with pytest.raises(SystemExit) as e:
            overfit_check.main(["--device", "cpu"])
        assert e.value.code != 0 and "FAILED" in str(e.value.code)


def test_device_cuda_without_a_card_fails(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: --device cuda works")
    proc = subprocess.run(
        [sys.executable, "-m", "smallhardface_tpu_torch.tools.overfit_check",
         "--iters", "1"], cwd=str(tmp_path), capture_output=True, text=True,
        timeout=240, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert os.listdir(str(tmp_path)) == []
