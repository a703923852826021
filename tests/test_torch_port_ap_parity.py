"""The port's one-command AP-parity harness, as tests/test_ap_parity.py
runs the JAX one: ``--dry-run synth synth`` on 4 synthetic images, on the
CPU, with the skeletal backbone in the tool and in both evaluations
(fused, then ``TPU.HOST_PREPROC``), ending with both AP triples, the
``compare_dets`` table and a PARITY verdict; weights written by the JAX
package (``.caffemodel`` and ``.npz``) reported fully matched; a truncated
file failing before any evaluation; a tree that is not WIDER refused."""

import copy
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from smallhardface_tpu.config import cfg as jcfg
from smallhardface_tpu.io import caffemodel as jcaffe
from smallhardface_tpu.io import checkpoint as jckpt
from smallhardface_tpu.models import detector as jdm
from smallhardface_tpu_torch.config import cfg as tcfg
from smallhardface_tpu_torch.models import detector as tdm
from smallhardface_tpu_torch.tools import ap_parity
import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKELETAL = (("conv1", 8, 1), ("conv2", 8, 1), ("conv3", 16, 1),
            ("conv4", 16, 1), ("conv5", 16, 1))

# the tool and the command line it runs, each with the skeletal backbone;
# the WIDER evaluation's spawned pool imports the main module again, so the
# entry point is guarded
WRAPPER = r"""
import sys
sys.path.insert(0, {repo!r})
from smallhardface_tpu_torch.models import detector as tdm
tdm.VGG_STAGES = {stages!r}
if __name__ == "__main__":
    {body}
"""
TOOL_BODY = ("from smallhardface_tpu_torch.tools import ap_parity; "
             "sys.exit(ap_parity.main(sys.argv[1:]))")
CLI_BODY = "from smallhardface_tpu_torch import __main__ as cli; cli.main()"


def _script(tmp_path, name, body):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        f.write(WRAPPER.format(repo=REPO, stages=SKELETAL, body=body))
    return path


def test_dry_run_prints_both_aps_and_a_verdict(tmp_path):
    tool = _script(tmp_path, "tool.py", TOOL_BODY)
    cli = _script(tmp_path, "cli.py", CLI_BODY)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, tool, "synth", "synth", "--dry-run",
         "--n-images", "4", "--cli", cli,
         "--device", "cpu",
         "--amend", "ROOT_DIR", str(tmp_path / "out"),
         "TEST.SCALES", "[60,120]", "TEST.FLIP", "False",
         "TPU.TEST_BUCKET", "32", "TEST.N_DETS_PER_MODULE", "100",
         "TPU.VOTE_CAP", "1024"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    out = r.stdout + r.stderr
    assert r.returncode == 0, f"rc={r.returncode}\n{out[-4000:]}"
    assert "built synthetic WIDER at" in out
    assert "built random-init caffemodel fixture" in out
    assert "matched 17/17 model params" in out
    assert "device path AP" in out and "host   path AP" in out
    assert "mean match-rate" in out
    assert "PARITY OK" in out


@pytest.fixture(autouse=True)
def restore_cfg():
    """ap_parity.main loads the evaluations' config into the port's."""
    saved = copy.deepcopy(tcfg)
    yield
    tcfg.clear()
    tcfg.update(saved)


@pytest.fixture
def skeletal(monkeypatch):
    monkeypatch.setattr(jdm, "VGG_STAGES", SKELETAL)
    monkeypatch.setattr(tdm, "VGG_STAGES", SKELETAL)
    monkeypatch.setitem(jcfg.MODEL.DIFFERENT_DILATION, "ENABLE", True)
    monkeypatch.setitem(tcfg.MODEL.DIFFERENT_DILATION, "ENABLE", True)


def _jax_params():
    spec = jdm.build_spec(jcfg)
    return jax.tree_util.tree_map(
        np.asarray, jdm.init_params(jax.random.PRNGKey(5), spec))


def test_jax_written_weights_are_fully_matched(skeletal, tmp_path, capsys):
    params = _jax_params()
    caffe = str(tmp_path / "jax.caffemodel")
    jcaffe.export_params(caffe, params)
    npz = str(tmp_path / "jax.npz")
    jckpt.save(npz, params)
    n = len(tdm.param_shapes(tdm.build_spec(tcfg)))
    rep = ap_parity.weights_report(caffe)
    assert rep["matched"] == rep["params"] == n
    assert rep["unmatched_file"] == rep["unmatched_model"] == []
    assert rep["file_layers"] == n + 2         # head_1, head_2, head_4
    rep = ap_parity.weights_report(npz)
    assert rep["matched"] == rep["params"] == n
    out = capsys.readouterr().out
    assert f"matched {n}/{n} model params" in out
    assert "native checkpoint, all params loaded" in out
    assert "WARNING" not in out


@pytest.mark.parametrize("suffix", [".caffemodel", ".npz"])
def test_truncated_weights_fail_before_any_evaluation(
        suffix, skeletal, tmp_path, monkeypatch):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import synth_wider
    tree = str(tmp_path / "wider")
    synth_wider.build(tree, n_images=2, im_size=64)
    params = _jax_params()
    path = str(tmp_path / ("w" + suffix))
    if suffix == ".npz":
        jckpt.save(path, params)
    else:
        jcaffe.export_params(path, params)
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])

    def no_eval(*args, **kwargs):
        raise AssertionError("an evaluation ran on truncated weights")
    monkeypatch.setattr(ap_parity, "run_eval", no_eval)
    with pytest.raises(Exception) as info:
        ap_parity.main([tree, path, "--device", "cpu"])
    assert not isinstance(info.value, AssertionError)


def test_a_tree_that_is_not_wider_is_refused(tmp_path):
    bad = tmp_path / "not_wider"
    bad.mkdir()
    with pytest.raises(SystemExit, match="not a WIDER layout"):
        ap_parity.main([str(bad), "whatever.npz", "--device", "cpu"])


def test_shape_mismatch_in_a_checkpoint_is_refused(skeletal, tmp_path):
    params = _jax_params()
    params["head"]["w"] = np.zeros((3, 3, 16, 128), np.float32)
    path = str(tmp_path / "bad.npz")
    jckpt.save(path, params)
    with pytest.raises(ValueError, match="head/w"):
        ap_parity.weights_report(path)
