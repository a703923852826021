"""Weights between the JAX package's HWIO trees and the port's OIHW tensors
(smallhardface_tpu_torch/io/weights.py), and the port's parameter tables."""

import numpy as np
import pytest
import jax
import torch

from smallhardface_tpu.io import checkpoint
from smallhardface_tpu.models import detector as dm
from smallhardface_tpu_torch.io import weights
from smallhardface_tpu_torch.models import detector as tdm
import torch_threads  # noqa: F401


def _jax_tree(seed=7, different_dilation=True):
    spec = dm.ModelSpec(different_dilation=different_dilation)
    p = dm.init_params(jax.random.PRNGKey(seed), spec)
    return {k: {kk: np.asarray(vv) for kk, vv in v.items()}
            for k, v in p.items()}


@pytest.mark.parametrize("different_dilation", [True, False])
def test_round_trip_is_exact(different_dilation):
    tree = _jax_tree(different_dilation=different_dilation)
    tp = weights.params_from_numpy(tree)
    assert tuple(tp["conv1_2"]["w"].shape) == (64, 64, 3, 3)
    assert tuple(tp["conv5_256_up"]["w"].shape) == (256, 1, 4, 4)
    back = weights.params_to_numpy(tp)
    assert back.keys() == tree.keys()
    for name, leaf in tree.items():
        for k, v in leaf.items():
            np.testing.assert_array_equal(back[name][k], v)


def test_npz_checkpoint_loads(tmp_path):
    tree = _jax_tree(seed=3)
    path = str(tmp_path / "w.npz")
    checkpoint.save(path, tree, iteration=5)
    tp = weights.load_params(path)
    for name, leaf in tree.items():
        for k, v in leaf.items():
            t = tp[name][k]
            want = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v
            np.testing.assert_array_equal(t.numpy(), want)


@pytest.mark.parametrize("different_dilation", [True, False])
def test_tables_match_the_jax_package(different_dilation):
    spec = dm.ModelSpec(different_dilation=different_dilation)
    tspec = tdm.ModelSpec(different_dilation=different_dilation)
    assert tdm.param_shapes(tspec) == dm.param_shapes(spec)
    assert (tdm.VGG_STAGES, tdm.ANCHOR_SCALES, tdm.HEAD_DILATIONS,
            tdm.FEAT_STRIDE) == (dm.VGG_STAGES, dm.ANCHOR_SCALES,
                                 dm.HEAD_DILATIONS, dm.FEAT_STRIDE)
    for hw in ((64, 80), (1408, 1872)):
        assert tdm.forward_flops(tspec, *hw, batch=2) == dm.forward_flops(
            spec, *hw, batch=2)


def test_init_params_distributions():
    """Same shapes (OIHW), names and distributions as the JAX init: He
    backbone, 0.01 gaussian laterals/heads, zero biases, fixed bilinear
    deconv; reproducible from the generator's seed."""
    spec = tdm.ModelSpec()
    a = tdm.init_params(torch.Generator().manual_seed(3), spec)
    b = tdm.init_params(torch.Generator().manual_seed(3), spec)
    ref = _jax_tree(seed=3)
    assert a.keys() == ref.keys()
    for name, leaf in a.items():
        for k, t in leaf.items():
            want = ref[name][k]
            shape = want.transpose(3, 2, 0, 1).shape if want.ndim == 4 \
                else want.shape
            assert tuple(t.shape) == shape and t.dtype == torch.float32
            assert torch.equal(t, b[name][k])
    np.testing.assert_array_equal(a["conv5_256_up"]["w"].numpy(),
                                  ref["conv5_256_up"]["w"].transpose(3, 2, 0, 1))
    w = a["conv3_1"]["w"]                          # He: sqrt(2 / (9·128))
    assert abs(w.std().item() / np.sqrt(2 / (9 * 128)) - 1) < 0.02
    assert abs(a["head"]["w"].std().item() / 0.01 - 1) < 0.05
    assert not a["conv4_256"]["b"].any()


def test_detector_rejects_wrong_names_and_shapes():
    spec = tdm.ModelSpec()
    params = tdm.init_params(torch.Generator().manual_seed(0), spec)
    del params["head"]
    with pytest.raises(KeyError):
        tdm.Detector(params, spec, "cpu")
    params = tdm.init_params(torch.Generator().manual_seed(0), spec)
    params["conv1_1"]["w"] = params["conv1_1"]["w"].permute(2, 3, 1, 0)
    with pytest.raises(ValueError, match="conv1_1"):
        tdm.Detector(params, spec, "cpu")
