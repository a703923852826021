"""``.caffemodel`` import and export in the port
(smallhardface_tpu_torch/io/protowire.py, io/caffemodel.py) against the
JAX package's (smallhardface_tpu/io/caffemodel.py):

- the cases of tests/test_caffemodel.py and tests/test_caffemodel_v1.py
  on the port: the varint codec, a layer round trip, the full detector
  exported and loaded back, a VGG-only file loaded over an init, and the
  legacy V1 format (hand-assembled by that file's own emitters) with the
  ImageNet layout, the grouped-deconv blob, the shared-head dedup and a
  strict shape mismatch;
- the port's export_params writes the same bytes as JAX's for the same
  weights, and each package loads the other's file to the same values;
- the command line evaluates with a ``.caffemodel`` TEST.MODEL, and a
  short training run writes a final.caffemodel that loads back equal to
  its final.npz and detects as it does.
"""

import copy
import os
import pickle
import sys

import numpy as np
import pytest
import jax
import torch

from smallhardface_tpu.io import caffemodel as jcm
from smallhardface_tpu.models import detector as jdm
from smallhardface_tpu_torch.config import cfg as tcfg
from smallhardface_tpu_torch.io import caffemodel as tcm
from smallhardface_tpu_torch.io import protowire as tpw
from smallhardface_tpu_torch.io.weights import (
    load_params, params_from_numpy, params_to_numpy)
from smallhardface_tpu_torch.models import detector as tdm
from smallhardface_tpu_torch.train import train_loop as ttl
from tests.test_caffemodel_v1 import (
    V1_CONVOLUTION, V1_DECONVOLUTION, _v1_layer, _v1_net,
    _vgg16_imagenet_v1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import synth_wider  # noqa: E402

SKELETAL = (("conv1", 8, 1), ("conv2", 8, 1), ("conv3", 16, 1),
            ("conv4", 16, 1), ("conv5", 16, 1))


def _port_params(seed):
    return tdm.init_params(torch.Generator().manual_seed(seed),
                           tdm.ModelSpec(different_dilation=True))


def _jax_numpy(seed):
    params = jdm.init_params(jax.random.PRNGKey(seed),
                             jdm.ModelSpec(different_dilation=True))
    return {n: {k: np.asarray(v) for k, v in leaf.items()}
            for n, leaf in params.items()}


def _assert_trees_equal(got, want):
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        assert sorted(got[name]) == sorted(leaf), name
        for k, v in leaf.items():
            np.testing.assert_array_equal(np.asarray(got[name][k]),
                                          np.asarray(v),
                                          err_msg=f"{name}/{k}")


def test_wire_varint_roundtrip():
    for v in [0, 1, 127, 128, 300, 2 ** 32, 2 ** 60]:
        raw = tpw.write_varint(v)
        got, pos = tpw.read_varint(memoryview(raw), 0)
        assert got == v and pos == len(raw)


def test_caffemodel_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    layers = {
        "conv1_1": [rng.randn(64, 3, 3, 3).astype(np.float32),
                    rng.randn(64).astype(np.float32)],
        "fc_like": [rng.randn(10, 20, 1, 1).astype(np.float32)],
    }
    path = tmp_path / "model.caffemodel"
    tcm.write_caffemodel(path, layers)
    back = tcm.read_caffemodel(path)
    assert set(back) == set(layers)
    for name in layers:
        for a, b in zip(layers[name], back[name]):
            assert b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_export_load_roundtrip(tmp_path):
    """The port's full detector tree → .caffemodel → tree, including the
    structurally shared head and the bilinear deconv kernel; loaded leaves
    are float32 CPU tensors in the port's OIHW layout."""
    params = _port_params(0)
    path = tmp_path / "final.caffemodel"
    tcm.export_params(path, params)
    raw = tcm.read_caffemodel(path)
    assert {"head_1", "head_2", "head_4"} <= set(raw)
    np.testing.assert_array_equal(raw["head_1"][0], raw["head_4"][0])
    assert raw["conv5_256_up"][0].shape == (256, 1, 4, 4)
    loaded = tcm.load_into_params(path, _port_params(1), strict=True)
    for name, leaf in loaded.items():
        for v in leaf.values():
            assert isinstance(v, torch.Tensor) and v.dtype == torch.float32
    _assert_trees_equal(loaded, params)
    # a Detector takes the loaded tree as it is
    tdm.Detector(loaded, tdm.ModelSpec(different_dilation=True), "cpu")


def test_load_partial_backbone(tmp_path):
    """A VGG-only file (the ImageNet init path) loads its convolutions and
    leaves the head at its init."""
    src = _port_params(2)
    vgg_only = {
        name: [leaf["w"].numpy(), leaf["b"].numpy()]
        for name, leaf in src.items()
        if name.startswith(("conv1_", "conv2_", "conv3_", "conv4_", "conv5_"))
        and name not in ("conv5_256", "conv4_256", "conv5_256_up")}
    path = tmp_path / "vgg.caffemodel"
    tcm.write_caffemodel(path, vgg_only)
    fresh = _port_params(3)
    loaded = tcm.load_into_params(path, fresh)
    torch.testing.assert_close(loaded["conv3_1"]["w"], src["conv3_1"]["w"],
                               rtol=0, atol=0)
    assert loaded["head"]["w"] is fresh["head"]["w"]


def test_v1_vgg16_imagenet_load(tmp_path):
    """The legacy V1 ImageNet layout: conv layers with legacy 4-D dims (one
    bias in the unpacked encoding), fc layers skipped, the rest at init."""
    data, weights = _vgg16_imagenet_v1(np.random.RandomState(7))
    path = tmp_path / "vgg16_v1.caffemodel"
    path.write_bytes(data)
    raw = tcm.read_caffemodel(str(path))
    assert set(weights) | {"fc6", "fc7", "fc8"} == set(raw)
    assert raw["conv3_1"][0].shape == (256, 128, 3, 3)
    assert raw["conv3_1"][1].shape == (1, 1, 1, 256)
    assert raw["fc6"][0].shape == (1, 1, 32, 64)
    init = _port_params(0)
    params = tcm.load_into_params(str(path), init)
    for name, (w, b) in weights.items():
        np.testing.assert_array_equal(params[name]["w"].numpy(), w,
                                      err_msg=name)
        np.testing.assert_array_equal(params[name]["b"].numpy(), b,
                                      err_msg=name)
    for name in ("head", "conv4_fuse_final", "cls_score_1", "conv5_256",
                 "conv5_256_up"):
        assert params[name]["w"] is init[name]["w"], name


def test_v1_full_detector_load(tmp_path):
    """A trained-model-shaped V1 file: the shared head as three per-layer
    copies (the first one counts), the deconv as a grouped (C, 1, 4, 4)
    blob with a distinct kernel per channel."""
    rng = np.random.RandomState(3)
    spec = tdm.ModelSpec(different_dilation=True)
    layers, file_w = [], {}
    for name, tree in tdm.param_shapes(spec).items():
        kh, kw, ci, co = tree["w"]
        if name == "conv5_256_up":
            blob = rng.randn(co, 1, kh, kw).astype(np.float32)
            file_w[name] = (blob, None)
            layers.append(_v1_layer(name, V1_DECONVOLUTION, [blob]))
            continue
        w = rng.randn(co, ci, kh, kw).astype(np.float32)
        b = rng.randn(co).astype(np.float32)
        file_w[name] = (w, b)
        if name == "head":
            layers.append(_v1_layer("head_1", V1_CONVOLUTION, [w, b]))
            junk = rng.randn(*w.shape).astype(np.float32)
            layers.append(_v1_layer("head_2", V1_CONVOLUTION, [junk, b]))
            layers.append(_v1_layer("head_4", V1_CONVOLUTION, [junk, b]))
        else:
            layers.append(_v1_layer(name, V1_CONVOLUTION, [w, b]))
    path = tmp_path / "detector_v1.caffemodel"
    path.write_bytes(_v1_net(layers))
    params = tcm.load_into_params(str(path), _port_params(1), strict=True)
    for name, (w, b) in file_w.items():
        np.testing.assert_array_equal(params[name]["w"].numpy(), w,
                                      err_msg=name)
        if b is not None:
            np.testing.assert_array_equal(params[name]["b"].numpy(), b,
                                          err_msg=name)


def test_v1_strict_shape_mismatch(tmp_path):
    w = np.zeros((64, 3, 5, 5), np.float32)     # conv1_1 is 3×3, not 5×5
    path = tmp_path / "bad_v1.caffemodel"
    path.write_bytes(_v1_net([_v1_layer("conv1_1", V1_CONVOLUTION,
                                        [w, np.zeros(64, np.float32)])]))
    with pytest.raises(ValueError, match="conv1_1"):
        tcm.load_into_params(str(path), _port_params(0), strict=True)
    # not strict: skipped with a warning, the init kept
    init = _port_params(0)
    assert tcm.load_into_params(str(path), init)["conv1_1"]["w"] is \
        init["conv1_1"]["w"]


def test_export_bytes_equal_jax(tmp_path):
    """The same weights written by each package's export_params give the
    same file, byte for byte (layers in sorted name order, the order of a
    JAX parameter tree)."""
    tree = _jax_numpy(4)
    jax_path = tmp_path / "jax.caffemodel"
    port_path = tmp_path / "port.caffemodel"
    jcm.export_params(jax_path, tree)
    tcm.export_params(port_path, params_from_numpy(tree))
    assert jax_path.read_bytes() == port_path.read_bytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_package_load(tmp_path, writer):
    """A file written by either package loads in the port to the values
    JAX's load_into_params gives (converted to OIHW), over the same init."""
    src, init = _jax_numpy(5), _jax_numpy(6)
    path = tmp_path / f"{writer}.caffemodel"
    if writer == "jax":
        jcm.export_params(path, src)
    else:
        tcm.export_params(path, params_from_numpy(src))
    want = jcm.load_into_params(str(path), init, strict=True)
    got = tcm.load_into_params(str(path), params_from_numpy(init),
                               strict=True)
    _assert_trees_equal(params_to_numpy(got),
                        {n: {k: np.asarray(v) for k, v in leaf.items()}
                         for n, leaf in want.items()})
    _assert_trees_equal(params_to_numpy(got), src)


def test_cli_train_writes_caffemodel_and_tests_with_it(tmp_path,
                                                       monkeypatch):
    """--train true --test true on the CPU with the skeletal backbone
    writes final.caffemodel beside final.npz, equal to it; --test true
    with that file as TEST.MODEL gives the detections the .npz gave."""
    from smallhardface_tpu_torch.__main__ import main
    data_dir = str(tmp_path / "data")
    synth_wider.build(data_dir, n_images=3, im_size=96)
    monkeypatch.setattr(tdm, "VGG_STAGES", SKELETAL)
    monkeypatch.setattr(ttl, "BUCKET", 32)
    saved = copy.deepcopy(tcfg)
    exp_dir = f"torch_port_caffemodel_{os.getpid()}"
    root = os.path.join(REPO, "output", exp_dir)
    conf = os.path.join(REPO, "smallhardface_tpu", "configs",
                        "smallhardface.toml")
    common = ["DATA_DIR", data_dir, "TEST.SCALES", "[50, 90]",
              "TEST.NO_CACHE", "False", "TEST.DB", "wider_val"]
    try:
        main(["--train", "true", "--test", "true", "--device", "cpu",
              "--conf", conf, "--amend", "EXP_DIR", exp_dir,
              "TRAIN.ITERS", "2", "TRAIN.ITERSIZE", "1",
              "TRAIN.SCALES.SHORT_SIDE", "[64]", "TRAIN.SCALES.MAX_SIZE",
              "128", "TRAIN.AUGMENT.ENABLE", "False", "TPU.MAX_GT_BUCKETS",
              "[8]"] + common)
        train_dir, = (os.path.join(root, "wider_train", d)
                      for d in os.listdir(os.path.join(root, "wider_train")))
        npz = os.path.join(train_dir, "final.npz")
        caffe = os.path.join(train_dir, "final.caffemodel")
        from_npz = load_params(npz)
        _assert_trees_equal(tcm.load_into_params(caffe, from_npz,
                                                 strict=True), from_npz)

        def detections(exp):
            main(["--train", "false", "--test", "true", "--device", "cpu",
                  "--conf", conf, "--amend", "EXP_DIR", exp,
                  "TEST.MODEL", caffe] + common)
            d, = os.listdir(os.path.join(REPO, "output", exp, "wider_val"))
            with open(os.path.join(REPO, "output", exp, "wider_val", d,
                                   "detections.pkl"), "rb") as f:
                return pickle.load(f)
        got = detections(exp_dir + "_caffe")
        with open(os.path.join(
                root, "wider_val",
                os.listdir(os.path.join(root, "wider_val"))[0],
                "detections.pkl"), "rb") as f:
            want = pickle.load(f)
        assert len(got[1]) == len(want[1]) == 3
        for a, b in zip(got[1], want[1]):
            np.testing.assert_array_equal(a, b)
    finally:
        tcfg.clear()
        tcfg.update(saved)
        import shutil
        for d in (exp_dir, exp_dir + "_caffe"):
            shutil.rmtree(os.path.join(REPO, "output", d),
                          ignore_errors=True)


def test_train_from_caffemodel_pretrained(tmp_path, monkeypatch):
    """TRAIN.PRETRAINED naming a .caffemodel: training starts from its
    layers."""
    monkeypatch.setattr(tdm, "VGG_STAGES", SKELETAL)
    spec = tdm.build_spec(tcfg)
    src = tdm.init_params(torch.Generator().manual_seed(9), spec)
    path = tmp_path / "pre.caffemodel"
    tcm.export_params(path, src)
    params = ttl._init_params(spec, str(path))
    _assert_trees_equal(params, src)
