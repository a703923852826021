"""The models' seam (``smallhardface_tpu_torch/models/__init__.py``): every
model of ``models.MODELS`` answers the same names on the CPU at skeletal
width, and an unknown ``MODEL.ARCH`` raises one clear error wherever it
is read."""

import contextlib
import copy
import os

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from portbench.gen import images
from smallhardface_tpu_torch import models, test_runner
from smallhardface_tpu_torch.config import PORT_CONFIG_DIR, cfg, cfg_from_file
from smallhardface_tpu_torch.detect import TorchDetector
from smallhardface_tpu_torch.io import checkpoint, weights
from smallhardface_tpu_torch.models import detector as tdm
from smallhardface_tpu_torch.models import retinaface as rm

SKELETAL = (("conv1", 8, 1), ("conv2", 8, 1), ("conv3", 16, 1),
            ("conv4", 16, 1), ("conv5", 16, 1))
# ResNet-50's layout at an eighth of its widths: one bottleneck a layer
RESNET_SKELETAL = ((8, 1, 1), (16, 1, 2), (32, 1, 2), (64, 1, 2))
TOML = {"smallhardface": None,
        "retinaface_r50": os.path.join(PORT_CONFIG_DIR, "retinaface-r50.toml")}


@pytest.fixture
def arch_cfg(request, monkeypatch):
    """The port's config under the model's TOML at one small scale with
    flip, the models at skeletal width; restored after."""
    monkeypatch.setattr(tdm, "VGG_STAGES", SKELETAL)
    monkeypatch.setattr(rm, "RESNET50", RESNET_SKELETAL)
    monkeypatch.setattr(rm, "FPN_IN", tuple(4 * p for p, _, _ in
                                            RESNET_SKELETAL[1:]))
    monkeypatch.setattr(rm, "OUT", 32)
    saved = copy.deepcopy(cfg)
    try:
        if TOML.get(request.param):
            cfg_from_file(TOML[request.param])
        cfg.MODEL.ARCH = request.param
        cfg.TEST.SCALES = [72]
        cfg.TEST.FLIP = True
        cfg.TEST.MODEL = ""
        yield cfg
    finally:
        cfg.clear()
        cfg.update(saved)


@pytest.mark.parametrize("arch_cfg", sorted(models.MODELS) + ["no_such"],
                         indirect=True)
def test_every_model_answers_the_seam(arch_cfg, tmp_path):
    """For each arch: ``for_config`` gives the module that names it, with
    its detection cut; ``load_params`` draws the same random weights from
    one seed, as ``test_runner._load_params`` does, and reads back its
    ``.npz``; ``refuse`` lets single-image fp32 detection through;
    ``build``'s forward answers ``level_extent`` and ``decode_level`` on
    one image's level (rows at full capacity, the image's width and
    scale), and ``TorchDetector.detect`` runs through them. An unknown
    arch raises today's ValueError from ``for_config``, ``TorchDetector``,
    ``_load_params`` and training."""
    arch = str(arch_cfg.MODEL.ARCH)
    if arch not in models.MODELS:
        want = ("MODEL.ARCH='no_such': expected 'smallhardface' or "
                "'retinaface_r50'")
        from smallhardface_tpu_torch.train import train_loop
        for call in (lambda: models.for_config(arch_cfg),
                     lambda: TorchDetector({}, None, "cpu"),
                     lambda: test_runner._load_params(None),
                     lambda: train_loop.train_net([], "unused", None, 1,
                                                  device="cpu")):
            with pytest.raises(ValueError) as err:
                call()
            assert str(err.value) == want
        return
    mod = models.for_config(arch_cfg)
    assert mod.ARCH == arch
    assert 0 < mod.CONFIDENCE_THRESHOLD < 1
    spec = tdm.build_spec(arch_cfg)
    params = mod.load_params("", spec, 3)
    arch_cfg.RNG_SEED = 3
    same = test_runner._load_params(spec)
    arch_cfg.RNG_SEED = 4
    other = test_runner._load_params(spec)
    path = str(tmp_path / "w.npz")
    checkpoint.save(path, weights.params_to_numpy(params))
    for tree, equal in ((mod.load_params("", spec, 3), True),
                        (same, True), (mod.load_params(path, spec, 0), True),
                        (other, False)):
        assert set(tree) == set(params)
        assert equal == all(torch.equal(tree[n][k], v)
                            for n, leaf in params.items()
                            for k, v in leaf.items())
    mod.refuse(arch_cfg, "detect")

    det = TorchDetector(params, spec, "cpu")
    assert det.arch is mod
    im = images.background(60, 84, np.random.default_rng(5))
    prep = det._prep(im)
    (lv,) = prep["levels"]
    upload = torch.tensor
    valid = det.model.level_extent([lv], upload, 2, False)
    x = det._level_batch(torch.from_numpy(prep["padded"]).float()[None],
                         [lv], lv["hb"], lv["wb"])
    with torch.inference_mode():
        out = det.model(x, valid)
        boxes, scores, counts, w_s, inv_fx = det.model.decode_level(
            out, [lv], upload, 2, 0.0, 50, contextlib.nullcontext)
    assert boxes.shape == (2, 50, 4) and scores.shape == (2, 50)
    assert counts.tolist() == [50, 50]
    assert float(torch.as_tensor(w_s).max()) == lv["w_s"]
    assert float(torch.as_tensor(inv_fx).max()) == lv["inv_fx"]
    dets = det.detect(im, mod.CONFIDENCE_THRESHOLD)[0][0]
    assert dets.ndim == 2 and dets.shape[1] == 5
