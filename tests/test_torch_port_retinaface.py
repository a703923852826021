"""RetinaFace-ResNet50 (``models/retinaface.py``) against its plain
reference (``tests/retinaface_ref.py``), on the CPU at the published
widths on inputs of at most 96×128, with seeded random weights whose
batch norms are set by one probe forward (as the benchmark sets them):

- the forward, padded inside a larger bucket at an extent that is no
  multiple of 32, on both routes of the 3×3 convolutions;
- the priors and the decode, and one level's selection;
- one image's detections at two small scales with flip and the vote;
- the state dict in Pytorch_Retinaface's layout, with and without the
  "module." prefix of a DataParallel save, and the port's ``.npz``;
- the benchmark's configuration against the port's TOML, the clear
  errors of what RetinaFace does not run, the benchmark's copy of the
  reference, the wait spans of its detection.

Tolerances: the port folds each batch norm into its convolution's fp32
weight and bias, and sums its convolutions in other orders (cuDNN's in
another layout, or nine products); through the 16 bottlenecks those
last-bit differences grow to at most about 2e-5 of each output's largest
magnitude (1e-12 in float64, where the graph is the same to rounding),
so RTOL is 2e-4; TF32's rounding misses it by far. Detections are held
to the benchmark's strict rule (IoU ≥ 0.99, |Δscore| ≤ 1e-3).
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
import retinaface_ref as ref
from portbench import common
from portbench.gen import images
from portbench.reference import compare
from smallhardface_tpu_torch import test_runner
from smallhardface_tpu_torch.config import (PORT_CONFIG_DIR, cfg,
                                            cfg_from_file, cfg_from_list)
from smallhardface_tpu_torch.detect import TorchDetector
from smallhardface_tpu_torch.io import checkpoint, weights
from smallhardface_tpu_torch.io import retinaface as rio
from smallhardface_tpu_torch.models import layers
from smallhardface_tpu_torch.models import retinaface as rm
from smallhardface_tpu_torch.ops import anchors, decode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOML = os.path.join(PORT_CONFIG_DIR, "retinaface-r50.toml")
MEAN = np.array([104, 117, 123], np.float32)
# of each output's largest magnitude (module docstring)
RTOL = 2e-4


def _image(h, w, seed):
    return images.background(h, w, np.random.default_rng(seed))


@pytest.fixture(scope="module")
def net():
    """The reference with seeded weights, its batch norms set by a probe
    forward over a 96×128 image and its class heads biased so that 3.5 %
    of the probe's priors pass the 0.02 cut."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    model = ref.RetinaFace()
    ref.init_weights(model, 2 ** 31 + 5)
    x = torch.from_numpy(_image(96, 128, 1).astype(np.float32) - MEAN)
    x = x.permute(2, 0, 1)[None].contiguous()
    ref.probe_bn(model, x)
    ref.background_bias(model, x, common.PASS_SHARE, 0.02)
    yield model
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params(net):
    return rio.load_state_dict(net.state_dict())


@pytest.fixture
def retina_cfg():
    """The port's config under the RetinaFace TOML at two small scales;
    restored after."""
    saved = copy.deepcopy(cfg)
    try:
        cfg_from_file(TOML)
        cfg_from_list(["TEST.SCALES", "[64, 96]",
                       "TEST.PYRAMID_BASE_SIZE", "[64, 4000]"])
        yield cfg
    finally:
        cfg.clear()
        cfg.update(saved)


def flat_outputs(out, h, w):
    """The port's outputs of an image of extent (h, w) in
    Pytorch_Retinaface's test-phase layout: each level cut to its valid
    grid (ceil(h / s) × ceil(w / s)) and flattened in (level, row,
    column, anchor) order. Returns (class probabilities (B, N, 2) after
    the softmax, box deltas (B, N, 4), landmark deltas (B, N, 10))."""
    def flat(levels):
        return torch.cat([t[:, :-(-h // s), :-(-w // s)].reshape(
            t.shape[0], -1, t.shape[-1]) for t, s in zip(levels, rm.STEPS)],
            1)
    return (torch.softmax(flat(out["cls_logits"]), dim=-1),
            flat(out["bbox_deltas"]), flat(out["landm_deltas"]))


def _ref_outputs(net, img):
    with torch.no_grad(), ref.numerics("fp32"):
        return net(img.permute(0, 3, 1, 2).contiguous())


def _close(got, want):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= RTOL * scale, (err, scale)


@pytest.mark.parametrize("route", ["cudnn", "nine_products"])
def test_forward_matches_reference_inside_a_bucket(net, params, route,
                                                   monkeypatch):
    """A 75×99 extent (no multiple of 32) inside a 96×128 bucket: every
    level's class probabilities, box and landmark deltas on its valid grid
    against the reference run at 75×99."""
    if route == "nine_products":
        monkeypatch.setattr(layers, "TAPS_MIN_FLOP", 0.0)
    h, w = 75, 99
    img = torch.from_numpy(np.stack([_image(h, w, 3), _image(h, w, 4)])
                           .astype(np.float32) - MEAN)
    x = torch.zeros(2, 96, 128, 3)
    x[:, :h, :w] = img
    with torch.inference_mode():
        out = rm.RetinaFace(params, "cpu")(x, (h, w))
    conf, loc, landm = flat_outputs(out, h, w)
    want_loc, want_conf, want_landm = _ref_outputs(net, img)
    assert conf.shape == want_conf.shape == (2, 2 * (130 + 35 + 12), 2)
    _close(conf, want_conf)
    _close(loc, want_loc)
    _close(landm, want_landm)


def test_priors_and_decode_match_reference():
    """The prior grid and the variance decode equal the reference's to the
    bit on each map's valid grid, and one level's selection keeps the
    reference's rows in its order."""
    h, w = 75, 99
    g = torch.Generator().manual_seed(5)
    grids, deltas, probs, valid = [], [], [], []
    for step, sizes in zip(rm.STEPS, rm.MIN_SIZES):
        fh, fw = 128 // step, 160 // step       # a bucket's map
        grids.append(anchors.prior_grid(fh, fw, step, sizes))
        deltas.append(torch.randn(2, fh, fw, 2, 4, generator=g))
        probs.append(torch.rand(2, fh, fw, 2, generator=g))
        valid.append((-(-h // step), -(-w // step)))

    def flat(ts):
        return torch.cat([t[..., :vh, :vw, :, :].reshape(
            *t.shape[:-4], -1, t.shape[-1])
            for t, (vh, vw) in zip(ts, valid)], -2)
    pri = ref.priors(h, w, "cpu")
    assert torch.equal(flat(grids), pri)
    d = flat(deltas)
    assert torch.equal(decode.decode_priors(flat(grids), d, rm.VARIANCES),
                       ref.decode(d, pri[None]))
    boxes, scores, n = decode.decode_priors_batch(
        probs, deltas, grids, valid=valid, variances=rm.VARIANCES,
        score_thresh=0.3, capacity=200)
    p = flat([q[..., None] for q in probs])[..., 0]
    s, order = torch.sort(p, dim=1, descending=True, stable=True)
    assert torch.equal(scores, s[:, :200])
    assert torch.equal(boxes, torch.gather(
        ref.decode(d, pri[None]), 1, order[:, :200, None].expand(-1, -1, 4)))
    assert torch.equal(n, (p >= 0.3).sum(1).clamp(1, 200).int())


def test_detections_match_reference(net, params, retina_cfg):
    """One 72×96 image at short edges 64 and 96 with flip, the 0.02 cut,
    the top VOTE_CAP rows and the vote: the port's detect against the
    reference's, under the strict rule."""
    im = _image(72, 96, 6)
    got = TorchDetector(params, None, "cpu").detect(im, 0.02)[0][0]
    tree = json.loads(json.dumps(retina_cfg))
    want = ref.detect(net, im, tree, "cpu", 0.02)
    assert len(want) > 10
    nums = compare.detections([(want, got)], "float32")
    assert nums["det_unmatched_pct.strict"] == 0.0, nums


@pytest.mark.parametrize("form", ["pth", "pth_module_prefix", "npz"])
def test_weights_files_load_into_the_port(net, params, retina_cfg, tmp_path,
                                          form):
    """TEST.MODEL naming a Pytorch_Retinaface state dict (as saved, and as
    a DataParallel saves it, every key under "module."), or the port's
    .npz of the folded weights: the same parameters, the same outputs."""
    sd = net.state_dict()
    path = str(tmp_path / f"w.{form[:3]}")
    if form == "npz":
        checkpoint.save(path, weights.params_to_numpy(params))
    else:
        prefix = "module." if form == "pth_module_prefix" else ""
        torch.save({prefix + k: v for k, v in sd.items()}, path)
    retina_cfg.TEST.MODEL = path
    got = test_runner._load_params(None)
    assert set(got) == set(params)
    for name, leaf in params.items():
        for k, v in leaf.items():
            assert torch.equal(got[name][k], v), (name, k)
    x = torch.from_numpy(_image(64, 64, 8).astype(np.float32) - MEAN)[None]
    with torch.inference_mode():
        a = rm.RetinaFace(got, "cpu")(x)
        b = rm.RetinaFace(params, "cpu")(x)
    for key in a:
        assert all(torch.equal(u, v) for u, v in zip(a[key], b[key]))


@pytest.mark.parametrize("route", ["port_toml", "amend_pairs"])
def test_benchmark_configuration_is_the_port_toml(route):
    """``portbench/configs/retinaface-r50-fp32.json`` (the schema and its
    amend pairs, read as TOML literals) builds the tree the port's ``cfg``
    holds after ``--conf smallhardface_tpu_torch/configs/retinaface-r50.toml``,
    and after the benchmark loads the configuration into the port (the
    schema, then the amend pairs through ``cfg_from_list``), value and
    type alike."""
    conf = common.load_json(os.path.join(
        ROOT, "portbench", "configs", "retinaface-r50-fp32.json"))
    tree = common.config_dict(conf)
    saved = copy.deepcopy(cfg)
    try:
        if route == "port_toml":
            cfg_from_file(TOML)
        else:
            cfg_from_file(os.path.join(ROOT, conf["toml"]))
            cfg_from_list(list(conf["amend"]))

        def same(a, b, path=""):
            for k, v in a.items():
                if isinstance(v, dict):
                    same(v, b[k], f"{path}{k}.")
                elif k not in ("DATA_DIR",):
                    assert type(b[k]) is type(v) and b[k] == v, (
                        path + k, b[k], v)
        same(tree, cfg)
        assert tree["MODEL"]["ARCH"] == rm.ARCH
    finally:
        cfg.clear()
        cfg.update(saved)


def test_benchmark_counts_are_the_model_flops():
    """The benchmark's frozen operation count of a level
    (``portbench/yardstick/counts_retinaface.py``) is the model's
    ``forward_flops`` at the protocol's largest level."""
    from portbench.yardstick import counts_retinaface
    rows = counts_retinaface.forward(1700, 2267, 2)
    assert len(rows) == len(rm.conv_table())
    assert sum(r["ops"] for r in rows) == rm.forward_flops(1700, 2267, 2)


def _train(params):
    from smallhardface_tpu_torch.train import train_loop
    train_loop.train_net([], "unused", None, 1, device="cpu")


@pytest.mark.parametrize("case", ["int8", "bfloat16", "spatial",
                                  "host_preproc", "detect_many", "train"])
def test_out_of_scope_paths_raise(params, retina_cfg, case):
    """What RetinaFace does not run raises one clear error."""
    if case in ("int8", "bfloat16"):
        retina_cfg.TPU.PRECISION = case
        with pytest.raises(ValueError, match="float32 only"):
            TorchDetector(params, None, "cpu")
    elif case == "spatial":
        with pytest.raises(ValueError, match="spatially sharded"):
            TorchDetector(params, None, spatial_devices=["cpu"] * 2)
    elif case == "host_preproc":
        retina_cfg.TPU.HOST_PREPROC = True
        with pytest.raises(ValueError, match="host preprocessing"):
            TorchDetector(params, None, "cpu")
    elif case == "detect_many":
        det = TorchDetector(params, None, "cpu")
        with pytest.raises(NotImplementedError, match="one image at a time"):
            det.detect_many([_image(64, 64, 0)] * 2)
    else:
        with pytest.raises(NotImplementedError, match="detection only"):
            _train(params)


def test_benchmark_copy_of_the_reference_is_the_same_forward(net):
    """``portbench/reference/retinaface.py`` computes what this file's
    reference computes, to the bit, on the same weights."""
    from portbench.reference import retinaface as bench_ref
    other = bench_ref.RetinaFace()
    other.load_state_dict(net.state_dict())
    other.eval()
    x = torch.from_numpy(_image(64, 96, 9).astype(np.float32) - MEAN)
    with torch.no_grad():
        a = net(x.permute(2, 0, 1)[None].contiguous())
        b = other(x.permute(2, 0, 1)[None].contiguous())
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert torch.equal(bench_ref.priors(75, 99, "cpu"),
                       ref.priors(75, 99, "cpu"))


def test_detect_wait_spans(params, retina_cfg):
    """RetinaFace's ``detect_async`` + ``finalize_async``: the shared
    preprocessing's six waits a level, no wait in its decode (the extents
    are host numbers, the priors built on the device), the readback's
    two; the same detections with the hook as without."""
    from test_torch_port_waits import Recorder, fp32_detect
    det = TorchDetector(params, None, "cpu")
    im = _image(72, 96, 7)
    plain = fp32_detect(det, im)
    rec = Recorder()
    det.stages = rec
    got = fp32_detect(det, im)
    assert np.array_equal(got, plain)
    want = [("prep", None), ("upload", None), ("wait_upload", None)]
    for li in range(2):
        want += ([("preproc", li)] + [("wait_preproc", li)] * 6
                 + [("forward", li), ("decode", li)])
    want += [("decode", None), ("vote", None), ("readback", None),
             ("wait_readback", None), ("wait_readback", None)]
    assert rec.names() == want
    rec.check_nesting()
