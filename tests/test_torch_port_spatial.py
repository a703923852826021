"""Spatial H-sharding of detection in the port (``parallel/spatial``, K4
``ops/stem.fused_stem_spatial``, ``Detector.forward`` over shards,
``TorchDetector(spatial_devices=…)``, the spatial units of ``test_net``
and the service) against the JAX package's spatial mesh and against the
port's one-device path. k "devices" are ``["cpu"] * k`` in one process;
JAX runs on the virtual 8-device CPU mesh of ``tests/conftest.py``.

Tolerances:
- K4's plain path against the port's ``fused_stem`` on the whole image:
  the stem test's rtol 1e-5, atol 1e-5·max (the CPU's convolutions round a
  strip otherwise than the whole image; the card's K1 is equal to the
  bit, tests/test_torch_port_cuda.py); against the JAX kernel (interpret
  mode), the Pallas tolerance of ``tests/test_torch_port_stem.py``, rtol
  2e-2, atol 1 %·max (the JAX kernel feeds its dots bf16);
- the forward over shards: against JAX on ``make_spatial_mesh(4)`` rtol
  1e-4, atol 1e-4·max (``tests/test_torch_port_forward.py``), against the
  port's one-device forward atol 1e-5;
- detections, fp32 and calibrated int8: rtol 1e-4, atol 1e-3 after sorting
  (``tests/test_spatial_shard.py:51-53``, ``tests/test_int8.py:250-283``);
  dynamic int8 by the int8 tests' match rule (counts within max(2, 2 %),
  each side matched at 0.99); bf16 by the bf16 tests' loose rule (each
  side at 0.95): the padded levels run other convolution shapes, whose
  fp32 sums round differently, and bf16 and int8 amplify a last bit.
"""

import copy
import os

import cv2
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from smallhardface_tpu.config import cfg as jcfg
from smallhardface_tpu.detect import TPUDetector
from smallhardface_tpu.models import detector as jdm
from smallhardface_tpu.ops.pallas_stem import (
    fused_stem as jax_fused_stem, fused_stem_spatial as jax_stem_spatial)
from smallhardface_tpu.parallel.mesh import make_spatial_mesh
from smallhardface_tpu_torch import serve as tserve
from smallhardface_tpu_torch import test_runner
from smallhardface_tpu_torch.config import cfg as tcfg
from smallhardface_tpu_torch.detect import TorchDetector
from smallhardface_tpu_torch.io.weights import params_from_numpy
from smallhardface_tpu_torch.models import detector as tdm
from smallhardface_tpu_torch.ops import stem
from smallhardface_tpu_torch.parallel import spatial
from tests.test_full_detect_golden import _match_fraction
from tests.test_torch_port_bf16 import _loose_match

CPU = torch.device("cpu")


@pytest.fixture
def cfgs():
    """Both packages' TEST and TPU sections, restored after the test."""
    saved = [(c, copy.deepcopy(c.TEST), copy.deepcopy(c.TPU))
             for c in (jcfg, tcfg)]
    yield
    for c, test, tpu in saved:
        c.TEST.update(test)
        c.TPU.update(tpu)


def _set(**kv):
    for c in (jcfg, tcfg):
        for key, v in kv.items():
            section, name = key.split("__")
            c[section][name] = v


def _pair(seed):
    """JAX parameters from PRNGKey(seed) and the port's copy of them."""
    spec = jdm.ModelSpec(different_dilation=True)
    params = jdm.init_params(jax.random.PRNGKey(seed), spec)
    tree = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
            for k, v in params.items()}
    return spec, params, params_from_numpy(tree)


def _sorted_close(got, want, rtol=1e-4, atol=1e-3):
    assert got.shape == want.shape
    np.testing.assert_allclose(got[np.lexsort(got.T)],
                               want[np.lexsort(want.T)], rtol=rtol, atol=atol)


# ---- the shard plan and the halo ----

@pytest.mark.parametrize("h,k,want", [(112, 1, 112), (112, 4, 128),
                                      (128, 4, 128), (48, 2, 64),
                                      (1408, 4, 1408), (1440, 4, 1536)])
def test_padded_height(h, k, want):
    assert spatial.padded_height(h, k) == want


def test_halo_adds_neighbour_rows_and_nothing_at_the_edges():
    x = torch.arange(4 * 8.0).reshape(1, 1, 32, 1).expand(1, 2, 32, 3)
    shards = list(x.split(8, dim=2))
    before = spatial.halo.bytes
    out = spatial.halo(shards, 2)
    assert [rows for _, rows in out] == [(0, 2), (2, 2), (2, 2), (2, 0)]
    for i, (h, (top, bottom)) in enumerate(out):
        assert torch.equal(h, x[:, :, 8 * i - top:8 * i + 8 + bottom])
    # six neighbour blocks of 2 rows × 3 columns × 2 channels
    assert spatial.halo.bytes - before == 6 * 2 * 3 * 2 * 4
    assert torch.equal(spatial.gather(shards, dim=2), x)
    with pytest.raises(ValueError, match="cannot give"):
        spatial.halo(shards, 9)


def test_halo_carries_the_transposed_exchange_in_autograd():
    """The exchange is tensor ops only: the gradient of the haloed shards
    reaches each source row once per copy of it."""
    x = torch.randn(1, 1, 16, 2, requires_grad=True)
    out = spatial.halo(list(x.split(8, dim=2)), 1)
    sum(h.sum() for h, _ in out).backward()
    want = torch.ones(16)
    want[[7, 8]] = 2.0              # the rows either side of the boundary
    assert torch.equal(x.grad[0, 0, :, 0], want)


def test_split_and_amax():
    x = torch.randn(2, 64, 8, 3)
    shards = spatial.split(x, [CPU, CPU])
    assert [s.shape[1] for s in shards] == [32, 32]
    assert torch.equal(torch.cat(shards, 1), x)
    with pytest.raises(ValueError, match="equal shards"):
        spatial.split(x[:, :33], [CPU, CPU])
    vals = [torch.tensor([1.0, 5.0]), torch.tensor([3.0, 2.0])]
    assert torch.equal(spatial.amax(vals), torch.tensor([3.0, 5.0]))


def test_units(monkeypatch):
    assert spatial.local_devices("cpu") == [CPU]
    monkeypatch.setattr(spatial, "local_devices", lambda d: [CPU] * 4)
    assert spatial.unit("cpu", 2, 1) == [CPU, CPU]
    assert spatial.first_devices("cpu", 3) == [CPU] * 3
    with pytest.raises(ValueError, match="must divide the local device"):
        spatial.unit("cpu", 3)
    with pytest.raises(ValueError, match="needs local devices 4..5"):
        spatial.unit("cpu", 2, 2)
    with pytest.raises(ValueError, match="exceeds the 4 local devices"):
        spatial.first_devices("cpu", 8)


# ---- K4 ----

@pytest.fixture(scope="module")
def stem_weights():
    """HWIO stem weights with large biases (relu(b1) ≠ 0 in any unmasked
    halo), as tests/test_torch_port_stem.py makes them."""
    rng = np.random.RandomState(7)
    return (rng.randn(3, 3, 3, 64).astype(np.float32) * 0.1,
            rng.randn(64).astype(np.float32) * 0.5,
            rng.randn(3, 3, 64, 64).astype(np.float32) * 0.05,
            rng.randn(64).astype(np.float32) * 0.5)


def _torch_w(weights):
    w1, b1, w2, b2 = weights
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (w1.transpose(3, 2, 0, 1), b1, w2.transpose(3, 2, 0, 1), b2)]


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("valid_hw", [None, (40, 96)],
                         ids=["whole", "valid_inside_a_middle_shard"])
def test_k4_plain_equals_one_stem_on_the_whole_image(stem_weights, k,
                                                     valid_hw):
    """K4's plain path (the CPU) against the port's fused_stem over the
    whole image, at the stem test's rtol 1e-5, atol 1e-5·max: the CPU's
    convolutions round a strip's sums otherwise than the whole image's in
    the last bit (the card's K1 is held to the bit, in
    tests/test_torch_port_cuda.py); valid height 40 ends inside shard 1
    of 4 (rows 32..63) and inside shard 0 of 2; garbage beyond it."""
    x = np.random.RandomState(3).randn(2, 128, 128, 3).astype(
        np.float32) * 10
    if valid_hw:
        x[:, valid_hw[0]:] = 1e3
        x[:, :, valid_hw[1]:] = -1e3
    xt = torch.from_numpy(x)
    ws = _torch_w(stem_weights)
    want = stem.fused_stem(xt, *ws, valid_hw=valid_hw)
    got = stem.fused_stem_spatial(spatial.split(xt, [CPU] * k), *ws,
                                  valid_hw=valid_hw)
    assert len(got) == k and all(g.shape == (2, 64 // k, 64, 64)
                                 for g in got)
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5 * want.abs().max().item())


def test_k4_matches_the_jax_spatial_stem(stem_weights):
    """K4's plain path over 4 shards against JAX fused_stem_spatial on
    make_spatial_mesh(4) (interpret mode), with a valid height inside a
    middle shard."""
    vh, vw = 40, 96
    x = np.random.RandomState(4).randn(1, 64, 128, 3).astype(np.float32) * 10
    mesh = make_spatial_mesh(4)
    want = np.asarray(jax_stem_spatial(
        jnp.asarray(x), *map(jnp.asarray, stem_weights), mesh=mesh,
        valid_hw=(vh, vw), interpret=True))[:, :vh // 2, :vw // 2]
    got = torch.cat(stem.fused_stem_spatial(
        spatial.split(torch.from_numpy(x), [CPU] * 4),
        *_torch_w(stem_weights), valid_hw=(vh, vw)), 1).numpy()
    got = got[:, :vh // 2, :vw // 2]
    np.testing.assert_allclose(got, want, rtol=2e-2,
                               atol=0.01 * np.abs(want).max())


def test_no_r0_equivalence(stem_weights):
    """The top shard needs no first valid row: JAX fused_stem with
    valid_r0 = 8 on a strip topped by 8 zero rows (what JAX's top shard
    runs) equals JAX fused_stem on the strip without them, and so does
    the port's fused_stem on that shorter strip. Without r0 the zero rows
    would give relu(b1) to conv1_2's boundary taps, and the first pooled
    row would differ: the check can see the mask."""
    strip = np.random.RandomState(5).randn(1, 24, 128, 3).astype(
        np.float32) * 10
    vh = 20                                 # the valid height ends inside
    topped = np.concatenate([np.zeros((1, 8, 128, 3), np.float32), strip], 1)
    ws = list(map(jnp.asarray, stem_weights))
    with_r0 = np.asarray(jax_fused_stem(
        jnp.asarray(topped), *ws, valid_hw=(vh + 8, 128), valid_r0=8,
        interpret=True))[:, 4:]
    bare = np.asarray(jax_fused_stem(
        jnp.asarray(strip), *ws, valid_hw=(vh, 128), interpret=True))
    no_r0 = np.asarray(jax_fused_stem(
        jnp.asarray(topped), *ws, valid_hw=(vh + 8, 128),
        interpret=True))[:, 4:]
    port = stem.fused_stem(torch.from_numpy(strip), *_torch_w(stem_weights),
                           valid_hw=(vh, 128)).numpy()
    tol = dict(rtol=2e-2, atol=0.01 * np.abs(bare).max())
    np.testing.assert_allclose(with_r0[:, :vh // 2], bare[:, :vh // 2], **tol)
    np.testing.assert_allclose(port[:, :vh // 2], bare[:, :vh // 2], **tol)
    assert np.abs(no_r0[:, 0] - bare[:, 0]).max() > tol["atol"]


def test_k4_refuses_a_gradient(stem_weights):
    """K4 trains (its backward is tests/test_torch_port_spatial_train.py's):
    under grad the weights' gradients come back through every shard; it
    refuses a gradient only with per-image extents, as fused_stem does,
    and under no_grad those run."""
    ws = [w.requires_grad_(True) for w in _torch_w(stem_weights)]
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 64, 32, 3)
                         .astype(np.float32))
    shards = spatial.split(x, [CPU, CPU])
    torch.cat(stem.fused_stem_spatial(shards, *ws), 1).sum().backward()
    assert all(w.grad is not None and w.grad.abs().max() > 0 for w in ws)
    per_image = (torch.tensor([40]), torch.tensor([32]))
    with pytest.raises(NotImplementedError, match="per-image valid extents"):
        stem.fused_stem_spatial(shards, *ws, valid_hw=per_image)
    with torch.no_grad():
        assert len(stem.fused_stem_spatial(shards, *ws)) == 2
        assert len(stem.fused_stem_spatial(shards, *ws,
                                           valid_hw=per_image)) == 2


# ---- the forward over shards ----

@pytest.fixture(scope="module")
def models():
    spec, params, tparams = _pair(0)
    return spec, params, tdm.Detector(
        tparams, tdm.ModelSpec(different_dilation=True), "cpu")


@pytest.mark.parametrize("h", [128, 112], ids=["aligned", "padded"])
def test_forward_over_four_shards(models, h):
    """Detector.forward over 4 CPU shards at 1×h×128 against JAX
    dm.forward with the input H-sharded on make_spatial_mesh(4), and
    against the port's one-device forward; 112 rows need the padding rule
    (to 128, masked to 112)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    spec, params, det = models
    x = np.random.RandomState(0).randn(1, h, 128, 3).astype(np.float32) * 20
    mesh = make_spatial_mesh(4)
    xsh = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(None, "sp")))
    psh = jax.device_put(params, NamedSharding(mesh, P()))
    want = jax.jit(lambda p, x: jdm.forward(p, x, spec))(psh, xsh)
    shards, valid = spatial.shard_input(torch.from_numpy(x), [CPU] * 4)
    assert valid == (None if h == 128 else (112, 128))
    with torch.inference_mode():
        got = det(shards, valid)
        one = det(torch.from_numpy(x))
    for key in ("cls_logits", "bbox_deltas"):
        g = got[key][:, :h // 8].numpy()
        w = np.asarray(want[key])
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
        np.testing.assert_allclose(g, one[key].numpy(), rtol=0, atol=1e-5)


def test_forward_refuses_unaligned_shards(models):
    _, _, det = models
    with pytest.raises(ValueError, match="multiple of 32"):
        det([torch.zeros(1, 16, 32, 3)] * 2)


# ---- detection ----

def test_detect_matches_jax_spatial_mesh(cfgs):
    """TorchDetector over 4 CPU shards against JAX TPUDetector on
    make_spatial_mesh(4) and against the port's one-device detector, with
    test_detect_spatial_sharded_matches_single's settings; K1's plain
    path runs once per shard and level."""
    _set(TEST__SCALES=[60, 100], TEST__FLIP=True, TPU__TEST_BUCKET=64)
    spec, params, tparams = _pair(1)
    im = (np.random.RandomState(2).uniform(0, 255, (120, 160, 3))
          .astype(np.uint8))
    want = TPUDetector(params, spec, spatial_mesh=make_spatial_mesh(4)
                       ).detect(im, thresh=0.05)[0][0]
    tspec = tdm.ModelSpec(different_dilation=True)
    det = TorchDetector(tparams, tspec, spatial_devices=["cpu"] * 4)
    assert det.spatial == [CPU] * 4 and det.device == CPU
    calls = []
    plain = stem.fused_stem_reference
    stem.fused_stem_reference = lambda *a, **kw: calls.append(
        a[0].shape[1]) or plain(*a, **kw)
    try:
        got = det.detect(im, thresh=0.05)[0][0]
    finally:
        stem.fused_stem_reference = plain
    # two levels (hb 64 and 112, padded to 128): strips of 40, 48, 48, 40
    assert calls == [40, 48, 48, 40] * 2
    _sorted_close(got, want)
    _sorted_close(got, TorchDetector(tparams, tspec, "cpu").detect(
        im, thresh=0.05)[0][0])


def test_int8_calibrated_spatial_matches_one_device(cfgs):
    """test_int8_static_spatial_mesh_matches_single's set-up at k = 2: the
    calibration over shards gives JAX's amax (rtol 1e-5), and the
    calibrated detections equal the one-device ones at rtol 1e-4, atol
    1e-3."""
    _set(TEST__SCALES=[48], TEST__FLIP=False, TPU__TEST_BUCKET=64,
         TPU__MASK_MODE="where", TPU__PRECISION="int8")
    spec, params, tparams = _pair(2)
    im = np.random.RandomState(8).randint(0, 255, (60, 90, 3),
                                          dtype=np.uint8)
    tspec = tdm.ModelSpec(different_dilation=True)
    one = TorchDetector(tparams, tspec, "cpu")
    one.calibrate_int8([im])
    sharded = TorchDetector(tparams, tspec, spatial_devices=["cpu"] * 2)
    amax = sharded.calibrate_int8([im])
    want = TPUDetector(params, spec).calibrate_int8([im])
    for key, v in want.items():
        assert amax[key] == pytest.approx(v, rel=1e-5), key
    _sorted_close(sharded.detect(im, 0.05)[0][0], one.detect(im, 0.05)[0][0])


def _small_image():
    return (np.random.RandomState(2).uniform(0, 255, (120, 160, 3))
            .astype(np.uint8))


@pytest.mark.parametrize("precision", ["int8", "bfloat16"])
def test_dynamic_int8_and_bf16_spatial_track_one_device(cfgs, precision):
    """Dynamic int8 (its steps taken over both shards) and bf16 at k = 2
    against the port's one-device runs, by the match rules in the module
    docstring."""
    _set(TEST__SCALES=[60], TEST__FLIP=False, TPU__TEST_BUCKET=64,
         TPU__MASK_MODE="where", TPU__PRECISION=precision)
    _, _, tparams = _pair(1)
    tspec = tdm.ModelSpec(different_dilation=True)
    im = _small_image()
    got = TorchDetector(tparams, tspec, spatial_devices=["cpu"] * 2).detect(
        im, 0.05)[0][0]
    want = TorchDetector(tparams, tspec, "cpu").detect(im, 0.05)[0][0]
    if precision == "int8":
        assert abs(len(got) - len(want)) <= max(2, 0.02 * len(want))
        assert min(_match_fraction(got, want),
                   _match_fraction(want, got)) >= 0.99
    else:
        assert min(_loose_match(got, want), _loose_match(want, got)) >= 0.95


def test_detector_refusals(cfgs):
    """HOST_PREPROC at construction, detect_many, k above the local
    devices (one CPU), and a device that is not the unit's first."""
    _, _, tparams = _pair(1)
    tspec = tdm.ModelSpec(different_dilation=True)
    _set(TPU__HOST_PREPROC=True)
    with pytest.raises(ValueError, match="HOST_PREPROC"):
        TorchDetector(tparams, tspec, spatial_devices=["cpu"] * 2)
    _set(TPU__HOST_PREPROC=False, TPU__SPATIAL_DEVICES=2)
    with pytest.raises(ValueError, match="exceeds the 1 local devices"):
        TorchDetector(tparams, tspec, "cpu")
    det = TorchDetector(tparams, tspec, spatial_devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="detect_many"):
        det.detect_many([_small_image()])
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="first device"):
            TorchDetector(tparams, tspec, "cuda",
                          spatial_devices=["cpu"] * 2)


# ---- evaluation units and the service ----

class FakeImdb:
    num_classes = 2
    name = "fake"

    def __init__(self, paths):
        self.paths = paths
        self.evaluated = None

    def __len__(self):
        return len(self.paths)

    def image_path_at(self, i):
        return self.paths[i]

    def evaluate_detections(self, all_boxes, output_dir=None,
                            method_name="x", step=0):
        self.evaluated = all_boxes
        return "ok"


def test_test_net_spatial_units(cfgs, tmp_path, monkeypatch, caplog):
    """tests/test_runner.py:132-170 on the port: SPATIAL_DEVICES = 2 over
    4 (monkeypatched) local devices against SPATIAL_DEVICES = 1, with
    EVAL_BATCH 2 ignored under sharding (JAX's warning); k = 3 must divide
    4."""
    _set(TEST__SCALES=[50, 90], TEST__FLIP=True, TPU__TEST_BUCKET=64,
         TEST__N_DETS_PER_MODULE=100, TEST__MODEL="")
    _, _, tparams = _pair(0)
    spec = tdm.ModelSpec(different_dilation=True)
    rng = np.random.RandomState(0)
    paths = []
    for i in range(3):
        p = str(tmp_path / f"t{i}.jpg")
        cv2.imwrite(p, rng.randint(0, 255, (70, 90, 3), dtype=np.uint8))
        paths.append(p)
    monkeypatch.setattr(spatial, "local_devices", lambda d: [CPU] * 4)
    out = []
    for k, batch in ((1, 1), (2, 2)):
        _set(TPU__SPATIAL_DEVICES=k, TPU__EVAL_BATCH=batch)
        imdb = FakeImdb(paths)
        os.makedirs(tmp_path / f"k{k}")
        test_runner.test_net(imdb, str(tmp_path / f"k{k}"), no_cache=True,
                             params=tparams, spec=spec, device="cpu")
        out.append(imdb.evaluated[1])
    assert "EVAL_BATCH=2 ignored under TPU.SPATIAL_DEVICES" in caplog.text
    for a, b in zip(*out):
        _sorted_close(b, a)
    _set(TPU__SPATIAL_DEVICES=3)
    with pytest.raises(ValueError, match="must divide the local device"):
        test_runner.run_inference(FakeImdb(paths), tparams, spec, 0.05,
                                  device="cpu")


def test_spatial_service(cfgs, monkeypatch):
    """tests/test_serve.py:120-144 on the port: the service over a unit of
    2 (monkeypatched) local devices against the plain one; a batch window
    with spatial sharding raises, and so does k above the local devices."""
    _set(TEST__SCALES=[50], TEST__FLIP=False, TPU__TEST_BUCKET=64)
    _, _, tparams = _pair(0)
    spec = tdm.ModelSpec(different_dilation=True)
    body = cv2.imencode(".jpg", np.random.RandomState(0).randint(
        0, 255, (96, 128, 3), np.uint8))[1].tobytes()
    plain = tserve.DetectorService(tparams, spec, device="cpu").detect(body)
    _set(TPU__SPATIAL_DEVICES=2)
    with pytest.raises(ValueError, match="exceeds the 1 local devices"):
        tserve.DetectorService(tparams, spec, device="cpu")
    monkeypatch.setattr(spatial, "local_devices", lambda d: [CPU] * 4)
    service = tserve.DetectorService(tparams, spec, device="cpu")
    assert service.det.spatial == [CPU, CPU]
    _sorted_close(service.detect(body), plain, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="incompatible"):
        tserve.DetectorService(tparams, spec, batch_window_ms=5,
                               device="cpu")
