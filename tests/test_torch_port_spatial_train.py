"""Spatial and grouped training in the port (``TPU.SPATIAL_DEVICES`` = k
> 1: K4's backward in ``ops/stem.fused_stem_spatial``, the replicas of
``Detector._on`` that carry gradients, ``train_loop.LossFn`` over a unit,
``train_net``'s unit) against the JAX package's ``make_train_step_spatial``
on ``make_spatial_mesh(2)`` and ``make_train_step_grouped`` on
``make_group_mesh(2, 2)``, and against the port's one-device step. k
"devices" are ``["cpu"] * k`` in one process; JAX runs on the virtual
8-device CPU mesh of ``tests/conftest.py``, on the skeletal backbone,
BUCKET 32 and the 64×80 samples of tests/test_train_loop.py:361-420. Each
JAX step is built and run once, in a module-scoped fixture.

Tolerances:
- K4's gradient on the plain path against the port's one-device stem
  gradient: rtol 1e-5, atol 1e-5·peak (the forward's, the CPU's
  convolutions round a strip's sums otherwise than the whole image's);
  against ``jax.vjp`` of JAX ``fused_stem_spatial`` (interpret mode) equal
  to the bit on small integers, where the JAX kernel's bf16 dots are
  exact too (on floats its bf16 forward routes the pool otherwise);
- steps: ``cls_loss`` at rtol 1e-4, the parameters after two steps at
  rtol 1e-3, atol 1e-6 (``tests/test_torch_port_train.py``'s);
- one micro-batch's gradients, sharded against one device: rtol 1e-4,
  atol 1e-4·peak of each leaf (``test_micro_batch_loss_and_grads_match_jax``).
"""

import contextlib
import logging
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from smallhardface_tpu.config import cfg as jcfg
from smallhardface_tpu.io import checkpoint as jckpt
from smallhardface_tpu.models import detector as jdm
from smallhardface_tpu.ops.pallas_stem import (
    fused_stem_spatial as jax_stem_spatial)
from smallhardface_tpu.parallel.mesh import make_group_mesh, make_spatial_mesh
from smallhardface_tpu.train import solver as jsolver
from smallhardface_tpu.train import targets as jtg
from smallhardface_tpu.train import train_loop as jtl
from smallhardface_tpu_torch.config import cfg as tcfg
from smallhardface_tpu_torch.io.weights import (params_from_numpy,
                                                params_to_numpy)
from smallhardface_tpu_torch.models import detector as tdm
from smallhardface_tpu_torch.ops import stem
from smallhardface_tpu_torch.parallel import dist as pdist
from smallhardface_tpu_torch.parallel import spatial
from smallhardface_tpu_torch.train import solver as tsolver
from smallhardface_tpu_torch.train import targets as ttg
from smallhardface_tpu_torch.train import train_loop as ttl
from tests.test_train_loop import _tiny_roidb

CPU = torch.device("cpu")
RTOL_LOSS = 1e-4
RTOL_TRAIN, ATOL_TRAIN = 1e-3, 1e-6
RTOL_GRAD = 1e-4
ITER_SIZE, RATE, DECAY = 2, 0.004, 0.0005
KEYS = ("data", "scale", "crop", "gt", "gt_mask", "im_hw", "valid_hw")
SKELETAL = (("conv1", 8, 1), ("conv2", 8, 1), ("conv3", 16, 1),
            ("conv4", 16, 1), ("conv5", 16, 1))
SETTINGS = {"TRAIN.SCALES.SHORT_SIDE": [64], "TRAIN.SCALES.MAX_SIZE": 128,
            "TRAIN.AUGMENT.ENABLE": False, "TRAIN.ITERSIZE": 1,
            "TRAIN.SNAPSHOT": 2, "TPU.MAX_GT_BUCKETS": [8],
            "MODEL.DIFFERENT_DILATION.ENABLE": True,
            "TRAIN.DISABLE_EASY_IMAGE.ENABLE": True,
            "TRAIN.DISABLE_EASY_IMAGE.SMOOTH": True, "TRAIN.RESUME": "",
            "TPU.SPATIAL_DEVICES": 1, "TPU.PRECISION": "float32"}


@contextlib.contextmanager
def _settings(stages=SKELETAL):
    """tests/test_train_loop.py's train_cfg in both packages: its config
    values, BUCKET 32 and the skeletal backbone (or ``stages``)."""
    saved = []
    for c in (jcfg, tcfg):
        for path, value in SETTINGS.items():
            *parents, leaf = path.split(".")
            node = c
            for p in parents:
                node = node[p]
            saved.append((node, leaf, node[leaf]))
            node[leaf] = value
    old = jdm.VGG_STAGES, tdm.VGG_STAGES, jtl.BUCKET, ttl.BUCKET
    jdm.VGG_STAGES = tdm.VGG_STAGES = stages
    jtl.BUCKET = ttl.BUCKET = 32
    try:
        yield
    finally:
        jdm.VGG_STAGES, tdm.VGG_STAGES, jtl.BUCKET, ttl.BUCKET = old
        for node, leaf, value in saved:
            node[leaf] = value


@pytest.fixture
def port_cfg():
    with _settings():
        yield


def _samples(seed, n):
    """n samples of tests/test_train_loop.py:361-372 (64×80 random pixels,
    two faces)."""
    rng = np.random.RandomState(seed)
    return [{
        "height": 64, "width": 80,
        "data": rng.randint(0, 255, (64, 80, 3), dtype=np.uint8),
        "im_scale": 1.0, "crop": np.zeros(2, np.float32),
        "gt_boxes": np.array([[10., 12., 33., 35., 1.],
                              [40., 20., 60., 44., 1.]], np.float32),
        "im_idx": i} for i in range(n)]


def _jax_params():
    params = jdm.init_params(jax.random.PRNGKey(3), jdm.build_spec(jcfg))
    return {n: {k: np.asarray(v) for k, v in leaf.items()}
            for n, leaf in params.items()}


def _jax_steps(step, batch, out_shape, params):
    p = jax.tree_util.tree_map(jnp.asarray, params)
    opt = jsolver.init_state(p, "SGD")
    losses = []
    for it in range(2):
        p, opt, metrics = step(p, opt, jnp.float32(RATE), jnp.int32(it),
                               out_shape,
                               *[jnp.asarray(batch[k]) for k in KEYS])
        losses.append(np.asarray(metrics["cls_loss"]))
    params = {n: {k: np.asarray(v) for k, v in leaf.items()}
              for n, leaf in jax.device_get(p).items()}
    return params, np.stack(losses)


@pytest.fixture(scope="module")
def ref():
    """The JAX references, each step built and run once: two spatial steps
    on make_spatial_mesh(2) over one data rank of ITER_SIZE samples, and
    two grouped steps on make_group_mesh(2, 2) over two groups."""
    with _settings():
        spec, tc = jdm.build_spec(jcfg), jtg.from_cfg(jcfg)
        params = _jax_params()
        gts = list(jcfg.TPU.MAX_GT_BUCKETS)
        out = {"params": params, "spatial_samples": _samples(0, ITER_SIZE),
               "grouped_samples": _samples(1, 2 * ITER_SIZE)}
        jobs = {"spatial": (jtl.make_train_step_spatial, make_spatial_mesh(2),
                            1),
                "grouped": (jtl.make_train_step_grouped,
                            make_group_mesh(2, 2), 2)}

        def run(key):
            make, mesh, groups = jobs[key]
            batch, _, bucket = jtl.assemble_batch(
                out[f"{key}_samples"], groups, ITER_SIZE, gts)
            step = make(spec, tc, mesh, ITER_SIZE, weight_decay=DECAY)
            return _jax_steps(step, batch, bucket[2:4], params)

        # the two compilations overlap (XLA compiles outside the GIL)
        with ThreadPoolExecutor(max_workers=2) as pool:
            for key, result in zip(jobs, pool.map(run, jobs)):
                out[key] = result
        return out


def _port_batch(samples):
    arrays, _, bucket = ttl.assemble_batch(samples, len(samples),
                                           list(tcfg.TPU.MAX_GT_BUCKETS))
    for k in ("data", "gt", "gt_mask"):
        arrays[k] = torch.from_numpy(arrays[k])
    return arrays, bucket[2:4]


def _model(params, trainable_stem=False):
    """A trainable Detector on the CPU from HWIO numpy ``params`` (or the
    port's own OIHW tensors)."""
    if not isinstance(next(iter(params.values()))["w"], torch.Tensor):
        params = params_from_numpy(params)
    model = tdm.Detector(params, tdm.build_spec(tcfg), "cpu", trainable=True)
    if trainable_stem:
        for name in ("conv1_1", "conv1_2"):
            for p in model.params[name].values():
                p.requires_grad_(True)
    return model


def _port_steps(params, groups, unit):
    """Two solver steps of the port from ``params``: each iteration runs
    ``grad_step`` for every group's (batch, out_shape) over ``unit``. With
    more than one group the reduce is written by hand, as one process: the
    later groups' summed gradients are kept, and the first group's
    ``reduce`` adds them and returns the group count, so ``grad_step``
    divides by G·iter_size once (JAX's psum over ``data``)."""
    model = _model(params)
    tree = model.tree()
    opt = tsolver.init_state({n: {k: v.detach() for k, v in leaf.items()}
                              for n, leaf in tree.items()}, "SGD")
    lr_mults, decay_mults = tdm.param_multipliers(model.spec)
    loss_fn = ttl.LossFn(ttg.from_cfg(tcfg), CPU, unit)
    losses = []
    for it in range(2):
        kept = []

        def keep(grads):
            kept.append([g.clone() for g in grads])
            return 1

        def add_kept(grads):
            for other in kept:
                for g, o in zip(grads, other):
                    g.add_(o)
            return 1 + len(kept)

        rows = []
        for gi in reversed(range(len(groups))):
            batch, out_shape = groups[gi]
            reduce = (None if len(groups) == 1
                      else add_kept if gi == 0 else keep)
            rows.insert(0, ttl.grad_step(model, loss_fn, batch, out_shape,
                                         ITER_SIZE, reduce)[0])
        tsolver.apply_update(
            tree, {n: {k: v.grad for k, v in leaf.items()}
                   for n, leaf in tree.items()},
            opt, solver_type="SGD", rate=RATE, lr_mults=lr_mults,
            decay_mults=decay_mults, weight_decay=DECAY, momentum=0.9,
            iteration=it)
        losses.append(torch.stack(rows).numpy())
    return params_to_numpy(tree), np.stack(losses)


def _assert_params_close(got, want, what):
    for name, leaf in want.items():
        for k, w in leaf.items():
            np.testing.assert_allclose(got[name][k], w, rtol=RTOL_TRAIN,
                                       atol=ATOL_TRAIN,
                                       err_msg=f"{what}: {name}/{k}")


# ---- K4's backward ----

@pytest.fixture(scope="module")
def stem_weights():
    """OIHW stem weights with large biases (relu(b1) ≠ 0 in any unmasked
    halo), tests/test_torch_port_spatial.py's."""
    rng = np.random.RandomState(7)
    return (rng.randn(64, 3, 3, 3).astype(np.float32) * 0.1,
            rng.randn(64).astype(np.float32) * 0.5,
            rng.randn(64, 64, 3, 3).astype(np.float32) * 0.05,
            rng.randn(64).astype(np.float32) * 0.5)


def _leaves(weights):
    return [torch.tensor(w, requires_grad=True) for w in weights]


def _k4_grads(x, dy, weights, k, valid_hw):
    ws = _leaves(weights)
    out = stem.fused_stem_spatial(spatial.split(x, [CPU] * k), *ws,
                                  valid_hw=valid_hw)
    (torch.cat(out, 1) * dy).sum().backward()
    return [w.grad for w in ws]


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("valid_hw", [None, (40, 96)],
                         ids=["whole", "valid_inside_a_middle_shard"])
def test_k4_backward_equals_the_one_device_gradient(stem_weights, k,
                                                    valid_hw):
    """The gradient of the four stem weights through K4 (each strip's stem
    differentiated with zero dy on its halo, the partials summed onto the
    leaves) against the port's fused_stem over the whole image; valid
    height 40 ends inside shard 1 of 4 and inside shard 0 of 2, with
    garbage beyond it."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 128, 128, 3).astype(np.float32) * 10
    if valid_hw:
        x[:, valid_hw[0]:] = 1e3
        x[:, :, valid_hw[1]:] = -1e3
    x = torch.from_numpy(x)
    dy = torch.from_numpy(rng.randn(2, 64, 64, 64).astype(np.float32))
    got = _k4_grads(x, dy, stem_weights, k, valid_hw)
    ws = _leaves(stem_weights)
    (stem.fused_stem(x, *ws, valid_hw=valid_hw) * dy).sum().backward()
    for g, w in zip(got, ws):
        np.testing.assert_allclose(g.numpy(), w.grad.numpy(), rtol=1e-5,
                                   atol=1e-5 * w.grad.abs().max().item())


def test_k4_backward_matches_the_jax_vjp():
    """K4's gradient over 2 shards against jax.vjp of JAX
    fused_stem_spatial on make_spatial_mesh(2) (its custom VJP: the Pallas
    backward kernel per shard in interpret mode, zero dy halos, psum),
    with the valid height inside shard 1. On the small-integer recipe of
    tests/test_torch_port_stem_grad.py every product and sum is exact in
    fp32 and in the JAX kernel's bf16 dots, so the two agree to the bit;
    on floats the JAX kernel's bf16 forward routes the pool otherwise."""
    vh, vw = 24, 96
    rng = np.random.RandomState(4)
    x = rng.randint(-3, 4, (1, 32, 128, 3)).astype(np.float32)
    x[:, vh:] = 7.0
    x[:, :, vw:] = -3.0
    dy = rng.randint(-3, 4, (1, 16, 64, 64)).astype(np.float32)
    dy[:, vh // 2:] = 0.0
    dy[:, :, vw // 2:] = 0.0
    oihw = (rng.randint(-3, 4, (64, 3, 3, 3)), rng.randint(-3, 4, 64),
            rng.randint(-2, 3, (64, 64, 3, 3)), rng.randint(-3, 4, 64))
    oihw = [w.astype(np.float32) for w in oihw]
    hwio = [w.transpose(2, 3, 1, 0) if w.ndim == 4 else w for w in oihw]
    _, vjp = jax.vjp(
        lambda *ws: jax_stem_spatial(jnp.asarray(x), *ws,
                                     mesh=make_spatial_mesh(2),
                                     valid_hw=(vh, vw), interpret=True),
        *map(jnp.asarray, hwio))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    want = [w.transpose(3, 2, 0, 1) if w.ndim == 4 else w for w in want]
    got = _k4_grads(torch.from_numpy(x), torch.from_numpy(dy), oihw, 2,
                    (vh, vw))
    assert np.abs(want[0]).max() > 0
    for name, g, w in zip(["dw1", "db1", "dw2", "db2"], got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


# ---- replicas on other devices ----

def test_replicas_carry_gradients_to_the_master_leaves(monkeypatch,
                                                       port_cfg, ref):
    """Detector._on as a shard on a distinct card takes it: every shard is
    handed copies made for ``cpu:0``, which torch treats as another device
    than the parameters' ``cpu`` (a real copy, as between two cards). One
    micro-batch's gradients over 2 shards reach the parameters and equal
    the unsharded ones; detection keeps its cached detached copies."""
    orig = tdm.Detector._on
    copies = []

    def on_other(self, tree, device):
        out = orig(self, tree, torch.device("cpu", 0))
        copies.append(out is not tree)
        return out

    params = ref["params"]
    batch, out_shape = _port_batch(ref["spatial_samples"])
    grads = []
    for unit, patch in (([CPU], False), ([CPU, CPU], True)):
        if patch:
            monkeypatch.setattr(tdm.Detector, "_on", on_other)
        model = _model(params)
        ttl.grad_step(model, ttl.LossFn(ttg.from_cfg(tcfg), CPU, unit),
                      batch, out_shape, ITER_SIZE)
        grads.append({n: {k: v.grad for k, v in leaf.items()
                          if v.grad is not None}
                      for n, leaf in model.tree().items()})
    assert copies and all(copies)
    one, sharded = grads
    assert sum(len(leaf) for leaf in one.values()) > 0
    for name, leaf in one.items():
        assert set(sharded[name]) == set(leaf), name
        for k, want in leaf.items():
            np.testing.assert_allclose(
                sharded[name][k].numpy(), want.numpy(), rtol=RTOL_GRAD,
                atol=RTOL_GRAD * max(want.abs().max().item(), 1e-12),
                err_msg=f"{name}/{k}")
    # detection: copies detached, cached until a weight changes
    model = _model(params)
    with torch.no_grad():
        a = orig(model, model.params, torch.device("cpu", 0))
        b = orig(model, model.params, torch.device("cpu", 0))
    assert a is b and not a["head"]["w"].requires_grad


# ---- steps against JAX and the one-device step ----

def test_spatial_steps_match_jax(port_cfg, ref):
    """Two steps over a unit of 2 against make_train_step_spatial on
    make_spatial_mesh(2): one data rank, grads / iter_size."""
    want_params, want_loss = ref["spatial"]
    got_params, got_loss = _port_steps(
        ref["params"], [_port_batch(ref["spatial_samples"])], [CPU, CPU])
    np.testing.assert_allclose(got_loss[:, 0], want_loss[:, 0],
                               rtol=RTOL_LOSS)
    _assert_params_close(got_params, want_params, "spatial")


def test_grouped_steps_match_jax(port_cfg, ref):
    """Two groups of two shards, one process, a hand-written reduce,
    against make_train_step_grouped on make_group_mesh(2, 2): psum over
    'data', grads / (G·iter_size); group g's losses are row g of JAX's."""
    want_params, want_loss = ref["grouped"]
    samples = ref["grouped_samples"]
    groups = [_port_batch(samples[g * ITER_SIZE:(g + 1) * ITER_SIZE])
              for g in range(2)]
    got_params, got_loss = _port_steps(ref["params"], groups, [CPU, CPU])
    np.testing.assert_allclose(got_loss, want_loss, rtol=RTOL_LOSS)
    _assert_params_close(got_params, want_params, "grouped")


def test_padded_step_matches_one_device(port_cfg, ref):
    """k = 4 pads the 64 bucket rows to 128 (a multiple of 32·4), masks
    them, and crops the head outputs back to 8 rows: two steps equal the
    port's one-device steps within the steps' tolerance."""
    assert spatial.padded_height(64, 4) == 128
    batch = [_port_batch(ref["spatial_samples"])]
    one_params, one_loss = _port_steps(ref["params"], batch, [CPU])
    got_params, got_loss = _port_steps(ref["params"], batch, [CPU] * 4)
    np.testing.assert_allclose(got_loss, one_loss, rtol=RTOL_LOSS)
    _assert_params_close(got_params, one_params, "k=4")


def test_step_with_the_real_stem_and_conv1_trainable(ref):
    """The real 64-channel stem (K4 engages; the rest skeletal, as JAX's
    test_spatial_train_step_pallas_stem) with conv1 taking a gradient: one
    micro-batch over 2 and 4 shards against one device, every leaf, the
    stem's four through K4's backward."""
    with _settings((("conv1", 64, 2),) + SKELETAL[1:]):
        params = tdm.init_params(torch.Generator().manual_seed(5),
                                 tdm.build_spec(tcfg))
        batch, out_shape = _port_batch(ref["spatial_samples"][:1])
        grads = []
        for k in (1, 2, 4):
            model = _model(params, trainable_stem=True)
            before = stem.fused_stem_spatial.launches
            ttl.grad_step(model, ttl.LossFn(ttg.from_cfg(tcfg), CPU,
                                            [CPU] * k),
                          batch, out_shape, 1)
            assert stem.fused_stem_spatial.launches == before  # no card
            grads.append(params_to_numpy(
                {n: {kk: v.grad for kk, v in leaf.items()
                     if v.grad is not None}
                 for n, leaf in model.tree().items()}))
    assert np.abs(grads[0]["conv1_1"]["w"]).max() > 0
    assert not grads[0]["conv2_1"]                   # still frozen
    for got in grads[1:]:
        for name, leaf in grads[0].items():
            for k, want in leaf.items():
                np.testing.assert_allclose(
                    got[name][k], want, rtol=RTOL_GRAD,
                    atol=RTOL_GRAD * max(np.abs(want).max(), 1e-12),
                    err_msg=f"{name}/{k}")


# ---- train_net ----

def test_train_net_spatial_resume_is_bit_identical(tmp_path, port_cfg,
                                                   monkeypatch):
    """train_net at TPU.SPATIAL_DEVICES 2 over two local "devices" for 2
    iterations; a resume from the snapshot at 1 ends equal to the bit.
    The snapshot carries one sampler state (JAX's n_dev = 1 of the spatial
    mesh), which the JAX package's checkpoint reader reads. TPU.NUM_DEVICES
    is not read under a unit (JAX train_loop.py:546)."""
    monkeypatch.setattr(spatial, "local_devices", lambda d: [CPU, CPU])
    monkeypatch.setitem(tcfg.TPU, "SPATIAL_DEVICES", 2)
    monkeypatch.setitem(tcfg.TPU, "NUM_DEVICES", 8)
    monkeypatch.setitem(tcfg.TRAIN, "SNAPSHOT", 1)
    tcfg.TRAIN.AUGMENT.ENABLE = True       # the resumed stream replays RNGs
    units = []
    orig = ttl.LossFn.__init__

    def record(self, tc, device, unit=None):
        units.append(list(unit))
        orig(self, tc, device, unit)
    monkeypatch.setattr(ttl.LossFn, "__init__", record)
    roidb = _tiny_roidb(tmp_path)
    straight, resumed = str(tmp_path / "a"), str(tmp_path / "b")
    os.makedirs(straight)
    os.makedirs(resumed)
    ttl.train_net(roidb, straight, None, 2, device="cpu")
    snap = os.path.join(straight, "face_iter_1.npz")
    tcfg.TRAIN.RESUME = snap
    ttl.train_net(roidb, resumed, None, 2, device="cpu")
    assert units == [[CPU, CPU]] * 2
    a = np.load(os.path.join(straight, "final.npz"))
    b = np.load(os.path.join(resumed, "final.npz"))
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    import pickle
    _, _, it, extra = jckpt.load(snap)
    assert it == 1
    assert len(pickle.loads(np.asarray(extra["loader_state"]).tobytes())) == 1


def test_fewer_devices_clamp_with_the_jax_warning(monkeypatch, caplog):
    """Without a launcher, k above the local devices trains over those
    there are, with make_mesh's warning (evaluation refuses instead)."""
    monkeypatch.setattr(spatial, "local_devices", lambda d: [CPU, CPU])
    with caplog.at_level(logging.WARNING, logger=ttl.__name__):
        assert ttl._train_unit(CPU, 4) == [CPU, CPU]
    assert "Requested 4 devices but only 2 available (cpu backend); using 2" \
        in caplog.text
    assert ttl._train_unit(CPU, 2) == [CPU, CPU]
    assert ttl._train_unit(CPU, 1) == [CPU]


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_ranks_times_k_above_the_cards_refuse(monkeypatch, backend):
    """Two ranks on a node of two cards with TPU.SPATIAL_DEVICES 2 need
    four: init_distributed refuses before joining any group, whatever the
    backend."""
    for k, v in dict(RANK="1", LOCAL_RANK="1", WORLD_SIZE="2",
                     LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="29999").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv(pdist.BACKEND_ENV, backend)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="need 4 CUDA devices, there are 2"):
        pdist.init_distributed("cuda", spatial=2)
    assert not pdist.active()


@pytest.mark.parametrize("precision,error,words", [
    ("int8", ValueError, "inference-only"),
    ("bfloat16", NotImplementedError, "trains in float32 only"),
])
def test_bf16_and_int8_training_still_refuse(tmp_path, port_cfg,
                                             monkeypatch, precision, error,
                                             words):
    monkeypatch.setattr(spatial, "local_devices", lambda d: [CPU, CPU])
    monkeypatch.setitem(tcfg.TPU, "SPATIAL_DEVICES", 2)
    monkeypatch.setitem(tcfg.TPU, "PRECISION", precision)
    with pytest.raises(error, match=words):
        ttl.train_net(_tiny_roidb(tmp_path), str(tmp_path), None, 1,
                      device="cpu")
