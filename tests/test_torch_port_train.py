"""The port's training (smallhardface_tpu_torch/train/train_loop.py) against
the JAX package's, on the skeletal backbone, BUCKET 32 and 64×80 JPEGs of
tests/test_train_loop.py, patched and set alike in both packages:

- one micro-batch's loss and the gradient of every leaf vs the JAX
  _make_loss_fn under value_and_grad, from JAX-initialised weights: rtol
  1e-4, atol 1e-4·peak of each leaf (fp32 on both sides, sums in another
  order);
- train_net for 3 iterations in both packages from the same weights and
  roidb, augmentation off: per-iteration losses within rtol 1e-3, final
  weights within rtol 1e-3, atol 1e-6; the frozen leaves unchanged, the
  others moved wherever the JAX run moved them; the same for 4
  iterations at the overfit check's schedule (base rate 0.001, the STEP
  drop after iteration 2, mining off);
- snapshot + resume gives a final.npz equal to the bit to the straight
  run's, on the CPU; a resume past max_iter writes final.npz and stops;
- each package loads the other's final.npz.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from smallhardface_tpu.config import cfg as jcfg
from smallhardface_tpu.io import checkpoint as jckpt
from smallhardface_tpu.models import detector as jdm
from smallhardface_tpu.parallel.mesh import make_mesh
from smallhardface_tpu.train import targets as jtg
from smallhardface_tpu.train import train_loop as jtl
from smallhardface_tpu_torch.config import cfg as tcfg
from smallhardface_tpu_torch.io import checkpoint as tckpt
from smallhardface_tpu_torch.io.weights import load_params, params_from_numpy
from smallhardface_tpu_torch.models import detector as tdm
from smallhardface_tpu_torch.train import targets as ttg
from smallhardface_tpu_torch.train import train_loop as ttl
from smallhardface_tpu_torch.train.loader import RoIDataLoader
import torch_threads  # noqa: F401
from tests.test_train_loop import _tiny_roidb, train_cfg  # noqa: F401

MIRRORED = ("TRAIN.SCALES.SHORT_SIDE", "TRAIN.SCALES.MAX_SIZE",
            "TRAIN.AUGMENT.ENABLE", "TRAIN.ITERSIZE", "TRAIN.SNAPSHOT",
            "TPU.MAX_GT_BUCKETS", "MODEL.DIFFERENT_DILATION.ENABLE",
            "TRAIN.DISABLE_EASY_IMAGE.ENABLE",
            "TRAIN.DISABLE_EASY_IMAGE.SMOOTH", "TRAIN.RESUME")


def _node(cfg, path):
    parts = path.split(".")
    d = cfg
    for p in parts[:-1]:
        d = d[p]
    return d, parts[-1]


@pytest.fixture
def port_cfg(train_cfg):  # noqa: F811
    """train_cfg's settings and patches, mirrored into the port."""
    saved = {}
    for path in MIRRORED:
        (jd, k), (td, _) = _node(jcfg, path), _node(tcfg, path)
        saved[path] = td[k]
        td[k] = jd[k]
    old = tdm.VGG_STAGES, ttl.BUCKET
    tdm.VGG_STAGES, ttl.BUCKET = jdm.VGG_STAGES, jtl.BUCKET
    yield
    tdm.VGG_STAGES, ttl.BUCKET = old
    for path, v in saved.items():
        d, k = _node(tcfg, path)
        d[k] = v


def _jax_params(seed=0):
    spec = jdm.build_spec(jcfg)
    params = jdm.init_params(jax.random.PRNGKey(seed), spec)
    return {n: {k: np.asarray(v) for k, v in leaf.items()}
            for n, leaf in params.items()}


def _hwio(model):
    from smallhardface_tpu_torch.io.weights import params_to_numpy
    return params_to_numpy(model.tree())


def test_micro_batch_loss_and_grads_match_jax(tmp_path, port_cfg):
    roidb = _tiny_roidb(tmp_path)
    sample = RoIDataLoader(roidb).get_minibatch(0)
    arrays, _, bucket = ttl.assemble_batch([sample], 1,
                                           list(tcfg.TPU.MAX_GT_BUCKETS))
    out_shape = bucket[2:4]
    params = _jax_params()

    jloss = jtl._make_loss_fn(jdm.build_spec(jcfg), jtg.from_cfg(jcfg), None,
                              None)
    grad_fn = jax.jit(jax.value_and_grad(jloss, has_aux=True),
                      static_argnums=1)
    (jl, jaux), jg = grad_fn(
        jax.tree_util.tree_map(jnp.asarray, params), out_shape,
        *[jnp.asarray(arrays[k][0]) for k in (
            "data", "scale", "crop", "gt", "gt_mask", "im_hw", "valid_hw")])

    model = tdm.Detector(params_from_numpy(params), tdm.build_spec(tcfg),
                         "cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) if k in ("data", "gt", "gt_mask") else v
             for k, v in arrays.items()}
    metrics = ttl.grad_step(model, ttl.LossFn(ttg.from_cfg(tcfg), "cpu"),
                            batch, out_shape, 1)
    cls_l, reg_l = metrics[0, 0].item(), metrics[1, 0].item()
    np.testing.assert_allclose(cls_l + reg_l, float(jl), rtol=1e-4)
    np.testing.assert_allclose(cls_l, float(jaux["cls_loss"]), rtol=1e-4)
    assert metrics[4, 0].item() == int(jaux["n_fg"])
    got = {n: {k: v.grad for k, v in leaf.items()}
           for n, leaf in model.tree().items()}
    from smallhardface_tpu_torch.io.weights import params_to_numpy
    got = params_to_numpy(got)
    for name, leaf in jg.items():
        for k, want in leaf.items():
            want = np.asarray(want)
            np.testing.assert_allclose(
                got[name][k], want, rtol=1e-4,
                atol=1e-4 * max(np.abs(want).max(), 1e-12),
                err_msg=f"{name}/{k}")


def _run_both(tmp_path, roidb, iters):
    init = str(tmp_path / "init.npz")
    params = _jax_params(1)
    jckpt.save(init, params)
    losses = {"jax": [], "port": []}

    def hook(key):
        return lambda it, m: losses[key].append(
            np.asarray(m["cls_loss"]).ravel() + np.asarray(
                m["reg_loss"]).ravel())

    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(jdir)
    os.makedirs(tdir)
    jtl.train_net(roidb, jdir, init, iters, mesh=make_mesh(1),
                  progress_hook=hook("jax"))
    model = ttl.train_net(roidb, tdir, init, iters, device="cpu",
                          progress_hook=hook("port"))
    return params, losses, jdir, tdir, model


@pytest.mark.parametrize("schedule", ["default", "overfit_check"])
def test_train_net_matches_jax(tmp_path, port_cfg, schedule, monkeypatch):
    iters = 3
    if schedule == "overfit_check":
        # scripts/overfit_check.py's settings (tools/overfit_check.py in
        # the port): a 0.001 base rate dropped at 2/3 of the run (the STEP
        # policy's GAMMA), augmentation and hard-image mining off, one
        # micro-batch an iteration
        iters = 4
        for c in (jcfg, tcfg):
            monkeypatch.setitem(c.TRAIN.LR, "BASELR", 0.001)
            monkeypatch.setitem(c.TRAIN, "STEPSIZE", iters * 2 // 3)
            monkeypatch.setitem(c.TRAIN.AUGMENT, "ENABLE", False)
            monkeypatch.setitem(c.TRAIN.DISABLE_EASY_IMAGE, "ENABLE", False)
            monkeypatch.setitem(c.TRAIN, "ITERSIZE", 1)
    roidb = _tiny_roidb(tmp_path)
    init, losses, jdir, tdir, model = _run_both(tmp_path, roidb, iters)
    assert len(losses["port"]) == len(losses["jax"]) == iters
    np.testing.assert_allclose(np.concatenate(losses["port"]),
                               np.concatenate(losses["jax"]), rtol=1e-3)
    got = _hwio(model)
    want = jckpt.load(os.path.join(jdir, "final.npz"))[0]
    lr_mults, _ = tdm.param_multipliers(tdm.build_spec(tcfg))
    for name, leaf in want.items():
        for k, w in leaf.items():
            np.testing.assert_allclose(got[name][k], w, rtol=1e-3,
                                       atol=1e-6, err_msg=f"{name}/{k}")
            if lr_mults[name][k] == 0:
                np.testing.assert_array_equal(got[name][k], init[name][k])
            else:      # moved exactly where the JAX step moved it
                assert (np.array_equal(got[name][k], init[name][k])
                        == np.array_equal(w, init[name][k])), f"{name}/{k}"
    # each package loads the other's final weights
    port_final = os.path.join(tdir, "final.npz")
    loaded = jckpt.load_params(port_final, jax.tree_util.tree_map(
        jnp.asarray, init))
    assert set(loaded) == set(init)
    back = load_params(os.path.join(jdir, "final.npz"))
    tdm.Detector(back, tdm.build_spec(tcfg), "cpu")
    assert jckpt.load(port_final)[2] == iters


def test_resume_is_bit_identical(tmp_path, port_cfg):
    tcfg.TRAIN.AUGMENT.ENABLE = True       # the resumed stream replays RNGs
    roidb = _tiny_roidb(tmp_path)
    straight, resumed = str(tmp_path / "a"), str(tmp_path / "b")
    os.makedirs(straight)
    os.makedirs(resumed)
    ttl.train_net(roidb, straight, None, 4, device="cpu")
    tcfg.TRAIN.RESUME = os.path.join(straight, "face_iter_2.npz")
    ttl.train_net(roidb, resumed, None, 4, device="cpu")
    a = np.load(os.path.join(straight, "final.npz"))
    b = np.load(os.path.join(resumed, "final.npz"))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # resuming from a finished run writes final.npz without training
    done = str(tmp_path / "c")
    os.makedirs(done)
    tcfg.TRAIN.RESUME = os.path.join(straight, "final.npz")
    ttl.train_net(roidb, done, None, 4, device="cpu")
    c = tckpt.load(os.path.join(done, "final.npz"))
    assert c[2] == 4
    np.testing.assert_array_equal(c[0]["head"]["w"], a["params//head//w"])


class _InlineExecutor:
    """A ThreadPoolExecutor stand-in that runs each job at submit."""

    def __init__(self, *args, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def submit(self, fn, *args, **kwargs):
        from concurrent.futures import Future
        fut = Future()
        fut.set_result(fn(*args, **kwargs))
        return fut

    def shutdown(self, *args, **kwargs):
        pass


def test_mining_marks_at_epoch_boundary_match_jax(tmp_path, port_cfg,
                                                  monkeypatch):
    """With every image marked easy (threshold 0) and no snapshot to drain
    the marks, both loops sample the same images across the epoch
    boundaries of a 5-image roidb. The JAX loop applies iteration k's
    marks on the main thread while its prefetch thread fetches batch k + 2
    (train_loop.py:881-922); its executor runs here inline, so the fetch
    always comes first, as it does when the thread wins that race."""
    from smallhardface_tpu.train import loader as jloader
    from smallhardface_tpu_torch.train import loader as tloader
    monkeypatch.setattr(jtl, "ThreadPoolExecutor", _InlineExecutor)
    drawn = {"jax": [], "port": []}
    for key, mod in (("jax", jloader), ("port", tloader)):
        orig = mod.RoIDataLoader._next_index

        def record(self, orig=orig, key=key):
            idx = orig(self)
            drawn[key].append(int(idx))
            return idx
        monkeypatch.setattr(mod.RoIDataLoader, "_next_index", record)
    for c in (jcfg, tcfg):
        monkeypatch.setitem(c.TRAIN.DISABLE_EASY_IMAGE, "THRESHOLD", 0.0)
        monkeypatch.setitem(c.TRAIN.DISABLE_EASY_IMAGE, "PROB", 0.3)
        monkeypatch.setitem(c.TRAIN, "SNAPSHOT", 100)
    roidb = _tiny_roidb(tmp_path, n=5)
    _run_both(tmp_path, roidb, 13)
    assert len(drawn["port"]) == len(drawn["jax"]) >= 13
    assert drawn["port"] == drawn["jax"]
