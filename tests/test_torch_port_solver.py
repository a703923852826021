"""The port's losses and solvers (smallhardface_tpu_torch/train/losses.py and
solver.py) against the JAX package's:

- both losses and their gradients vs jax.grad: rtol 1e-5, atol 1e-6·peak
  (fp32 on both sides);
- apply_update for all six solver types over two steps, frozen leaves
  included, vs the JAX apply_update: rtol 1e-5, atol 1e-7;
- learning_rate for all seven policies: equal (the same host arithmetic).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from smallhardface_tpu.config import cfg as jcfg
from smallhardface_tpu.train import losses as jlosses
from smallhardface_tpu.train import solver as jsolver
from smallhardface_tpu_torch.config import cfg as tcfg
from smallhardface_tpu_torch.train import losses as tlosses
from smallhardface_tpu_torch.train import solver as tsolver
import torch_threads  # noqa: F401


def test_losses_and_grads_match_jax():
    rng = np.random.RandomState(0)
    n = 300
    logits = rng.randn(n, 2).astype(np.float32) * 2
    labels = rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32)
    pred = rng.randn(n, 4).astype(np.float32) * 0.3
    tgt = rng.randn(n, 4).astype(np.float32) * 0.3
    inside = (rng.rand(n, 4) < 0.5).astype(np.float32)
    outside = inside / max(inside.sum(), 1)

    jce, jgce = jax.value_and_grad(jlosses.softmax_ce_with_ignore)(
        jnp.asarray(logits), jnp.asarray(labels))
    jl1, jgl1 = jax.value_and_grad(jlosses.smooth_l1)(
        jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(inside),
        jnp.asarray(outside))

    tl = torch.from_numpy(logits).requires_grad_()
    tp = torch.from_numpy(pred).requires_grad_()
    ce = tlosses.softmax_ce_with_ignore(tl, torch.from_numpy(labels))
    l1 = tlosses.smooth_l1(tp, *map(torch.from_numpy, (tgt, inside, outside)))
    (ce + l1).backward()
    for got, want in ((ce.item(), jce), (l1.item(), jl1)):
        np.testing.assert_allclose(got, float(want), rtol=1e-5)
    for got, want in ((tl.grad.numpy(), jgce), (tp.grad.numpy(), jgl1)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
    # no valid label: zero loss, like the JAX function
    none = tlosses.softmax_ce_with_ignore(tl, torch.full((n,), -1.0))
    assert none.item() == 0.0


def _tree(rng):
    return {"a": {"w": rng.randn(3, 4).astype(np.float32),
                  "b": rng.randn(4).astype(np.float32)},
            "frozen": {"w": rng.randn(2, 2).astype(np.float32)}}


@pytest.mark.parametrize("solver_type", ["SGD", "NESTEROV", "ADAGRAD",
                                         "RMSPROP", "ADADELTA", "ADAM"])
def test_apply_update_matches_jax(solver_type):
    rng = np.random.RandomState(1)
    params = _tree(rng)
    grads = [_tree(rng), _tree(rng)]
    lr = {"a": {"w": 2.0, "b": 4.0}, "frozen": {"w": 0.0}}
    decay = {"a": {"w": 1.0, "b": 0.0}, "frozen": {"w": 0.0}}
    kw = dict(solver_type=solver_type, rate=0.01, lr_mults=lr,
              decay_mults=decay, weight_decay=0.0005, momentum=0.9)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jsolver.init_state(jp, solver_type)
    tp = jax.tree_util.tree_map(torch.from_numpy,
                                jax.tree_util.tree_map(np.copy, params))
    ts = tsolver.init_state(tp, solver_type)
    assert set(ts) == set(js)
    for it, g in enumerate(grads):
        jp, js = jsolver.apply_update(
            jp, jax.tree_util.tree_map(jnp.asarray, g), js, iteration=it,
            **kw)
        tsolver.apply_update(tp, jax.tree_util.tree_map(torch.from_numpy, g),
                             ts, iteration=it, **kw)
    for name, leaf in tp.items():
        for k, v in leaf.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jp[name][k]),
                                       rtol=1e-5, atol=1e-7)
            for slot in ts:
                np.testing.assert_allclose(
                    ts[slot][name][k].numpy(), np.asarray(js[slot][name][k]),
                    rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(tp["frozen"]["w"].numpy(),
                                  params["frozen"]["w"])


@pytest.mark.parametrize("policy", ["FIXED", "STEP", "EXP", "INV",
                                    "MULTISTEP", "POLY", "SIGMOID"])
def test_learning_rate_policies(policy):
    """SIGMOID runs at a gamma whose exp does not overflow: at the default
    0.1 the JAX version raises OverflowError for iterations far below
    STEPSIZE (see the next test)."""
    saved = [(c.TRAIN.LR_POLICY, c.TRAIN.GAMMA) for c in (jcfg, tcfg)]
    for c in (jcfg, tcfg):
        c.TRAIN.LR_POLICY = policy
        c.TRAIN.GAMMA = 1e-4 if policy == "SIGMOID" else 0.1
    try:
        for it in (0, 1, 999, 21000, 46000, 59999):
            assert (tsolver.learning_rate(it, tcfg)
                    == jsolver.learning_rate(it, jcfg))
    finally:
        for c, (pol, gamma) in zip((jcfg, tcfg), saved):
            c.TRAIN.LR_POLICY, c.TRAIN.GAMMA = pol, gamma


def test_sigmoid_rate_is_zero_where_exp_overflows():
    """Caffe's exp overflows to inf and its rate is 0."""
    saved = tcfg.TRAIN.LR_POLICY
    tcfg.TRAIN.LR_POLICY = "SIGMOID"
    try:
        assert tsolver.learning_rate(0, tcfg) == 0.0
        assert tsolver.learning_rate(int(tcfg.TRAIN.STEPSIZE), tcfg) == (
            0.5 * float(tcfg.TRAIN.LR.BASELR))
    finally:
        tcfg.TRAIN.LR_POLICY = saved
