"""The port's stem backward (smallhardface_tpu_torch/ops/stem.py: K2's plain
version, and fused_stem's gradient) against the JAX package's.

- small-integer inputs (every product and sum exact in fp32 and bf16): the
  plain backward equals, to the bit, jax.grad through the JAX fused_stem,
  whose custom VJP runs the Pallas backward kernel in interpret mode;
- float inputs: the plain backward against jax.grad of the XLA chain, max
  |Δ| ≤ 1e-4·peak (fp32 on both sides, sums in another order);
- the routed backward K1 and K2 split between them (K1's pool routing,
  ``fused_stem_route_reference``; dy scattered by it,
  ``route_scatter_reference``; then K2's products,
  ``fused_stem_grad_products``): equal to the plain backward to the bit on
  small integers, and within 1e-4·peak of jax.grad of the XLA chain on
  floats; the routing codes agree with max_pool2d's own indices.

K2 itself is tested on the card in tests/test_torch_port_cuda.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from smallhardface_tpu.models.layers import conv2d, max_pool_2x2
from smallhardface_tpu.ops.pallas_stem import fused_stem as jax_fused_stem
from smallhardface_tpu_torch.ops import stem
import torch_threads  # noqa: F401

SHAPE, VALID = (2, 32, 128, 3), (24, 96)


def _int_inputs(seed=7):
    """HWIO weights, NHWC x with garbage beyond the valid extent, and dy."""
    rng = np.random.RandomState(seed)
    w1 = rng.randint(-3, 4, (3, 3, 3, 64)).astype(np.float32)
    b1 = rng.randint(-3, 4, (64,)).astype(np.float32)
    w2 = rng.randint(-2, 3, (3, 3, 64, 64)).astype(np.float32)
    b2 = rng.randint(-3, 4, (64,)).astype(np.float32)
    B, H, W, _ = SHAPE
    x = rng.randint(-3, 4, SHAPE).astype(np.float32)
    x[:, VALID[0]:] = 7.0
    x[:, :, VALID[1]:] = -3.0
    dy = rng.randint(-3, 4, (B, H // 2, W // 2, 64)).astype(np.float32)
    return x, dy, (w1, b1, w2, b2)


def _float_inputs(seed=0):
    rng = np.random.RandomState(seed)
    B, H, W, _ = SHAPE
    ws = (rng.randn(3, 3, 3, 64).astype(np.float32) * 0.1,
          rng.randn(64).astype(np.float32) * 0.5,
          rng.randn(3, 3, 64, 64).astype(np.float32) * 0.05,
          rng.randn(64).astype(np.float32) * 0.5)
    x = rng.randn(*SHAPE).astype(np.float32) * 10
    dy = rng.randn(B, H // 2, W // 2, 64).astype(np.float32)
    return x, dy, ws


def _msk(h, vh, vw):
    ys = jax.lax.broadcasted_iota(jnp.int32, h.shape[1:3], 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, h.shape[1:3], 1)
    return jnp.where(((ys < vh) & (xs < vw))[None, :, :, None], h, 0.0)


def _port_grads(x, dy, ws, device="cpu"):
    """The port's plain backward; OIHW grads back to HWIO numpy."""
    w1, b1, w2, b2 = ws
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    g = stem.fused_stem_grad_reference(
        t(x), t(dy), t(w1.transpose(3, 2, 0, 1)), t(b1),
        t(w2.transpose(3, 2, 0, 1)), t(b2), VALID)
    return _hwio(g)


def _hwio(g):
    dw1, db1, dw2, db2 = (a.cpu().numpy() for a in g)
    return dw1.transpose(2, 3, 1, 0), db1, dw2.transpose(2, 3, 1, 0), db2


def _xla_chain_grads(x, dy, ws):
    vh, vw = VALID

    def loss(p):
        w1, b1, w2, b2 = p
        h = _msk(jnp.asarray(x), vh, vw)
        h = _msk(jax.nn.relu(conv2d(h, w1, b1, padding=1)), vh, vw)
        h = jax.nn.relu(conv2d(h, w2, b2, padding=1))
        return jnp.sum(_msk(max_pool_2x2(h), vh // 2, vw // 2)
                       * jnp.asarray(dy))

    return [np.asarray(g) for g in jax.grad(loss)(tuple(map(jnp.asarray,
                                                             ws)))]


def _routed_grads(x, dy, ws, dtype=torch.float32):
    """K1's routing and K2's split of the backward in plain PyTorch: the
    routing codes of the plain forward, dy scattered by them, conv1_1, and
    the products of fused_stem_grad_products; grads back to HWIO numpy."""
    w1, b1, w2, b2 = ws
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)  # noqa: E731
    x, dy = t(x), t(dy)
    w1, w2 = t(w1.transpose(3, 2, 0, 1)), t(w2.transpose(3, 2, 0, 1))
    b1, b2 = t(b1), t(b2)
    route = stem.fused_stem_route_reference(x, w1, b1, w2, b2, VALID)
    assert route.dtype == torch.uint8 and route.shape == dy.shape
    dpre2 = stem.route_scatter_reference(dy, route, VALID)
    c1 = stem.conv1_1_reference(x, w1, b1, VALID).permute(0, 2, 3, 1)
    return _hwio(stem.fused_stem_grad_products(x, c1, dpre2, w2, VALID)[1:])


def test_plain_backward_equals_pallas_kernel_on_integers():
    x, dy, ws = _int_inputs()
    vh, vw = VALID

    def loss(p):
        out = jax_fused_stem(jnp.asarray(x), *p, valid_hw=VALID,
                             interpret=True)
        return jnp.sum(_msk(out, vh // 2, vw // 2) * jnp.asarray(dy))

    want = jax.grad(loss)(tuple(map(jnp.asarray, ws)))
    got = _port_grads(x, dy, ws)
    for name, a, b in zip(["dw1", "db1", "dw2", "db2"], got, want):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


def test_plain_backward_vs_xla_chain_on_floats():
    x, dy, ws = _float_inputs()
    want = _xla_chain_grads(x, dy, ws)
    got = _port_grads(x, dy, ws)
    for name, a, b in zip(["dw1", "db1", "dw2", "db2"], got, want):
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), name


def test_routed_backward_equals_plain_backward_on_integers():
    """Routing, scatter and products, every step exact on the recipe: the
    plain backward (autograd through max_pool2d and ReLU) to the bit."""
    x, dy, ws = _int_inputs()
    got = _routed_grads(x, dy, ws)
    want = _port_grads(x, dy, ws)
    assert np.abs(want[2]).max() > 0
    for name, a, b in zip(["dw1", "db1", "dw2", "db2"], got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_routed_backward_vs_xla_chain_on_floats():
    x, dy, ws = _float_inputs(3)
    want = _xla_chain_grads(x, dy, ws)
    got = _routed_grads(x, dy, ws)
    for name, a, b in zip(["dw1", "db1", "dw2", "db2"], got, want):
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), name


def test_route_codes_follow_max_pool_indices():
    """On the integer recipe, where ties are everywhere, the codes name the
    element max_pool2d itself picks (its first maximum), or NO_ROUTE where
    the pooled ReLU output is 0."""
    x, _, (w1, b1, w2, b2) = _int_inputs(9)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    ws = [t(w1.transpose(3, 2, 0, 1)), t(b1), t(w2.transpose(3, 2, 0, 1)),
          t(b2)]
    route = stem.fused_stem_route_reference(t(x), *ws, VALID).long()
    pre2 = torch.nn.functional.conv2d(
        stem.conv1_1_reference(t(x), ws[0], ws[1], VALID), ws[2], ws[3],
        padding=1)
    pooled, idx = torch.nn.functional.max_pool2d(
        torch.relu(pre2), 2, 2, return_indices=True)
    W = x.shape[2]
    rows, cols = idx // W, idx % W
    want = (rows % 2) * 2 + cols % 2
    want = torch.where(pooled > 0, want, stem.NO_ROUTE).permute(0, 2, 3, 1)
    assert torch.equal(route, want)
    counts = torch.bincount(route.flatten(), minlength=5)
    assert (counts > 0).all(), counts
    # ties: windows whose maximum occurs more than once
    win = torch.relu(pre2).reshape(*pre2.shape[:2], pre2.shape[2] // 2, 2,
                                   pre2.shape[3] // 2, 2)
    top = win.amax((3, 5), keepdim=True)
    assert (((win == top) & (top > 0)).sum((3, 5)) > 1).any()


def test_route_codes_on_hand_made_windows():
    """One channel, four windows: a tie goes to the first element in
    row-major order; a window of zeros and negatives routes nowhere."""
    pre = torch.tensor([[1., 3., -1., 0.],
                        [3., 2., 0., -2.],
                        [-1., -1., 0., 5.],
                        [-1., 4., 0., 5.]]).reshape(1, 1, 4, 4)
    # conv1_1 and conv1_2 as the identity on channel 0 (centre taps), the
    # input shifted up by 10 and conv1_2's bias shifting it back
    x = torch.zeros(1, 4, 4, 3)
    w1 = torch.zeros(64, 3, 3, 3)
    w1[0, 0, 1, 1] = 1.0
    b1 = torch.zeros(64)
    w2 = torch.zeros(64, 64, 3, 3)
    w2[0, 0, 1, 1] = 1.0
    b2 = torch.zeros(64)
    x[0, :, :, 0] = pre[0, 0].clamp_min(0) + 10.0
    b2[0] = -10.0
    route = stem.fused_stem_route_reference(x, w1, b1, w2, b2)[0, :, :, 0]
    # windows: [[1, 3], [3, 2]] -> 1 (first 3); [[-1, 0], [0, -2]] -> none;
    # [[-1, -1], [-1, 4]] -> 3; [[0, 5], [0, 5]] -> 1 (first 5)
    assert route.tolist() == [[1, stem.NO_ROUTE], [3, 1]]


def test_fused_stem_on_cpu_differentiates_as_the_plain_backward():
    """On the CPU, autograd through fused_stem inside the masked network
    gives the plain backward's gradients, and counts no kernel launch."""
    x, dy, ws = _float_inputs(3)
    vh, vw = VALID
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    w = [t(ws[0].transpose(3, 2, 0, 1)).requires_grad_(), t(ws[1]).requires_grad_(),
         t(ws[2].transpose(3, 2, 0, 1)).requires_grad_(), t(ws[3]).requires_grad_()]
    before = (stem.fused_stem.launches, stem.fused_stem_grad.launches)
    out = stem.fused_stem(t(x), *w, valid_hw=VALID)
    rows = torch.arange(out.shape[1]) < vh // 2
    cols = torch.arange(out.shape[2]) < vw // 2
    out = torch.where((rows[:, None] & cols[None, :])[None, :, :, None], out,
                      0.0)
    (out * t(dy)).sum().backward()
    want = stem.fused_stem_grad(t(x), t(dy), *[a.detach() for a in w],
                                valid_hw=VALID)
    for a, b in zip(w, want):
        torch.testing.assert_close(a.grad, b, rtol=1e-5,
                                   atol=1e-5 * b.abs().max().item())
    assert (stem.fused_stem.launches, stem.fused_stem_grad.launches) == before
