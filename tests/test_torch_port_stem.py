"""The port's fused stem (smallhardface_tpu_torch/ops/stem.py) against the
JAX package's.

- vs the JAX Pallas kernel (interpret mode on the CPU): rtol 2e-2, atol
  1 %·max, because the JAX kernel rounds its dot inputs and the stored
  conv1_1 activations to bf16 while the port is fp32;
- vs the JAX XLA chain (conv2d → relu → conv2d → relu → pool, fp32 on the
  CPU): rtol 1e-5, atol 1e-5·max, including a width the Pallas kernel
  cannot take;
- on the card, the CUDA kernel against the plain version: rtol 1e-4, atol
  1e-4·max (fp32 both, sums in another order). That test skips without a
  card;
- ``StemFunction`` asks K1 for the pool's routing only when grad mode is on
  and a weight needs a gradient, and hands it to the backward (K1 stubbed
  with the plain version);
- K1 and K2 carry the same conv1_1 code, character for character.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from smallhardface_tpu.models.layers import conv2d, max_pool_2x2
from smallhardface_tpu.ops.pallas_stem import fused_stem as jax_fused_stem
from smallhardface_tpu_torch.ops import stem
import torch_threads  # noqa: F401


@pytest.fixture
def weights():
    """HWIO numpy stem weights with large biases, so that relu(b1) ≠ 0 in
    any halo that is not masked."""
    rng = np.random.RandomState(7)
    return (rng.randn(3, 3, 3, 64).astype(np.float32) * 0.1,
            rng.randn(64).astype(np.float32) * 0.5,
            rng.randn(3, 3, 64, 64).astype(np.float32) * 0.05,
            rng.randn(64).astype(np.float32) * 0.5)


def _torch_w(weights, device="cpu"):
    w1, b1, w2, b2 = weights
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in
            (w1.transpose(3, 2, 0, 1), b1, w2.transpose(3, 2, 0, 1), b2)]


def _port(x, weights, valid_hw=None):
    return stem.fused_stem(torch.from_numpy(x), *_torch_w(weights),
                           valid_hw=valid_hw).numpy()


def _xla_chain(x, w1, b1, w2, b2):
    h = jax.nn.relu(conv2d(x, w1, b1, padding=1))
    h = jax.nn.relu(conv2d(h, w2, b2, padding=1))
    return max_pool_2x2(h)


def test_vs_pallas_kernel_full_extent(weights):
    x = np.random.RandomState(0).randn(2, 32, 128, 3).astype(np.float32) * 10
    want = np.asarray(jax_fused_stem(
        jnp.asarray(x), *map(jnp.asarray, weights), interpret=True))
    got = _port(x, weights)
    assert got.shape == want.shape == (2, 16, 64, 64)
    np.testing.assert_allclose(got, want, rtol=2e-2,
                               atol=0.01 * np.abs(want).max())


def test_vs_pallas_kernel_masked_bucket(weights):
    """valid_hw=(48, 96) in a (2, 64, 128) bucket: inside the valid extent
    the port matches the JAX kernel, and garbage beyond it changes
    nothing."""
    vh, vw = 48, 96
    x = np.random.RandomState(1).randn(2, 64, 128, 3).astype(np.float32) * 10
    want = np.asarray(jax_fused_stem(
        jnp.asarray(x), *map(jnp.asarray, weights), valid_hw=(vh, vw),
        interpret=True))[:, :vh // 2, :vw // 2]
    got = _port(x, weights, (vh, vw))[:, :vh // 2, :vw // 2]
    np.testing.assert_allclose(got, want, rtol=2e-2,
                               atol=0.01 * np.abs(want).max())
    x2 = x.copy()
    x2[:, vh:] = 123.0
    x2[:, :, vw:] = -55.0
    np.testing.assert_array_equal(
        _port(x2, weights, (vh, vw))[:, :vh // 2, :vw // 2], got)


@pytest.mark.parametrize("shape,valid_hw", [
    ((2, 32, 128, 3), None),
    ((1, 48, 80, 3), None),           # W % 128 != 0: no Pallas kernel
    ((2, 64, 80, 3), (32, 48)),
])
def test_vs_xla_chain(weights, shape, valid_hw):
    """The plain port equals the JAX XLA stem on the valid image."""
    x = np.random.RandomState(2).randn(*shape).astype(np.float32) * 10
    vh, vw = valid_hw or shape[1:3]
    want = np.asarray(_xla_chain(jnp.asarray(x[:, :vh, :vw]),
                                 *map(jnp.asarray, weights)))
    got = _port(x, weights, valid_hw)[:, :vh // 2, :vw // 2]
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_cpu_tensor_takes_plain_version_without_counting(weights):
    x = np.random.RandomState(3).randn(1, 16, 32, 3).astype(np.float32)
    before = stem.fused_stem.launches
    got = _port(x, weights)
    want = stem.fused_stem_reference(torch.from_numpy(x),
                                     *_torch_w(weights)).numpy()
    np.testing.assert_array_equal(got, want)
    assert stem.fused_stem.launches == before


def test_odd_size_reference_keeps_ceil_mode(weights):
    x = np.random.RandomState(4).randn(1, 9, 11, 3).astype(np.float32)
    assert _port(x, weights).shape == (1, 5, 6, 64)


@pytest.mark.parametrize("mode", ["train", "no_grad", "inference_mode",
                                  "frozen"])
def test_stem_function_writes_route_only_for_weight_grads(weights, mode,
                                                          monkeypatch):
    """Detection (no_grad, inference_mode) and a step with conv1 frozen
    pass K1 a null route; a step that trains a stem weight gets one, and
    its backward routes dy by it."""
    kernel_calls, grad_routes = [], []

    def kernel(x, w1, b1, w2, b2, valid_hw, with_route=False):
        kernel_calls.append(with_route)
        ws = [w.detach() for w in (w1, b1, w2, b2)]
        route = (stem.fused_stem_route_reference(x, *ws, valid_hw)
                 if with_route else None)
        return stem.fused_stem_reference(x, *ws, valid_hw), route

    def grad(x, dy, w1, b1, w2, b2, valid_hw=None, route=None):
        grad_routes.append(route)
        return stem.fused_stem_grad_reference(x, dy, w1, b1, w2, b2, valid_hw)

    monkeypatch.setattr(stem, "_stem_kernel", kernel)
    monkeypatch.setattr(stem, "fused_stem_grad", grad)
    x = torch.from_numpy(np.random.RandomState(6).randn(1, 16, 32, 3).astype(
        np.float32))
    w = [a.requires_grad_(mode != "frozen") for a in _torch_w(weights)]
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode}
    with ctx.get(mode, torch.enable_grad)():
        # the call fused_stem makes on a CUDA tensor
        out = stem.StemFunction.apply(x, *w, (12, 24), torch.is_grad_enabled())
    assert kernel_calls == [mode == "train"]
    assert out.requires_grad == (mode == "train")
    if mode == "train":
        out.sum().backward()
        want = stem.fused_stem_route_reference(
            x, *[a.detach() for a in w], (12, 24))
        assert len(grad_routes) == 1 and torch.equal(grad_routes[0], want)
        assert all(a.grad is not None for a in w)


def test_conv1_1_code_is_the_same_in_k1_and_k2():
    """K2's c1 > 0 mask and dw2 must read the very bits K1's conv1_2 read,
    so both sources carry one copy each of the same conv1_1 code."""
    from smallhardface_tpu_torch.ops.cuda_build import CSRC

    def shared(name):
        with open(f"{CSRC}/{name}") as f:
            src = f.read()
        start = src.index("// ---- conv1_1, the arithmetic K1 and K2 share")
        start = src.index("\n", start)
        return src[start:src.index("// ---- ", start)]

    k1, k2 = shared("stem.cu"), shared("stem_grad.cu")
    assert "fmaf(" in k1 and "conv1_1_tile" in k1
    assert k1 == k2


def test_library_path_is_keyed_by_source():
    from smallhardface_tpu_torch.ops.cuda_build import BUILD_DIR
    path = stem.STEM.path()
    assert path.startswith(BUILD_DIR)
    assert path == stem.STEM.path() != stem.STEM_GRAD.path()
    assert path.endswith(".so") and "stem_" in path


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,valid_hw", [
    ((1, 32, 128, 3), None),
    ((2, 112, 144, 3), None),
    ((2, 64, 128, 3), (48, 96)),
    ((1, 34, 70, 3), (30, 50)),       # ragged tiles, non-×16 even sizes
])
@pytest.mark.cuda
def test_cuda_kernel_vs_plain(cuda, weights, shape, valid_hw):
    from smallhardface_tpu_torch.models.detector import pin_fp32_numerics
    pin_fp32_numerics()
    x = torch.from_numpy(np.random.RandomState(5).randn(*shape).astype(
        np.float32) * 50).to(cuda)
    w = _torch_w(weights, cuda)
    before = stem.fused_stem.launches
    got = stem.fused_stem(x, *w, valid_hw=valid_hw)
    want = stem.fused_stem_reference(x, *w, valid_hw)
    torch.cuda.synchronize()
    assert stem.fused_stem.launches == before + 1
    vh, vw = valid_hw or shape[1:3]
    got, want = got[:, :vh // 2, :vw // 2], want[:, :vh // 2, :vw // 2]
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())


@pytest.mark.cuda
def test_cuda_kernel_refuses_odd_sizes(cuda, weights):
    x = torch.zeros((1, 17, 32, 3), device=cuda)
    with pytest.raises(ValueError, match="even"):
        stem.fused_stem(x, *_torch_w(weights, cuda))
