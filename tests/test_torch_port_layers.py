"""The port's layers (smallhardface_tpu_torch/models/layers.py) against the
JAX package's (smallhardface_tpu/models/layers.py) on the same seeded
inputs. Both are true fp32 on the CPU: rtol 1e-5, atol 1e-5·max|ref|."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from smallhardface_tpu.models import layers as jl
from smallhardface_tpu_torch.models import layers as tl

RTOL = 1e-5


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("dilation", [1, 2, 4])
def test_conv2d_dilations(dilation):
    rng = np.random.RandomState(dilation)
    x = rng.randn(2, 20, 24, 8).astype(np.float32)
    w = rng.randn(3, 3, 8, 5).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    want = np.asarray(jl.conv2d(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), dilation=dilation,
                                padding=dilation))
    got = tl.conv2d(_nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1)),
                    torch.from_numpy(b), dilation=dilation,
                    padding=dilation)
    assert got.shape == (2, 5, 20, 24)
    _close(_nhwc(got), want)


@pytest.mark.parametrize("hw", [(11, 13), (10, 12), (1, 3)])
def test_max_pool_ceil_mode(hw):
    rng = np.random.RandomState(sum(hw))
    x = rng.randn(2, *hw, 3).astype(np.float32)
    want = np.asarray(jl.max_pool_2x2(jnp.asarray(x)))
    got = _nhwc(tl.max_pool_2x2(_nchw(x)))
    assert got.shape == want.shape == (2, -(-hw[0] // 2), -(-hw[1] // 2), 3)
    np.testing.assert_array_equal(got, want)


def test_bilinear_kernel_is_the_jax_kernel():
    np.testing.assert_array_equal(tl.bilinear_kernel(2, 7),
                                  jl.bilinear_kernel(2, 7))


@pytest.mark.parametrize("kernel", ["bilinear", "random"])
def test_upsample2x_bilinear(kernel):
    """The grouped transposed conv equals the JAX fractionally-strided conv,
    for the symmetric bilinear kernel and for an asymmetric one."""
    rng = np.random.RandomState(5)
    c = 6
    x = rng.randn(2, 5, 7, c).astype(np.float32)
    w = (jl.bilinear_kernel(2, c) if kernel == "bilinear"
         else rng.randn(4, 4, 1, c).astype(np.float32))
    want = np.asarray(jl.upsample2x_bilinear(jnp.asarray(x), jnp.asarray(w)))
    got = _nhwc(tl.upsample2x_bilinear(
        _nchw(x), torch.from_numpy(np.ascontiguousarray(
            w.transpose(3, 2, 0, 1)))))
    assert got.shape == want.shape == (2, 10, 14, c)
    _close(got, want)
