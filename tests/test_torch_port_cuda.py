"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one. The file imports neither jax nor the JAX package, so it also runs on
a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

- K2 (stem backward, csrc/stem_grad.cu): equal to the bit to the plain
  backward in float64 on small-integer inputs (every product and sum exact),
  and to itself from run to run; the stem's autograd backward launches it;
  on float inputs within GRAD_TOL of the plain backward; and its
  tensor-core products (3xTF32) on its own routing, its scratch c1 and
  dpre2, within PRODUCT_TOL of each peak of the same products in float64;
- K3 (anchor max-IoU, csrc/iou.cu): equal to the bit to its plain version,
  for no gt, masked rows and a gt count above the Pallas kernel's 512, and
  on the inputs that could break its gt culling (``ops/iou_cases.k3_case``;
  the CPU tests hold a numpy model of the culling to the same cases),
  including a crowd of 2048 small faces over the 90,000 anchors of a
  1200×1600 image, and a band of 2048 faces that one block of anchors
  keeps beyond its list, with ties on both sides of the list's walk.
"""

import numpy as np
import pytest
import torch

from smallhardface_tpu_torch.ops import anchors as anchors_mod
from smallhardface_tpu_torch.ops import iou, stem
from smallhardface_tpu_torch.ops.iou_cases import (BASE, K3_CASES, band_gt,
                                                  crowd_gt, k3_case)

VALID = (24, 96)
# K2 on float inputs against the plain backward, max |Δ| / peak: pool and
# ReLU near-ties flip with fp32 rounding (chip_smoke.py's GRAD_TOL)
GRAD_TOL = 1e-3
# K2's products on its own routing against float64, max |Δ| / peak: 3xTF32
# keeps about 22 bits of each operand; one TF32 product would miss this by
# an order of magnitude (tests/test_torch_port_tf32x3.py)
PRODUCT_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    from smallhardface_tpu_torch.models.detector import pin_fp32_numerics
    pin_fp32_numerics()
    return torch.device("cuda")


def _int_grad_inputs(seed, shape=(2, 32, 128, 3), valid=VALID):
    """x (garbage beyond valid), dy and OIHW weights, small integers."""
    rng = np.random.RandomState(seed)
    B, H, W, _ = shape
    x = rng.randint(-3, 4, shape)
    x[:, valid[0]:] = 7
    x[:, :, valid[1]:] = -3
    return [x, rng.randint(-3, 4, (B, H // 2, W // 2, 64)),
            rng.randint(-3, 4, (64, 3, 3, 3)), rng.randint(-3, 4, 64),
            rng.randint(-2, 3, (64, 64, 3, 3)), rng.randint(-3, 4, 64)]


def _float_grad_inputs(seed, shape, valid):
    """x (garbage beyond valid), dy and OIHW weights at He scale, floats."""
    rng = np.random.RandomState(seed)
    B, H, W, _ = shape
    x = rng.randn(*shape) * 50
    x[:, valid[0]:] = 1e4
    x[:, :, valid[1]:] = -1e4
    return [x, rng.randn(B, H // 2, W // 2, 64),
            rng.randn(64, 3, 3, 3) * np.sqrt(2 / 27), rng.randn(64) * 0.5,
            rng.randn(64, 64, 3, 3) * np.sqrt(2 / 576), rng.randn(64) * 0.5]


def _on(arrays, device, dtype=torch.float32):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)
            for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,valid", [
    ((2, 32, 128, 3), VALID),
    ((1, 34, 70, 3), (30, 50)),       # ragged tiles, non-×16 even sizes
])
def test_stem_grad_kernel_vs_plain_on_integers(cuda, shape, valid):
    arrays = _int_grad_inputs(11, shape, valid)
    before = stem.fused_stem_grad.launches
    got = stem.fused_stem_grad(*_on(arrays, cuda), valid_hw=valid)
    again = stem.fused_stem_grad(*_on(arrays, cuda), valid_hw=valid)
    want = stem.fused_stem_grad_reference(
        *_on(arrays, cuda, torch.float64), valid_hw=valid)
    torch.cuda.synchronize()
    assert stem.fused_stem_grad.launches == before + 2
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        assert torch.equal(a.double(), c)


@pytest.mark.cuda
def test_stem_grad_kernel_vs_plain_on_floats(cuda):
    """Float inputs end to end, the fp32 routing included, against the
    plain backward in float64. GRAD_TOL leaves room for pool and ReLU
    flips, so one TF32 product without the hi/lo split would pass here
    too: test_stem_grad_products_on_own_routing guards the split."""
    shape = (2, 32, 128, 3)
    arrays = _float_grad_inputs(13, shape, VALID)
    got = stem.fused_stem_grad(*_on(arrays, cuda), valid_hw=VALID)
    again = stem.fused_stem_grad(*_on(arrays, cuda), valid_hw=VALID)
    want = stem.fused_stem_grad_reference(
        *_on(arrays, cuda, torch.float64), valid_hw=VALID)
    torch.cuda.synchronize()
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        err = (a.double() - c).abs().max() / c.abs().max()
        assert err <= GRAD_TOL, err.item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,valid", [
    ((2, 32, 128, 3), VALID),
    ((1, 34, 70, 3), (30, 50)),       # ragged tiles, non-×16 even sizes
])
def test_stem_grad_products_on_own_routing(cuda, shape, valid):
    """dpre1, dw1, db1, dw2 and db2 against the same products in float64
    on the kernel's own c1 and dpre2: its arithmetic alone, no flips."""
    x, dy, w1, b1, w2, b2 = _on(_float_grad_inputs(14, shape, valid), cuda)
    grads, scratch = stem._stem_grad_launch(x, dy, w1, b1, w2, b2, valid)
    want = stem.fused_stem_grad_products(
        x.double(), scratch["c1"].double(), scratch["dpre2"].double(),
        w2.double(), valid)
    torch.cuda.synchronize()
    assert scratch["dpre2"].abs().max() > 0
    for name, a, b in zip(["dpre1", "dw1", "db1", "dw2", "db2"],
                          (scratch["dpre1"],) + grads, want):
        err = (a.double() - b).abs().max() / b.abs().max()
        assert err <= PRODUCT_TOL, (name, err.item())


@pytest.mark.cuda
def test_stem_autograd_launches_both_kernels(cuda):
    x, dy, *ws = _on(_int_grad_inputs(12), cuda)
    ws = [w.requires_grad_() for w in ws]
    counts = stem.fused_stem.launches, stem.fused_stem_grad.launches
    out = stem.fused_stem(x, *ws, valid_hw=VALID)
    rows = torch.arange(out.shape[1], device=cuda) < VALID[0] // 2
    cols = torch.arange(out.shape[2], device=cuda) < VALID[1] // 2
    mask = (rows[:, None] & cols[None, :])[None, :, :, None]
    (torch.where(mask, out, 0.0) * dy).sum().backward()
    want = stem.fused_stem_grad_reference(
        x.double(), dy.double(), *[w.detach().double() for w in ws],
        valid_hw=VALID)
    torch.cuda.synchronize()
    assert (stem.fused_stem.launches, stem.fused_stem_grad.launches) == (
        counts[0] + 1, counts[1] + 1)
    for w, g in zip(ws, want):
        assert torch.equal(w.grad.double(), g)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(0, 0), (64, 5), (64, 64), (2048, 100)]
                         + list(K3_CASES) + ["crowd_full", "band_full"])
def test_max_iou_kernel_vs_plain(cuda, case):
    """Random gt as (G, masked) over the anchors of a 1200×1600 image, the
    culling cases of k3_case, and a crowd and a band of 2048 faces over
    that image."""
    if isinstance(case, tuple):
        g, n_masked = case
        rng = np.random.RandomState(g + n_masked)
        anchors = anchors_mod.dense_anchors(150, 200, 8, BASE).astype(
            np.float32)
        x1, y1 = rng.uniform(-10, 1600, g), rng.uniform(-10, 1200, g)
        s = rng.uniform(4, 300, g)
        gt = np.stack([x1, y1, x1 + s, y1 + s], 1).reshape(g, 4).astype(
            np.float32)
        mask = np.arange(g) < g - n_masked
    elif case == "crowd_full":
        anchors = anchors_mod.dense_anchors(150, 200, 8, BASE).astype(
            np.float32)
        gt = crowd_gt(np.random.RandomState(1), 2048, 1200, 1600)
        mask = np.ones(2048, bool)
    elif case == "band_full":
        anchors = anchors_mod.dense_anchors(150, 200, 8, BASE).astype(
            np.float32)
        gt = band_gt(np.random.RandomState(2), 2048, (0, 0, 600, 40))
        mask = np.ones(2048, bool)
    else:
        anchors, gt, mask = k3_case(case)
    args = [torch.from_numpy(a).to(cuda) for a in (anchors, gt, mask)]
    before = iou.max_iou.launches
    best, idx = iou.max_iou(*args)
    want_best, want_idx = iou.max_iou_reference(*args)
    torch.cuda.synchronize()
    assert iou.max_iou.launches == before + 1
    assert torch.equal(idx, want_idx) and torch.equal(best, want_best)
