"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one. The file imports neither jax nor the JAX package, so it also runs on
a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

- K1 (stem forward, csrc/stem.cu, conv1_2 in 3xTF32 on the tensor cores):
  its output equal to the bit to the plain forward in float64 on
  small-integer inputs, and its pool routing to
  ``fused_stem_route_reference``'s; on float inputs within RTOL, and the
  same output whether it writes the routing or not; under ``no_grad`` it
  writes none;
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
  keeps beyond its list, with ties on both sides of the list's walk;
- V1 (the final vote, csrc/vote.cu): BBOX_VOTE and NMS equal to the bit to
  their plain versions on integer boxes with dyadic scores (every sum
  exact), for no candidate, one, padding rows and 512 candidates; on a
  crowd of 2048 float boxes the same rows out, the scores equal to the bit
  and the boxes within VOTE_BOX_TOL of the largest coordinate;
- the batched launches of detect_many: K1 on an 8-image batch with eight
  valid extents in one launch (equal to the bit to the plain forward in
  float64 on integers, within RTOL on floats, and to eight single-image
  launches), V1 over three images in one launch (equal to the bit to
  three single launches);
- conv4_fuse_final_dim_red, as detection runs it, at the shapes where
  cuDNN took an FFT algorithm: at most 4 GB of device memory added.
"""

import numpy as np
import pytest
import torch

from smallhardface_tpu_torch.ops import anchors as anchors_mod
from smallhardface_tpu_torch.ops import iou, nms_device, stem
from smallhardface_tpu_torch.ops.iou_cases import (BASE, K3_CASES, band_gt,
                                                  crowd_gt, k3_case)
from smallhardface_tpu_torch.ops.vote_cases import crowd_dets, integer_dets

VALID = (24, 96)
# K1 on float inputs against the plain forward (fp32 cuDNN): fp32 rounding,
# sums in another order (chip_smoke.py's RTOL)
RTOL = 1e-4
# K2 on float inputs against the plain backward, max |Δ| / peak: pool and
# ReLU near-ties flip with fp32 rounding (chip_smoke.py's GRAD_TOL)
GRAD_TOL = 1e-3
# K2's products on its own routing against float64, max |Δ| / peak: 3xTF32
# keeps about 22 bits of each operand; one TF32 product would miss this by
# an order of magnitude (tests/test_torch_port_tf32x3.py)
PRODUCT_TOL = 1e-5
# V1's merged boxes on float inputs, max |Δ| / largest coordinate: the same
# members, summed in another order in float32
VOTE_BOX_TOL = 1e-5


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
    ((1, 32, 128, 3), None),
    ((2, 64, 128, 3), (48, 96)),
    ((1, 34, 70, 3), (30, 50)),       # ragged tiles, non-×16 even sizes
])
def test_stem_kernel_and_route_vs_plain_on_integers(cuda, shape, valid):
    x, _, *ws = _int_grad_inputs(15, shape, valid or shape[1:3])
    args = _on([x] + ws, cuda)
    wide = _on([x] + ws, cuda, torch.float64)
    before = stem.fused_stem.launches, stem.fused_stem.route_writes
    out, route = stem._stem_kernel(*args, valid, with_route=True)
    want = stem.fused_stem_reference(*wide, valid)
    want_route = stem.fused_stem_route_reference(*wide, valid)
    torch.cuda.synchronize()
    assert (stem.fused_stem.launches, stem.fused_stem.route_writes) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(out.double(), want)
    assert torch.equal(route, want_route)
    assert (torch.bincount(route.flatten().long(), minlength=5) > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,valid", [
    ((2, 112, 144, 3), None),
    ((1, 34, 70, 3), (30, 50)),
])
def test_stem_kernel_vs_plain_on_floats(cuda, shape, valid):
    """Within RTOL of the fp32 plain forward on the valid extent; writing
    the routing does not change the output."""
    x, _, *ws = _on(_float_grad_inputs(16, shape, valid or shape[1:3]), cuda)
    out, route = stem._stem_kernel(x, *ws, valid, with_route=True)
    bare, none = stem._stem_kernel(x, *ws, valid)
    want = stem.fused_stem_reference(x, *ws, valid)
    torch.cuda.synchronize()
    assert none is None and torch.equal(out, bare)
    vh, vw = valid or shape[1:3]
    got, want = out[:, :vh // 2, :vw // 2], want[:, :vh // 2, :vw // 2]
    torch.testing.assert_close(got, want, rtol=RTOL,
                               atol=RTOL * want.abs().max().item())


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
def test_stem_grad_kernel_with_given_route(cuda):
    """With K1's routing passed in, K2 launches alone and gives what the
    standalone call (which launches K1 for the routing) gives."""
    args = _on(_int_grad_inputs(17), cuda)
    x, dy, *ws = args
    _, route = stem._stem_kernel(x, *ws, VALID, with_route=True)
    alone = stem.fused_stem_grad(*args, valid_hw=VALID)
    k1 = stem.fused_stem.launches
    given = stem.fused_stem_grad(*args, valid_hw=VALID, route=route)
    torch.cuda.synchronize()
    assert stem.fused_stem.launches == k1
    for a, b in zip(alone, given):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_stem_under_no_grad_writes_no_route(cuda):
    x, _, *ws = _on(_int_grad_inputs(18), cuda)
    ws = [w.requires_grad_() for w in ws]
    before = stem.fused_stem.launches, stem.fused_stem.route_writes
    with torch.no_grad():
        stem.fused_stem(x, *ws, valid_hw=VALID)
    with torch.inference_mode():
        stem.fused_stem(x, *ws, valid_hw=VALID)
    stem.fused_stem(x, *[w.detach() for w in ws], valid_hw=VALID)
    assert (stem.fused_stem.launches, stem.fused_stem.route_writes) == (
        before[0] + 3, before[1])


@pytest.mark.cuda
def test_stem_autograd_launches_both_kernels(cuda):
    """The forward launches K1 with a routing, the backward K2 once on it."""
    x, dy, *ws = _on(_int_grad_inputs(12), cuda)
    ws = [w.requires_grad_() for w in ws]
    counts = (stem.fused_stem.launches, stem.fused_stem_grad.launches,
              stem.fused_stem.route_writes)
    out = stem.fused_stem(x, *ws, valid_hw=VALID)
    rows = torch.arange(out.shape[1], device=cuda) < VALID[0] // 2
    cols = torch.arange(out.shape[2], device=cuda) < VALID[1] // 2
    mask = (rows[:, None] & cols[None, :])[None, :, :, None]
    (torch.where(mask, out, 0.0) * dy).sum().backward()
    want = stem.fused_stem_grad_reference(
        x.double(), dy.double(), *[w.detach().double() for w in ws],
        valid_hw=VALID)
    torch.cuda.synchronize()
    assert (stem.fused_stem.launches, stem.fused_stem_grad.launches,
            stem.fused_stem.route_writes) == (counts[0] + 1, counts[1] + 1,
                                              counts[2] + 1)
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


def _vote_pair(method, dets, n_valid, device):
    fn = (nms_device.bbox_vote_device if method == "BBOX_VOTE"
          else nms_device.nms_device)
    plain = (nms_device.bbox_vote_device_reference if method == "BBOX_VOTE"
             else nms_device.nms_device_reference)
    d = torch.from_numpy(dets).to(device)
    n = torch.tensor(n_valid, dtype=torch.int32, device=device)
    before = fn.launches
    got, n_got = fn(d, n, 0.4)
    want, n_want = plain(d, n, 0.4)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert int(n_got) == int(n_want)
    return got.cpu().numpy(), want.cpu().numpy(), int(n_got)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["BBOX_VOTE", "NMS"])
@pytest.mark.parametrize("v,n_valid", [(8, 0), (1, 1), (64, 40), (512, 512)])
def test_vote_kernel_vs_plain_on_integers(cuda, method, v, n_valid):
    dets = integer_dets(np.random.RandomState(v + n_valid), v)
    dets[n_valid:, 4] = -np.inf
    got, want, _ = _vote_pair(method, dets, n_valid, cuda)
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["BBOX_VOTE", "NMS"])
def test_vote_kernel_vs_plain_on_a_crowd(cuda, method):
    dets = crowd_dets(np.random.RandomState(5), 2048)
    got, want, n = _vote_pair(method, dets, 2048, cuda)
    assert 1 < n < 2048
    np.testing.assert_array_equal(got[:, 4], want[:, 4])
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0,
                               atol=VOTE_BOX_TOL * np.abs(dets[:, :4]).max())


# ---- batched launches of detect_many ----

EXTENTS = ((64, 128), (48, 96), (64, 32), (16, 128), (2, 2), (34, 70),
           (64, 126), (0, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("integer", [True, False], ids=["integers", "floats"])
def test_stem_kernel_per_image_extents(cuda, integer):
    """K1 on an 8-image batch with eight extents in one launch: on
    integers equal to the bit to the plain forward in float64, on floats
    within RTOL of the fp32 plain forward inside each extent, and equal to
    the bit to eight single-image launches with scalar extents."""
    shape = (8, 64, 128, 3)
    make = _int_grad_inputs if integer else _float_grad_inputs
    x, _, *ws = make(17, shape, (64, 128))
    x = np.asarray(x, np.float64)
    x[4:] = x[4:] * -1                      # different images
    args = _on([x] + ws, cuda)
    vh = torch.tensor([e[0] for e in EXTENTS], device=cuda)
    vw = torch.tensor([e[1] for e in EXTENTS], device=cuda)
    before = stem.fused_stem.launches
    with torch.no_grad():
        got = stem.fused_stem(*args, valid_hw=(vh, vw))
        torch.cuda.synchronize()
        assert stem.fused_stem.launches == before + 1
        singles = [stem.fused_stem(args[0][i:i + 1].contiguous(), *args[1:],
                                   valid_hw=e)
                   for i, e in enumerate(EXTENTS)]
    if integer:
        want = stem.fused_stem_reference(*_on([x] + ws, cuda, torch.float64),
                                         (vh, vw))
        assert torch.equal(got.double(), want)
    else:
        want = stem.fused_stem_reference(*args, (vh, vw))
        for i, (h, w) in enumerate(EXTENTS):
            g, r = got[i, :h // 2, :w // 2], want[i, :h // 2, :w // 2]
            torch.testing.assert_close(g, r, rtol=RTOL, atol=RTOL * max(
                want.abs().max().item(), 1.0))
    for i, one in enumerate(singles):
        assert torch.equal(got[i:i + 1], one)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["BBOX_VOTE", "NMS"])
def test_vote_kernel_batched_equals_single_launches(cuda, method):
    """V1 over three images in one launch (one block each): each image's
    rows and count equal to the bit to its own launch, and to the plain
    loop's as the single launches are."""
    fn = (nms_device.bbox_vote_device if method == "BBOX_VOTE"
          else nms_device.nms_device)
    dets = np.stack([crowd_dets(np.random.RandomState(s), 2048)
                     for s in (1, 2, 3)])
    n_valid = [2048, 700, 0]
    d = torch.from_numpy(dets).to(cuda)
    n = torch.tensor(n_valid, dtype=torch.int32, device=cuda)
    before = fn.launches
    got, n_got = fn(d, n, 0.4)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and n_got.shape == (3,)
    for i in range(3):
        one, n_one = fn(d[i].contiguous(), n[i].contiguous(), 0.4)
        assert int(n_one) == int(n_got[i])
        assert torch.equal(one, got[i])
    plain, n_plain = (nms_device.bbox_vote_device_reference
                      if method == "BBOX_VOTE"
                      else nms_device.nms_device_reference)(d, n, 0.4)
    assert torch.equal(n_plain.to(cuda), n_got)
    assert torch.equal(plain[..., 4], got[..., 4])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 176, 234), (8, 176, 240)])
def test_dim_red_conv_off_the_fft_cliff(cuda, shape):
    """conv4_fuse_final_dim_red (3×3, 512→128) at the 1408×1872 level and
    at its detect_many bucket: as detection runs it (layers.conv3x3) it
    adds at most 4 GB of device memory (cuDNN's FFT algorithm took 35 GB
    at batch 2), and agrees with cuDNN run one image at a time."""
    import torch.nn.functional as F
    from smallhardface_tpu_torch.models import layers
    B, H, W = shape
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((B, 512, H, W), device=cuda, generator=gen).contiguous(
        memory_format=torch.channels_last)
    w = (torch.randn((128, 512, 3, 3), device=cuda, generator=gen)
         * 0.02).contiguous(memory_format=torch.channels_last)
    b = torch.randn((128,), device=cuda, generator=gen)
    with torch.inference_mode():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = layers.conv3x3(x, w, b)
        torch.cuda.synchronize()
        added = (torch.cuda.max_memory_allocated() - base
                 - got.numel() * got.element_size())
        want = torch.cat([F.conv2d(x[i:i + 1], w, b, padding=1)
                          for i in range(B)])
    assert added <= 4e9
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got, want, rtol=RTOL,
                               atol=RTOL * want.abs().max().item())
