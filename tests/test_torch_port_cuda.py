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
  and the boxes within VOTE_BOX_TOL of the largest coordinate; on the edge
  cases of its three phases (``ops/vote_cases.edge_case``: V not a
  multiple of 32, n_valid 0, 1 and V, one cluster, no overlap, an IoU
  exactly at the threshold, zero-area and inverted boxes, a second tile of
  columns) and at V = 8192; two calls give the same bits;
- the batched launches of detect_many: K1 on an 8-image batch with eight
  valid extents in one launch (equal to the bit to the plain forward in
  float64 on integers, within RTOL on floats, and to eight single-image
  launches), V1 over three images in one launch (equal to the bit to
  three single launches);
- K4 (``ops/stem.fused_stem_spatial``, spatial detection and training):
  the pooled rows of its shards equal to the bit to one K1 over the whole
  image, one K1 launch a shard, whole and with a valid height inside a
  shard; its backward (one K2 a shard, the partials summed on the
  weights) equal to the bit to one K2 over the whole image on small
  integers;
- conv4_fuse_final_dim_red, as detection runs it, at the shapes where
  cuDNN took an FFT algorithm: at most 4 GB of device memory added;
- the training step's 3×3 backward (``layers.Conv3x3Adjoint``): one
  flagship micro-batch at the 1200×1600 bucket launches no cuDNN FFT
  kernel in its backward, every trainable 3×3 convolution takes the
  adjoint, two backward passes agree to the bit, and each leaf's
  gradient lies within the benchmark's gradient limit of cuDNN's;
- Q1 (the int8 3×3 convolution, csrc/conv_int8.cu): equal to the bit to
  its plain version (float64 sums, then the same fp32 epilogue) for the
  three epilogues at dilations 1, 2 and 4, on random int8 values and on
  the extremes (±127, −128 inputs and weights), with one scale row or one
  per image, at a pixel count that is not a multiple of its 128-pixel
  tile; its wrapper refuses channel counts its tiles do not take; at the
  edges of its tiling (ragged H and W, W smaller than a tile, H = 1,
  dilation 4 beyond the image, B = 3 with a scale row per image) and at
  every K chunk and channel block its plan takes
  (``tests/test_torch_port_conv_int8_tiles.py`` models the same shapes on
  the CPU); on outputs that are all ties (settled without its reciprocal
  product) and on steps at both ends of the range its product takes;
- C1 (the fp32 3×3 convolution of detection, csrc/conv_fp32.cu, 3xTF32
  on the tensor cores): equal to the bit to its plain version (the nine
  products of ``layers.conv3x3_taps``, then the ReLU) on small integers,
  at dilations 1, 2 and 4, with a shard's halo above or below, from 64 to
  512 channels, at the edges of its tiling and on inputs that are not
  channels_last; on floats its largest error against float64 at most
  twice the nine cuBLAS products', the same from run to run; its wrapper
  refuses channel counts its tiles do not take;
- bf16 (TPU.PRECISION = "bfloat16"): a bf16 convolution as the forward
  runs it against the fp32 sum of the same bf16 products rounded once,
  then its bf16 bias; the flagship bf16 forward and a bf16 detect on the
  card against the port's CPU path, with K1's and V1's launches.
"""

import numpy as np
import pytest
import torch

from smallhardface_tpu_torch.ops import anchors as anchors_mod
from smallhardface_tpu_torch.ops import conv_int8, iou, nms_device, stem
from smallhardface_tpu_torch.ops.iou_cases import (BASE, K3_CASES, band_gt,
                                                  crowd_gt, k3_case)
from smallhardface_tpu_torch.ops.vote_cases import (EDGE_CASES, chain_dets,
                                                   crowd_dets, edge_case,
                                                   integer_dets)
from smallhardface_tpu_torch.parallel import spatial

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
@pytest.mark.parametrize("shape,k,valid", [
    ((2, 256, 384, 3), 4, None),
    ((1, 192, 200, 3), 2, (120, 170)),    # the valid height inside shard 1
])
def test_k4_equals_one_k1_to_the_bit(cuda, shape, k, valid):
    """K4 over k shards on the card (one launch of K1 a shard) against one
    K1 over the whole image: each pooled output is computed from the same
    rows in the same order, so the rows are equal to the bit."""
    x, _, *ws = _on(_float_grad_inputs(17, shape, valid or shape[1:3]), cuda)
    want, _ = stem._stem_kernel(x, *ws, valid)
    before = stem.fused_stem.launches, stem.fused_stem_spatial.launches
    with torch.no_grad():
        got = stem.fused_stem_spatial(spatial.split(x, [cuda] * k), *ws,
                                      valid_hw=valid)
    torch.cuda.synchronize()
    assert (stem.fused_stem.launches, stem.fused_stem_spatial.launches) == (
        before[0] + k, before[1] + k)
    assert torch.equal(torch.cat(got, 1), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k,valid", [
    ((2, 128, 128, 3), 4, None),
    ((1, 96, 160, 3), 2, (72, 150)),      # the valid height inside shard 1
])
def test_k4_backward_equals_one_k2_to_the_bit(cuda, shape, k, valid):
    """K4's backward over k shards on the card (one K1 with its routing and
    one K2 a shard, the k partial gradients summed on the leaves) against
    one K2 over the whole image, on the small-integer recipe where every
    product and sum is exact: equal to the bit, and to the plain backward
    in float64."""
    x, dy, *ws = _on(_int_grad_inputs(19, shape, valid or shape[1:3]), cuda)
    want = stem.fused_stem_grad(x, dy, *ws, valid_hw=valid)
    plain = stem.fused_stem_grad_reference(
        x.double(), dy.double(), *[w.double() for w in ws], valid_hw=valid)
    ws = [w.requires_grad_() for w in ws]
    counts = (stem.fused_stem.launches, stem.fused_stem.route_writes,
              stem.fused_stem_grad.launches)
    out = stem.fused_stem_spatial(spatial.split(x, [cuda] * k), *ws,
                                  valid_hw=valid)
    (torch.cat(out, 1) * dy).sum().backward()
    torch.cuda.synchronize()
    assert (stem.fused_stem.launches, stem.fused_stem.route_writes,
            stem.fused_stem_grad.launches) == tuple(c + k for c in counts)
    assert want[0].abs().max() > 0
    for w, a, b in zip(ws, want, plain):
        assert torch.equal(w.grad, a)
        assert torch.equal(w.grad.double(), b)


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


def _vote_pair(method, dets, n_valid, device, thresh=0.4):
    fn = (nms_device.bbox_vote_device if method == "BBOX_VOTE"
          else nms_device.nms_device)
    plain = (nms_device.bbox_vote_device_reference if method == "BBOX_VOTE"
             else nms_device.nms_device_reference)
    d = torch.from_numpy(dets).to(device)
    n = torch.tensor(n_valid, dtype=torch.int32, device=device)
    before = fn.launches
    got, n_got = fn(d, n, thresh)
    want, n_want = plain(d, n, thresh)
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


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["BBOX_VOTE", "NMS"])
@pytest.mark.parametrize("name", EDGE_CASES + ("v8192_crowd", "v8192_chain"))
def test_vote_kernel_edge_cases(cuda, method, name):
    """V1's three phases on the cases the CPU model of them holds
    (tests/test_torch_port_vote_walk.py), and at V = 8192, the most rows
    it takes (eight words of remaining rows a lane): the same rows out,
    the scores equal to the bit, the boxes within VOTE_BOX_TOL, and every
    output equal to the bit where the case is exact."""
    if name == "v8192_crowd":
        dets, n, thresh, exact = (crowd_dets(np.random.RandomState(8), 8192),
                                  8192, 0.4, False)
    elif name == "v8192_chain":
        dets, n, thresh, exact = chain_dets(8192), 8192, 0.4, True
    else:
        dets, n, thresh, exact = edge_case(name)
    got, want, n_out = _vote_pair(method, dets, n, cuda, thresh)
    assert not got[n_out:].any()
    if exact:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 4], want[:, 4])
    peak = max(float(np.abs(dets[:n, :4]).max(initial=1.0)), 1.0)
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0,
                               atol=VOTE_BOX_TOL * peak)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["BBOX_VOTE", "NMS"])
def test_vote_kernel_two_calls_bit_identical(cuda, method):
    """No atomics and a fixed order of every sum: two calls on the same
    input give the same bits, for one image and for a batch."""
    fn = (nms_device.bbox_vote_device if method == "BBOX_VOTE"
          else nms_device.nms_device)
    dets = np.stack([crowd_dets(np.random.RandomState(s), 2048,
                                centres=200, spread=40) for s in (4, 5)])
    d = torch.from_numpy(dets).to(cuda)
    for args in ((d[0].contiguous(), torch.tensor(2048, dtype=torch.int32,
                                                  device=cuda)),
                 (d, torch.tensor([2048, 1500], dtype=torch.int32,
                                  device=cuda))):
        first, n_first = fn(*args, 0.4)
        second, n_second = fn(*args, 0.4)
        torch.cuda.synchronize()
        assert torch.equal(first, second) and torch.equal(n_first, n_second)


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


# the benchmark's limit on the training gradient (portbench
# reference/compare.py ``grad_gap``), here on the norm of each leaf's
# difference from cuDNN's backward, against max(its norm, the median's)
GRAD_GAP = 9e-4


@pytest.mark.cuda
def test_train_backward_off_cudnn_fft(cuda, monkeypatch):
    """One flagship micro-batch at the 1200×1600 bucket (1280×1664), as
    ``grad_step`` runs it: its backward launches no cuDNN FFT kernel
    (``fft2d_*``, ``gemvx``); every 3×3 convolution with a trainable
    weight takes the adjoint (``layers.conv3x3.adjoint_backwards``), none
    cuDNN's backward; two backward passes give the same bits; and each
    leaf's gradient lies within GRAD_GAP of cuDNN's backward on the same
    forward (``Conv3x3Adjoint`` replaced by cuDNN's own convolution)."""
    import contextlib
    import copy
    import os
    from torch.profiler import ProfilerActivity, profile
    from smallhardface_tpu_torch.config import CONFIG_DIR, cfg, cfg_from_file
    from smallhardface_tpu_torch.models import layers
    from smallhardface_tpu_torch.tools import conv_map, train_time
    from smallhardface_tpu_torch.train import train_loop

    kernels = []

    @contextlib.contextmanager
    def traced(name, level=None):
        if name != "backward":
            yield
            return
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            yield
            torch.cuda.synchronize()
        kernels.extend(e.name for e in prof.events()
                       if e.device_type.name == "CUDA")

    def grads(step, stages):
        batch = dict(step.host)
        for k in ("data", "gt", "gt_mask"):
            batch[k] = step.host[k].to(cuda)
        train_loop.grad_step(step.model, step.loss_fn, batch,
                             step.out_shape, 1, stages=stages)
        return {f"{n}.{k}": v.grad.clone()
                for n, leaf in step.params.items()
                for k, v in leaf.items() if v.grad is not None}

    saved = copy.deepcopy(cfg)
    try:
        cfg_from_file(os.path.join(CONFIG_DIR, "default.toml"))
        cfg_from_file(os.path.join(CONFIG_DIR, "smallhardface.toml"))
        step = train_time.Step(cfg, cuda,
                               train_time.make_samples(1200, 1600, 1))
        assert tuple(step.out_shape) == (1280, 1664)
        grads(step, train_loop.no_stages)                    # warm-up
        layers.conv3x3.adjoint_backwards = 0
        layers.conv3x3.cudnn_backwards = 0
        got = grads(step, traced)
        n_convs = len(conv_map.train_convs(1280, 1664))
        assert (layers.conv3x3.adjoint_backwards,
                layers.conv3x3.cudnn_backwards) == (n_convs, 0)
        assert kernels and not [k for k in kernels
                                if "fft2d" in k or "gemvx" in k]
        again = grads(step, train_loop.no_stages)
        assert got.keys() == again.keys()
        assert all(torch.equal(got[k], again[k]) for k in got)
        monkeypatch.setattr(layers.Conv3x3Adjoint, "apply",
                            layers.conv3x3_cudnn)
        want = grads(step, train_loop.no_stages)
    finally:
        cfg.clear()
        cfg.update(saved)
    assert got.keys() == want.keys()
    norms = {k: float(v.double().norm()) for k, v in want.items()}
    med = float(np.median(list(norms.values())))
    for k in want:
        gap = float((got[k].double() - want[k].double()).norm()) / max(
            norms[k], med)
        assert gap <= GRAD_GAP, (k, gap)


def _int8_inputs(device, B, H, W, C, O, extreme, per_image, seed=0):
    """Q1's inputs: int8 activations and (O, 3, 3, C) weights (uniform, or
    only -128, -127, 0, 127 with -128 in the activations), a positive fp32
    scale per channel (one row, or one per image), a bias and an output
    step."""
    gen = torch.Generator().manual_seed(seed)
    if extreme:
        vals = torch.tensor([-128, -127, 0, 127], dtype=torch.int8)
        x = vals[torch.randint(0, 4, (B, H, W, C), generator=gen)]
        w = vals[1:][torch.randint(0, 3, (O, 3, 3, C), generator=gen)]
    else:
        x = torch.randint(-128, 128, (B, H, W, C), generator=gen,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (O, 3, 3, C), generator=gen,
                          dtype=torch.int8)
    scale = torch.rand((B if per_image else 1, O), generator=gen) * 1e-4
    bias = torch.randn((O,), generator=gen)
    x = x.permute(0, 3, 1, 2).to(device)          # channels_last NCHW view
    return x, w.to(device), scale.to(device), bias.to(device), 0.0371


@pytest.mark.cuda
@pytest.mark.parametrize("dilation", [1, 2, 4])
@pytest.mark.parametrize("epilogue", ["link", "end", "dynamic"])
@pytest.mark.parametrize("extreme", [False, True])
def test_conv_int8_kernel_vs_plain(cuda, dilation, epilogue, extreme):
    B, H, W, C, O = 2, 19, 23, 64, 128          # 874 pixels: a ragged tile
    x, w, scale, bias, s_out = _int8_inputs(
        cuda, B, H, W, C, O, extreme, per_image=epilogue == "dynamic")
    kw = {"dilation": dilation, "relu": epilogue != "dynamic",
          "s_out": s_out if epilogue == "link" else None}
    before = conv_int8.conv3x3_int8.launches
    got = conv_int8.conv3x3_int8(x, w, scale, bias, **kw)
    want = conv_int8.conv3x3_int8_reference(x, w, scale, bias, **kw)
    torch.cuda.synchronize()
    assert conv_int8.conv3x3_int8.launches == before + 1
    assert got.dtype == (torch.int8 if epilogue == "link" else torch.float32)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("C,O", [(32, 64), (512, 512), (512, 128)])
def test_conv_int8_kernel_channel_counts(cuda, C, O):
    x, w, scale, bias, s_out = _int8_inputs(cuda, 1, 9, 140, C, O, False,
                                            per_image=False, seed=1)
    got = conv_int8.conv3x3_int8(x, w, scale, bias, s_out=s_out)
    want = conv_int8.conv3x3_int8_reference(x, w, scale, bias, s_out=s_out)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_conv_int8_wrapper_refuses_what_the_tiles_do_not_take(cuda):
    x, w, scale, bias, _ = _int8_inputs(cuda, 1, 8, 8, 48, 64, False, False)
    with pytest.raises(ValueError, match="multiple"):
        conv_int8.conv3x3_int8(x, w, scale, bias)
    x, w, scale, bias, _ = _int8_inputs(cuda, 1, 8, 8, 32, 96, False, False)
    with pytest.raises(ValueError, match="multiple"):
        conv_int8.conv3x3_int8(x, w, scale, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,O,dilation,epilogue", [
    (2, 19, 23, 64, 128, 1, "link"),        # ragged H and W
    (2, 40, 5, 64, 128, 2, "link"),         # W smaller than a tile
    (1, 1, 37, 64, 128, 1, "link"),         # H = 1
    (1, 1, 37, 32, 64, 4, "end"),
    (1, 3, 3, 128, 128, 4, "end"),          # dilation 4 beyond the image
    (3, 17, 30, 64, 128, 1, "dynamic"),     # B = 3, a scale row per image
    (3, 5, 9, 256, 256, 2, "dynamic"),
    (1, 3, 10, 32, 64, 1, "link"),          # each K chunk and channel block
    (1, 3, 10, 64, 128, 1, "end"),
    (1, 3, 10, 512, 512, 1, "link"),
    (1, 3, 10, 512, 128, 1, "dynamic"),
])
def test_conv_int8_kernel_tile_edges(cuda, B, H, W, C, O, dilation, epilogue):
    x, w, scale, bias, s_out = _int8_inputs(
        cuda, B, H, W, C, O, False, per_image=epilogue == "dynamic", seed=2)
    kw = {"dilation": dilation, "relu": epilogue != "dynamic",
          "s_out": s_out if epilogue == "link" else None}
    before = conv_int8.conv3x3_int8.launches
    got = conv_int8.conv3x3_int8(x, w, scale, bias, **kw)
    want = conv_int8.conv3x3_int8_reference(x, w, scale, bias, **kw)
    torch.cuda.synchronize()
    assert conv_int8.conv3x3_int8.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("C,O", [(64, 128), (256, 256)])
def test_conv_int8_kernel_requantizes_ties_as_the_division(cuda, C, O):
    """A scale of 1, a bias of ½ and a step of 1 make every requantized
    value a tie (k + ½), which the kernel settles without its reciprocal
    product: equal to the bit to the plain version's round-half-even."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randint(-2, 3, (2, 19, 23, C), generator=gen, dtype=torch.int8)
    w = torch.randint(-2, 3, (O, 3, 3, C), generator=gen, dtype=torch.int8)
    args = (x.permute(0, 3, 1, 2).to(cuda), w.to(cuda),
            torch.ones((1, O), device=cuda), torch.full((O,), 0.5,
                                                        device=cuda))
    got = conv_int8.conv3x3_int8(*args, s_out=1.0)
    want = conv_int8.conv3x3_int8_reference(*args, s_out=1.0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("step", [1e-30, 2.0 ** -61, 2.0 ** -60, 3e20])
def test_conv_int8_kernel_steps_at_the_ends_of_the_range(cuda, step):
    """A chain link whose step lies outside [2^-60, 2^60] divides every
    output: equal to the bit to the plain version on both sides."""
    x, w, scale, bias, s_out = _int8_inputs(cuda, 2, 19, 23, 128, 256, False,
                                            per_image=False, seed=4)
    scale, bias = scale * (step / s_out), bias * (step / s_out)
    got = conv_int8.conv3x3_int8(x, w, scale, bias, s_out=step)
    want = conv_int8.conv3x3_int8_reference(x, w, scale, bias, s_out=step)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# bf16 (TPU.PRECISION = "bfloat16") on the card: the share of a bf16
# convolution's outputs that may differ from the fp32 sum of the same bf16
# products rounded once (chip_smoke.py's BF16_CONV_MAX_DIFFER), and the
# match floor of the loose rule of tests/test_full_detect_golden.py's bf16
# drift test for a two-level detect on the card against the CPU path
# (chip_smoke.py holds detect_many to it, and its five-level card-vs-CPU
# comparison on a crowded image to 0.90)
BF16_CONV_MAX_DIFFER = 0.01
BF16_MATCH_MIN = 0.95


def _c1_int_inputs(device, B, C, O, H, W, seed=0):
    """C1's integer recipe: |x| <= 64, |w| <= 8, |b| <= 100, so every value
    is its own TF32 hi and every product and sum is exact in fp32."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(-64, 65, (B, C, H, W), generator=gen).float()
    w = torch.randint(-8, 9, (O, C, 3, 3), generator=gen).float()
    b = torch.randint(-100, 101, (O,), generator=gen).float()
    return (x.to(device).contiguous(memory_format=torch.channels_last),
            w.to(device), b.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dilation", [1, 2, 4])
@pytest.mark.parametrize("halo", ["none", "top", "bottom"])
@pytest.mark.parametrize("B,C,O,relu", [(1, 64, 128, True),
                                        (2, 128, 64, False),
                                        (2, 512, 512, True)])
def test_conv_fp32_kernel_vs_plain_on_integers(cuda, dilation, halo, B, C,
                                               O, relu):
    """C1 (csrc/conv_fp32.cu) equal to the bit to its plain version (the
    nine products of ``layers.conv3x3_taps``, then the ReLU) on the integer
    recipe, at dilations 1, 2 and 4, with a shard's halo above or below,
    on a ragged tile; one launch, a channels_last output."""
    from smallhardface_tpu_torch.models import layers
    from smallhardface_tpu_torch.ops import conv_fp32
    rows = {"none": (0, 0), "top": (dilation, 0),
            "bottom": (0, dilation)}[halo]
    x, w, b = _c1_int_inputs(cuda, B, C, O, 19 + sum(rows), 23)
    before = conv_fp32.conv3x3_fp32.launches
    got = conv_fp32.conv3x3_fp32(x, w, b, dilation=dilation, halo=rows,
                                 relu=relu)
    want = layers.conv3x3_taps(x, w, b, dilation=dilation, halo=rows)
    if relu:
        want = want.relu_()
    torch.cuda.synchronize()
    assert conv_fp32.conv3x3_fp32.launches == before + 1
    assert got.shape == (B, O, 19, 23)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,O", [(1, 1, 37, 64, 64),   # H = 1
                                       (2, 40, 5, 64, 128),  # W under a tile
                                       (1, 3, 3, 256, 128),  # d 4 beyond it
                                       (3, 17, 130, 64, 192)])
def test_conv_fp32_kernel_tile_edges(cuda, B, H, W, C, O):
    """C1 at the edges of its tiling, equal to the bit to its plain
    version on the integer recipe, also on an input that is not
    channels_last (read from a copy) and one whose rows are a view."""
    from smallhardface_tpu_torch.models import layers
    from smallhardface_tpu_torch.ops import conv_fp32
    x, w, b = _c1_int_inputs(cuda, B, C, O, H + 2, W, seed=1)
    for xi in (x, x.contiguous(), x[:, :, 1:H + 1]):
        got = conv_fp32.conv3x3_fp32(xi, w, b, dilation=4)
        want = layers.conv3x3_taps(xi, w, b, dilation=4)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_conv_fp32_kernel_float_error_is_the_products_size(cuda):
    """On floats (post-ReLU inputs, He-scaled weights) C1's largest error
    against a float64 reference is at most twice that of the nine cuBLAS
    fp32 products (chip_smoke.py's C1_ERR_OVER_TAPS), and two calls agree
    to the bit."""
    from smallhardface_tpu_torch.models import layers
    from smallhardface_tpu_torch.ops import conv_fp32
    gen = torch.Generator().manual_seed(4)
    x = torch.relu(torch.randn((2, 256, 40, 56), generator=gen)).to(cuda)
    x = x.contiguous(memory_format=torch.channels_last)
    w = (torch.randn((256, 256, 3, 3), generator=gen) / 48).to(cuda)
    b = (torch.randn((256,), generator=gen) * 0.1).to(cuda)
    got = conv_fp32.conv3x3_fp32(x, w, b, dilation=2)
    again = conv_fp32.conv3x3_fp32(x, w, b, dilation=2)
    taps = layers.conv3x3_taps(x, w, b, dilation=2)
    want = torch.nn.functional.conv2d(x.double(), w.double(), b.double(),
                                      padding=2, dilation=2)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    err = (got.double() - want).abs().max().item()
    taps_err = (taps.double() - want).abs().max().item()
    assert err <= 2.0 * taps_err, (err, taps_err)


@pytest.mark.cuda
def test_conv_fp32_wrapper_refuses_what_the_tiles_do_not_take(cuda):
    from smallhardface_tpu_torch.ops import conv_fp32
    for C, O in ((96, 64), (64, 96)):
        x, w, b = _c1_int_inputs(cuda, 1, C, O, 8, 8)
        with pytest.raises(ValueError, match="multiple"):
            conv_fp32.conv3x3_fp32(x, w, b)


@pytest.mark.cuda
@pytest.mark.parametrize("k,dilation,C,O", [
    (3, 1, 64, 128), (3, 4, 128, 128), (1, 1, 512, 256)],
    ids=["3x3_d1", "3x3_d4", "1x1"])
def test_bf16_conv_rounds_once_on_the_card(cuda, k, dilation, C, O):
    """A bf16 convolution as the forward runs it on the card (cuDNN on bf16
    tensors, no bias, then the bf16 bias) against the plain version, the
    fp32 sum of the same products (TF32 off) rounded once: at most
    BF16_CONV_MAX_DIFFER of the outputs differ, each within two fp32 sums
    of the same terms plus a bf16 ulp; where the products agree, the
    biased outputs agree to the bit."""
    import math
    import torch.nn.functional as F
    from smallhardface_tpu_torch.models import layers
    gen = torch.Generator(device=cuda).manual_seed(k + dilation)
    x = (torch.randn((2, C, 88, 120), device=cuda, generator=gen)
         * 3).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w = torch.randn((O, C, k, k), device=cuda, generator=gen) * math.sqrt(
        2 / (k * k * C))
    b = torch.randn((O,), device=cuda, generator=gen)
    pad = dilation if k == 3 else 0
    with torch.inference_mode():
        got = layers.conv2d(x, w, None, dilation=dilation, padding=pad)
        wr = w.to(torch.bfloat16).float()
        ref = F.conv2d(x.float(), wr, None, dilation=dilation,
                       padding=pad).to(torch.bfloat16)
        abs_sum = F.conv2d(x.float().abs(), wr.abs(), None,
                           dilation=dilation, padding=pad)
        got_b = layers.conv2d(x, w, b, dilation=dilation, padding=pad)
    assert got.dtype == got_b.dtype == torch.bfloat16
    differ = got != ref
    ulp = torch.maximum(got.float().abs(), ref.float().abs()) * 2.0 ** -7
    bound = 2 * k * k * C * 2.0 ** -23 * abs_sum + ulp
    assert differ.float().mean().item() <= BF16_CONV_MAX_DIFFER
    assert ((got.float() - ref.float()).abs() <= bound).all()
    want_b = ref + b.to(torch.bfloat16)[:, None, None]
    assert torch.equal(got_b[~differ], want_b[~differ])


@pytest.mark.cuda
def test_bf16_forward_on_the_card_vs_cpu(cuda):
    """The flagship network in bf16 at full width on a 1×64×128 input, on
    the card (K1 in fp32 on the bf16-rounded input, cuDNN's bf16
    convolutions) against the port's CPU path: the bf16 noise of a deep
    network, rtol 1e-1, atol 0.025·peak (tests/test_torch_port_bf16.py's
    bound against JAX); K1 launches once."""
    from smallhardface_tpu_torch.models import detector as tdm
    spec = tdm.ModelSpec(different_dilation=True)
    params = tdm.init_params(torch.Generator().manual_seed(7), spec)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        1, 64, 128, 3).astype(np.float32) * 30)
    cpu = tdm.Detector(params, spec, "cpu")
    card = tdm.Detector(params, spec, cuda)
    stem.fused_stem.launches = 0
    with torch.inference_mode():
        want = cpu(x, precision="bfloat16")
        got = card(x.to(cuda), precision="bfloat16")
        torch.cuda.synchronize()
    assert stem.fused_stem.launches == 1
    for k in ("cls_logits", "bbox_deltas"):
        g, r = got[k].cpu(), want[k]
        assert g.dtype == torch.float32 and g.shape == r.shape
        torch.testing.assert_close(g, r, rtol=1e-1,
                                   atol=0.025 * r.abs().max().item())


def _loose_match(a, b):
    """The bf16 drift test's rule: IoU > 0.6 and |Δscore| < 0.1."""
    if len(a) == 0:
        return 1.0 if len(b) == 0 else 0.0
    from smallhardface_tpu_torch.ops import bbox_np
    iou = bbox_np.bbox_overlaps(a[:, :4], b[:, :4])
    best = iou.argmax(axis=1)
    ok = (iou[np.arange(len(a)), best] > 0.6) & (
        np.abs(a[:, 4] - b[best, 4]) < 0.1)
    return float(ok.mean())


@pytest.mark.cuda
def test_bf16_detect_on_the_card_vs_cpu(cuda):
    """TorchDetector in bf16 on a seeded 300×400 image at TEST.SCALES
    [100, 300] with flip, on the card against the CPU path: the counts
    within max(3, 5 %), each side matched at BF16_MATCH_MIN by the loose
    rule; K1 launches once a level and V1 once."""
    import copy
    from smallhardface_tpu_torch.config import cfg
    from smallhardface_tpu_torch.detect import TorchDetector
    from smallhardface_tpu_torch.models import detector as tdm
    saved = copy.deepcopy(cfg)
    try:
        cfg.TEST.SCALES, cfg.TEST.FLIP = [100, 300], True
        cfg.TPU.PRECISION = "bfloat16"
        spec = tdm.ModelSpec(different_dilation=True)
        params = tdm.init_params(torch.Generator().manual_seed(3), spec)
        for k in tdm.ANCHOR_SCALES:
            params[f"cls_score_{k}"]["b"] = torch.tensor([1.2, -1.2])
        im = np.random.RandomState(5).randint(0, 256, (300, 400, 3),
                                              dtype=np.uint8)
        want = TorchDetector(params, spec, "cpu").detect(im, 0.05)[0][0]
        stem.fused_stem.launches = nms_device.bbox_vote_device.launches = 0
        got = TorchDetector(params, spec, cuda).detect(im, 0.05)[0][0]
        assert stem.fused_stem.launches == 2
        assert nms_device.bbox_vote_device.launches == 1
    finally:
        cfg.clear()
        cfg.update(saved)
    assert len(want) > 5
    assert abs(len(got) - len(want)) <= max(3, 0.05 * len(want))
    assert _loose_match(got, want) >= BF16_MATCH_MIN
    assert _loose_match(want, got) >= BF16_MATCH_MIN
