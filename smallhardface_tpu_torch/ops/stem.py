"""Fused VGG stem: conv1_1 + ReLU + conv1_2 + ReLU + 2×2/2 max pool, and
its backward.

Counterpart of ``smallhardface_tpu/ops/pallas_stem.py``: the TPU kernel
``_kernel`` (pallas_stem.py:69), reached through ``_stem_call`` /
``_stem_op`` / ``fused_stem``, becomes the CUDA C++ kernel ``csrc/stem.cu``
(K1), and its backward ``_grad_kernel`` (pallas_stem.py:460, reached through
``_stem_grad_call`` / ``_stem_op_bwd``) becomes ``csrc/stem_grad.cu`` (K2),
both for Hopper (sm_90a). Each source's header says what bounds it on an
H100 and what the design does about that. K1 runs conv1_1 in fp32 on the
CUDA cores and conv1_2 on the tensor cores in error-compensated TF32
(3xTF32); where a weight needs a gradient it also writes the pool's
routing, which K2 reads instead of recomputing conv1_2. K2 recomputes
conv1_1 with K1's very loop (the one piece of arithmetic they share) and
runs its two 64-channel products in 3xTF32 too.

- ``fused_stem_reference``: the plain PyTorch forward (two ``F.conv2d``,
  the masks, ``max_pool2d``). The CPU path and K1's oracle.
- ``fused_stem_route_reference``: the pool's routing codes of the plain
  forward (0..3 the window element that takes the gradient, 4 none), K1's
  oracle for its ``route`` output; ``route_scatter_reference``: dy scattered
  by those codes, the plain version of K2's first stage.
- ``fused_stem``: the differentiable wrapper. On a CPU tensor it is the
  plain version and autograd differentiates it. On a CUDA tensor it runs
  ``StemFunction``: the forward launches K1 (writing the routing only when
  grad mode is on and a weight needs a gradient), the backward launches
  K2, or it raises; it never falls back. ``fused_stem.launches`` counts
  K1's launches, ``fused_stem.route_writes`` those that wrote a routing.
  For detection of a bucketed batch the valid extent may be given per
  image (two (B,) int tensors, K1 reads them from the device in one
  launch); then no weight may need a gradient.
- ``fused_stem_spatial``: K4, the stem over an H-sharded image
  (pallas_stem.py:250-429): per shard, ``fused_stem`` (K1 on a CUDA
  tensor, and K2 in its backward) on the shard's rows and TH = 8 rows of
  each inner neighbour, then the shard's own pooled rows. It needs no
  first valid row ``r0``: K1's and K2's own zero padding stands at the
  image's edges.
- ``fused_stem_grad_reference``: the plain backward, ``torch.autograd.grad``
  through ``fused_stem_reference`` with dy zeroed beyond the pooled valid
  extent. K2's oracle.
- ``fused_stem_grad``: K2's wrapper, d(w1, b1, w2, b2) given dy; the image
  gets no gradient (pallas_stem.py:753-756). ``fused_stem_grad.launches``
  counts K2's launches.
- ``fused_stem_grad_products``: K2's products in plain PyTorch on a given
  routing (conv1_1's activations and the routed gradient dpre2, K2's own
  scratch on the card): the check of K2's tensor-core arithmetic alone,
  with no pool or ReLU flip in it.
- ``STEM`` / ``STEM_GRAD``: the two kernel libraries, built with ``nvcc`` at
  first use into ``csrc/build/`` (``ops/cuda_build.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from smallhardface_tpu_torch.models.layers import per_item, zero_outside
from smallhardface_tpu_torch.ops.cuda_build import CI, VP, CudaLibrary
from smallhardface_tpu_torch.parallel import spatial

STEM = CudaLibrary("stem", "stem.cu",
                   {"shf_stem_forward": [VP] * 8 + [CI] * 5 + [VP] * 2})
STEM_GRAD = CudaLibrary("stem_grad", "stem_grad.cu",
                        {"shf_stem_grad": [VP] * 12 + [CI] * 7 + [VP]})
GRAD_CHUNKS = 256       # pixel chunks of K2's weight gradient (fixed order)
_KT = 32                # pixels per step of that gradient (stem_grad.cu)
_W2_SPLIT = 9 * 64 * 64 * 2    # w2 (K1) or w2f (K2) as TF32 hi/lo fragments
NO_ROUTE = 4            # route code: no element of the window takes dy
TH = 8                  # K4's halo: input rows taken from each neighbour


def conv1_1_reference(x, w1, b1, valid_hw=None):
    """conv1_1 + ReLU of the plain stem, NCHW (B, 64, H, W), zero outside
    the valid extent (and its input masked the same way before the conv)."""
    h = x.permute(0, 3, 1, 2)
    if valid_hw is not None:
        h = zero_outside(h, *valid_hw)
    h = F.relu(F.conv2d(h, w1, b1, padding=1))
    if valid_hw is not None:
        h = zero_outside(h, *valid_hw)
    return h


def fused_stem_reference(x, w1, b1, w2, b2, valid_hw=None):
    """Plain PyTorch stem. x: NHWC (B, H, W, 3) fp32; w1 (64, 3, 3, 3) and
    w2 (64, 64, 3, 3) OIHW. With ``valid_hw=(vh, vw)`` the input and the
    conv1_1 activations are zero outside [0, vh) × [0, vw) before each conv
    reads them (pallas_stem.py:98-104, :120-123); vh and vw may be (B,)
    int tensors, one extent per image. Pooling keeps Caffe's ceil mode, so
    odd sizes work here. Returns NHWC (B, ⌈H/2⌉, ⌈W/2⌉, 64)."""
    h = conv1_1_reference(x, w1, b1, valid_hw)
    h = F.relu(F.conv2d(h, w2, b2, padding=1))
    h = F.max_pool2d(h, 2, 2, ceil_mode=True)
    return h.permute(0, 2, 3, 1).contiguous()


def fused_stem_route_reference(x, w1, b1, w2, b2, valid_hw=None):
    """The pool's routing of the plain stem, uint8 NHWC (B, H/2, W/2, 64),
    H and W even: for each 2×2 window and channel, the row-major index
    (0..3) of the FIRST maximal element of relu(conv1_2), if that element's
    pre-activation is > 0, else ``NO_ROUTE`` (4). That is where autograd
    through max_pool2d and ReLU sends the window's gradient, and what K1
    writes as its ``route``."""
    B, H, W = _kernel_shapes(x, "fused_stem_route_reference")
    h = F.relu(F.conv2d(conv1_1_reference(x, w1, b1, valid_hw), w2, b2,
                        padding=1))
    win = h.reshape(B, 64, H // 2, 2, W // 2, 2).permute(0, 2, 4, 1, 3, 5)
    win = win.reshape(B, H // 2, W // 2, 64, 4)
    top = win.amax(-1)
    eq = win == top[..., None]
    first = torch.where(eq[..., 0], 0, torch.where(
        eq[..., 1], 1, torch.where(eq[..., 2], 2, 3)))
    return torch.where(top > 0, first, NO_ROUTE).to(torch.uint8)


def route_scatter_reference(dy, route, valid_hw=None):
    """The plain version of K2's first stage: dpre2 NHWC (B, H, W, 64), the
    gradient before conv1_2's ReLU. dy (B, H/2, W/2, 64) goes to the window
    element its route code names, nowhere for ``NO_ROUTE``; dy is zero at
    pooled positions (q, p) with 2q >= vh or 2p >= vw."""
    B, Hp, Wp, C = dy.shape
    if valid_hw is not None:
        dy = zero_outside(dy.permute(0, 3, 1, 2), (valid_hw[0] + 1) // 2,
                          (valid_hw[1] + 1) // 2).permute(0, 2, 3, 1)
    codes = torch.arange(4, device=dy.device)
    win = torch.where(route[..., None].long() == codes, dy[..., None], 0.0)
    win = win.reshape(B, Hp, Wp, C, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return win.reshape(B, 2 * Hp, 2 * Wp, C)


def fused_stem_grad_reference(x, dy, w1, b1, w2, b2, valid_hw=None):
    """Plain backward: (dw1, db1, dw2, db2), OIHW like the weights, of
    sum(fused_stem_reference(x, w…) * dy), with dy zero at pooled
    positions (q, p) with 2q >= vh or 2p >= vw (pallas_stem.py:520-525).
    max_pool2d's backward sends each window's gradient to its first
    maximal element in row-major order and ReLU's where the activation is
    > 0, the semantics of the TPU kernel."""
    with torch.enable_grad():
        ws = [w.detach().requires_grad_(True) for w in (w1, b1, w2, b2)]
        out = fused_stem_reference(x.detach(), *ws, valid_hw=valid_hw)
        if valid_hw is not None:
            dy = zero_outside(dy.permute(0, 3, 1, 2), (valid_hw[0] + 1) // 2,
                              (valid_hw[1] + 1) // 2).permute(0, 2, 3, 1)
        return tuple(torch.autograd.grad(out, ws, dy))


def _check(t, name, shape, what="fused_stem", dtype=torch.float32):
    if t.device.type != "cuda" or t.dtype != dtype:
        raise ValueError(f"{what}: {name} must be a CUDA {dtype} tensor, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what}: {name} must be contiguous and 16-byte "
                         "aligned")


def _kernel_shapes(x, what):
    if x.dim() != 4 or x.shape[3] != 3:
        raise ValueError(f"{what}: x must be (B, H, W, 3), got "
                         f"{tuple(x.shape)}")
    B, H, W, _ = x.shape
    if H % 2 or W % 2:
        raise ValueError(f"{what}: the kernel needs even H and W, got "
                         f"{H}x{W}")
    return B, H, W


def _hwio(w1, w2):
    """OIHW → the kernels' HWIO: w1 as (27, 64) rows (dy, dx, ci), w2 as 9
    taps of (ci, co), the JAX package's layout."""
    return (w1.detach().permute(2, 3, 1, 0).contiguous(),
            w2.detach().permute(2, 3, 1, 0).contiguous())


def _valid(H, W, valid_hw):
    if valid_hw is not None and per_item(valid_hw[0]):
        raise NotImplementedError(
            "fused_stem: per-image valid extents are for detection only; "
            "the stem's backward (K2) takes one extent for the whole batch "
            "(ROADMAP queue 2)")
    return (H, W) if valid_hw is None else (int(valid_hw[0]),
                                            int(valid_hw[1]))


def _extents(x, valid_hw):
    """(vh, vw, extents) for K1: one extent for the batch as two ints, or
    per image as a device int32 (B, 2) array of (vh, vw) rows."""
    B, H, W, _ = x.shape
    if valid_hw is None or not per_item(valid_hw[0]):
        return (*_valid(H, W, valid_hw), None)
    ext = torch.stack([valid_hw[0], valid_hw[1]], dim=1).to(
        device=x.device, dtype=torch.int32).contiguous()
    _check(ext, "per-image valid extents", (B, 2), dtype=torch.int32)
    return H, W, ext


def _stem_kernel(x, w1, b1, w2, b2, valid_hw, with_route=False):
    """Launch K1 on the current stream. Returns (out, route): route is the
    pool's routing (uint8 NHWC) when ``with_route``, else None and K1 gets
    a null pointer and writes none."""
    B, H, W = _kernel_shapes(x, "fused_stem")
    w1k, w2k = _hwio(w1, w2)
    b1, b2 = b1.detach(), b2.detach()
    _check(x, "x", (B, H, W, 3))
    _check(w1k, "w1", (3, 3, 3, 64))
    _check(b1, "b1", (64,))
    _check(w2k, "w2", (3, 3, 64, 64))
    _check(b2, "b2", (64,))
    vh, vw, ext = _extents(x, valid_hw)
    lib = STEM.load()
    out = torch.empty((B, H // 2, W // 2, 64), dtype=torch.float32,
                      device=x.device)
    route = (torch.empty((B, H // 2, W // 2, 64), dtype=torch.uint8,
                         device=x.device) if with_route else None)
    wsplit = torch.empty(_W2_SPLIT, dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    STEM.check(lib.shf_stem_forward(
        x.data_ptr(), w1k.data_ptr(), b1.data_ptr(), w2k.data_ptr(),
        b2.data_ptr(), wsplit.data_ptr(), out.data_ptr(),
        None if route is None else route.data_ptr(), B, H, W, vh, vw,
        None if ext is None else ext.data_ptr(), stream), "fused_stem")
    fused_stem.launches += 1
    fused_stem.route_writes += with_route
    return out, route


class StemFunction(torch.autograd.Function):
    """The stem on the card: K1 forward, K2 backward. The image carries no
    gradient (conv1_1 reads the input; pallas_stem.py:753-756). K1 writes
    the pool's routing, saved for K2, only when ``grad_enabled`` (grad mode
    outside ``apply``; inside forward it is always off) and a weight needs
    a gradient: detection under ``no_grad``/``inference_mode`` and a step
    with conv1 frozen write none."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, valid_hw, grad_enabled):
        with_route = grad_enabled and any(ctx.needs_input_grad[1:5])
        out, route = _stem_kernel(x, w1, b1, w2, b2, valid_hw, with_route)
        ctx.save_for_backward(x, w1, b1, w2, b2, route)
        ctx.valid_hw = valid_hw
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2, b2, route = ctx.saved_tensors
        grads = fused_stem_grad(x, dy.contiguous(), w1, b1, w2, b2,
                                ctx.valid_hw, route)
        return (None, *grads, None, None)


def fused_stem(x, w1, b1, w2, b2, valid_hw=None):
    """relu(conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2) → 2×2/2 max pool,
    with exact valid-extent masking (see ``fused_stem_reference``).

    x: NHWC (B, H, W, 3) float32, contiguous; weights OIHW as the port
    keeps them. On a CPU tensor this is the plain version. On a CUDA
    tensor it launches K1 on the current stream (H and W must be even) or
    raises, and its gradient with respect to the weights launches K2; it
    never falls back. ``valid_hw`` may give each image its own extent as
    two (B,) int tensors (a bucketed detection batch, one launch): then no
    weight may need a gradient, since K2 takes one extent for the batch,
    and it raises if one does. Returns NHWC (B, H/2, W/2, 64).
    """
    if (valid_hw is not None and per_item(valid_hw[0])
            and torch.is_grad_enabled()
            and any(t.requires_grad for t in (w1, b1, w2, b2))):
        raise NotImplementedError(
            "fused_stem: per-image valid extents with a stem weight that "
            "needs a gradient; the stem's backward (K2) takes one extent "
            "for the whole batch (ROADMAP queue 2)")
    if x.device.type != "cuda":
        return fused_stem_reference(x, w1, b1, w2, b2, valid_hw)
    return StemFunction.apply(x, w1, b1, w2, b2, valid_hw,
                              torch.is_grad_enabled())


fused_stem.launches = 0
fused_stem.route_writes = 0


def _clip_rows(v, lo, hi):
    """v - lo clipped to [0, hi], v a number or an int tensor."""
    if isinstance(v, torch.Tensor):
        return (v - lo).clamp(0, hi)
    return min(max(int(v) - lo, 0), hi)


def fused_stem_spatial(shards, w1, b1, w2, b2, valid_hw=None):
    """K4: ``fused_stem`` over an H-sharded image (JAX
    ``fused_stem_spatial`` and its custom VJP, pallas_stem.py:250-429).

    shards: NHWC (B, Hs, W, 3) float32 tensors, the i-th holding global
    rows [i·Hs, (i + 1)·Hs) on its device, Hs even and at least TH (the
    layout of ``parallel.spatial``). Each shard runs ``fused_stem`` (K1 on
    a CUDA tensor, one launch a shard; the plain version on the CPU) on
    its strip: its own rows with TH = 8 rows of the shard above and below
    (``spatial.halo``), none at the image's top and bottom, and the valid
    height of the strip's rows; then it keeps its own Hs/2 pooled rows.
    ``valid_hw``: the GLOBAL extent (numbers, or (B,) int tensors per
    image), None for the whole image. Returns the shards' pooled rows, NHWC
    (B, Hs/2, W/2, 64) each on its device.

    Why no first valid row: JAX runs every shard on a strip of Hs + 2·TH
    rows, the top shard's upper TH rows being ppermute's zeros, and masks
    them with r0 = TH (pallas_stem.py:352), so that conv1_2 reads conv1_1
    as 0 there and not relu(b1). Here the top shard's strip has no upper
    rows, and K1's own zero padding of the input and of conv1_1 is exactly
    that mask; the bottom edge is the same, with the valid height masking
    the rest. Each pooled output depends only on its window's rows, all
    inside the strip (3 rows past the shard's edge at most), so the kept
    rows are one K1's over the whole image.

    The backward is autograd's through the same calls: each strip's
    ``fused_stem`` saves K1's routing and runs K2 on the strip; ``narrow``
    hands it zero dy on the halo's pooled rows (JAX's ``dy_ext``,
    pallas_stem.py:405-408), so each dy entry drives one strip's K2; and
    the ``.to`` of each weight to the strip's device keeps its autograd
    link, which sums the k partial weight gradients onto the caller's
    leaves (JAX's psum, :420-421). The strips start at global rows
    i·Hs − TH, so the valid height of a strip stays even when the global
    one is (K2's rule). Per-image extents with a stem weight that needs a
    gradient raise, as in ``fused_stem``.

    ``fused_stem_spatial.launches`` counts the K1 launches K4 makes (one
    a shard on a CUDA device); they count in ``fused_stem.launches`` too.
    Its backward's K2 launches (one a shard when a stem weight takes a
    gradient) count in ``fused_stem_grad.launches``. One shard is
    ``fused_stem`` itself."""
    if len(shards) == 1:
        return [fused_stem(shards[0], w1, b1, w2, b2, valid_hw=valid_hw)]
    rows = shards[0].shape[1]
    if any(s.shape[1] != rows for s in shards) or rows % 2 or rows < TH:
        raise ValueError("fused_stem_spatial: the shards need one even row "
                         f"count of at least {TH}, got "
                         f"{[s.shape[1] for s in shards]}")
    W = shards[0].shape[2]
    vh, vw = (rows * len(shards), W) if valid_hw is None else valid_hw
    out = []
    for i, (strip, (top, _)) in enumerate(spatial.halo(shards, TH, dim=1)):
        dev = strip.device
        # no detach: a copy on another card carries its gradient home
        ws = [t.to(dev) for t in (w1, b1, w2, b2)]
        start = i * rows - top              # the strip's first global row
        local = (_clip_rows(vh, start, strip.shape[1]), vw)
        pooled = fused_stem(strip.contiguous(), *ws, valid_hw=local)
        fused_stem_spatial.launches += dev.type == "cuda"
        out.append(pooled.narrow(1, top // 2, rows // 2))
    return out


fused_stem_spatial.launches = 0


def fused_stem_grad_products(x, c1, dpre2, w2, valid_hw=None):
    """K2's products on a given routing, in plain PyTorch: from c1 (conv1_1
    after its ReLU and mask) and dpre2 (the gradient routed through the
    pool and conv1_2's ReLU), both NHWC (B, H, W, 64), returns
    (dpre1 NHWC, dw1, db1, dw2, db2), the grads OIHW:
    dpre1 = (the data gradient of conv1_2) * (c1 > 0), dw2 and db2 from c1
    and dpre2, dw1 and db1 from the masked x and dpre1. Computes in the
    inputs' dtype."""
    h = x.permute(0, 3, 1, 2)
    if valid_hw is not None:
        h = zero_outside(h, *valid_hw)
    c = c1.permute(0, 3, 1, 2)
    d2 = dpre2.permute(0, 3, 1, 2)
    dc1 = torch.nn.grad.conv2d_input(c.shape, w2, d2, padding=1)
    d1 = torch.where(c > 0, dc1, torch.zeros_like(dc1))
    dw2 = torch.nn.grad.conv2d_weight(c, w2.shape, d2, padding=1)
    dw1 = torch.nn.grad.conv2d_weight(h, (c.shape[1], h.shape[1], 3, 3), d1,
                                      padding=1)
    return (d1.permute(0, 2, 3, 1), dw1, d1.sum((0, 2, 3)), dw2,
            d2.sum((0, 2, 3)))


def _grad_scratch(B, H, W, device):
    """K2's scratch: c1, dpre2, dpre1 NHWC (B, H, W, 64), w2f split into
    TF32 fragments, the chunk partials and the summed output, and the
    chunking of the weight gradient's pixels."""
    n_pix = B * H * W
    chunk_len = -(-n_pix // GRAD_CHUNKS)
    chunk_len = -(-chunk_len // _KT) * _KT
    n_chunk = -(-n_pix // chunk_len)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa: E731
                                     device=device)
    return {"c1": new(B, H, W, 64), "dpre2": new(B, H, W, 64),
            "dpre1": new(B, H, W, 64),
            "w2f_split": torch.empty(_W2_SPLIT, dtype=torch.int32,
                                     device=device),
            "partial": new(10, n_chunk, 64, 64), "out": new(10, 64, 64),
            "n_chunk": n_chunk, "chunk_len": chunk_len}


def _stem_grad_launch(x, dy, w1, b1, w2, b2, valid_hw=None, route=None):
    """Launch K2 on the current stream, and K1 before it to make the pool's
    routing when ``route`` is None (that launch counts in
    ``fused_stem.launches``); counts no K2 launch. Returns ((dw1, db1, dw2,
    db2) OIHW, its scratch from ``_grad_scratch``)."""
    B, H, W = _kernel_shapes(x, "fused_stem_grad")
    if route is None:
        _, route = _stem_kernel(x, w1, b1, w2, b2, valid_hw, with_route=True)
    w1k = w1.detach().permute(2, 3, 1, 0).contiguous()
    # data-gradient weights: w2 flipped in both spatial axes, ci ↔ co
    w2f = w2.detach().flip(2, 3).permute(2, 3, 0, 1).contiguous()
    b1 = b1.detach()
    what = "fused_stem_grad"
    _check(x, "x", (B, H, W, 3), what)
    _check(dy, "dy", (B, H // 2, W // 2, 64), what)
    _check(route, "route", (B, H // 2, W // 2, 64), what, torch.uint8)
    _check(w1k, "w1", (3, 3, 3, 64), what)
    _check(b1, "b1", (64,), what)
    _check(w2f, "w2", (3, 3, 64, 64), what)
    vh, vw = _valid(H, W, valid_hw)
    lib = STEM_GRAD.load()
    s = _grad_scratch(B, H, W, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    STEM_GRAD.check(lib.shf_stem_grad(
        x.data_ptr(), dy.data_ptr(), route.data_ptr(), w1k.data_ptr(),
        b1.data_ptr(), w2f.data_ptr(), s["w2f_split"].data_ptr(),
        s["c1"].data_ptr(), s["dpre2"].data_ptr(), s["dpre1"].data_ptr(),
        s["partial"].data_ptr(), s["out"].data_ptr(),
        B, H, W, vh, vw, s["n_chunk"], s["chunk_len"], stream), what)
    out = s["out"]
    dw2 = out[:9].reshape(3, 3, 64, 64).permute(3, 2, 0, 1).contiguous()
    dw1 = out[9, :27].reshape(3, 3, 3, 64).permute(3, 2, 0, 1).contiguous()
    return (dw1, out[9, 27].clone(), dw2, out[9, 28].clone()), s


def fused_stem_grad(x, dy, w1, b1, w2, b2, valid_hw=None, route=None):
    """(dw1, db1, dw2, db2), OIHW like the weights: the stem's weight
    gradients given dy (B, H/2, W/2, 64) NHWC. On a CPU tensor this is
    ``fused_stem_grad_reference`` (``route`` is not read). On a CUDA tensor
    it launches K2 on the current stream or raises, routing dy by
    ``route``, K1's routing of the same inputs (``StemFunction`` passes the
    one its forward wrote); without it, K1 is launched first to write one,
    and that launch counts in ``fused_stem.launches``. The result is the
    same to the bit from run to run: K2 sums across blocks in a fixed
    order."""
    if x.device.type != "cuda":
        return fused_stem_grad_reference(x, dy, w1, b1, w2, b2, valid_hw)
    grads, _ = _stem_grad_launch(x, dy, w1, b1, w2, b2, valid_hw, route)
    fused_stem_grad.launches += 1
    return grads


fused_stem_grad.launches = 0
