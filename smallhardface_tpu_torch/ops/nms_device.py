"""The final vote of a detection on the device: greedy score-weighted box
voting (BBOX_VOTE) and greedy NMS over the top candidates of one image.

Counterpart of ``smallhardface_tpu/ops/nms_jax.py``: ``bbox_vote_device``
(nms_jax.py:70) and ``nms_device`` (:27), which the JAX package runs as XLA
loops with one step per cluster, become one CUDA C++ kernel for Hopper
(sm_90a), ``csrc/vote.cu`` (V1), with one C entry point each. Its header
says what bounds it on an H100 and what the design does about that: a
parallel membership bitmask (phase A), one warp per image walking the
clusters on bit operations alone (B), and the merged rows summed in
parallel in a fixed order (C), three launches behind one C call.

Both take the rows (V, 5) [x1, y1, x2, y2, score] sorted by descending
score, of which the first ``n_valid`` are candidates (``n_valid`` a 0-d
int32 tensor on the rows' device, so that nothing waits for the device),
and return (out (V, 5), n_out 0-d int32): the emitted rows first, zeros
after them. A batch of images, rows (B, V, 5) and ``n_valid`` (B,), gives
(out (B, V, 5), n_out (B,)), each image voted on its own as the JAX
functions under ``jax.vmap`` are (``_pyramid_program_batched``,
detect.py:586-604): one call of V1 on the card for the whole batch.
The semantics are the JAX functions', with the IoU's own float32
expression ``inter / (area[i] + area - inter)`` (+1 pixel convention):

- the head of each step is the lowest remaining index;
- vote: its cluster is the remaining rows with IoU >= thresh against it; a
  cluster of two or more emits the score-weighted mean box with the
  cluster's largest score; a single row is emitted only when nothing
  remains after it (the reference's mid-stream singleton drop);
- NMS: the head is emitted, and the remaining rows with IoU > thresh
  against it are dropped.

Where the JAX loop relies on a head's IoU with itself being 1, these
functions take the head into its own cluster outright, so that a step
always removes a row and the loop ends for any box.

- ``bbox_vote_device_reference`` / ``nms_device_reference``: the plain
  versions, a Python loop over clusters on float32 tensors (and over the
  images of a batch). They are the CPU path and the kernel's oracle;
  nothing on the card's path calls them.
- ``bbox_vote_device`` / ``nms_device``: the wrappers. On CPU tensors they
  are the plain versions; on CUDA tensors they launch V1 on the current
  stream or raise, and never fall back. ``.launches`` counts the calls
  of V1, one per wrapper call.
- ``VOTE``: the kernel library, built at first use without fused
  multiply-adds and with IEEE division, so that a cluster's membership is
  the plain version's to the bit.
"""

from __future__ import annotations

import ctypes

import torch

from smallhardface_tpu_torch.ops.cuda_build import CI, VP, CudaLibrary

# (dets, n_valid, B, V, thresh, out, n_out, stream)
_SIGNATURE = [VP, VP, CI, CI, ctypes.c_float, VP, VP, VP]
VOTE = CudaLibrary("vote", "vote.cu", {"shf_bbox_vote": _SIGNATURE,
                                       "shf_nms": _SIGNATURE},
                   extra_flags=("-fmad=false", "-prec-div=true",
                                "-ftz=false"))
# the walk keeps each image's remaining rows in one warp's registers
MAX_ROWS = 8192


def scratch_words(v):
    """32-bit words of V1's scratch per image (csrc/vote.cu
    ``scratch_words``): the V x ceil(V / 32) membership mask, then V
    emission records."""
    return v * ((v + 31) // 32) + v


def _iou_with(x1, y1, x2, y2, area, i):
    """IoU of every row with row i, in nms_jax.py's float32 expression."""
    w = (torch.minimum(x2[i], x2) - torch.maximum(x1[i], x1) + 1).clamp_min(0)
    h = (torch.minimum(y2[i], y2) - torch.maximum(y1[i], y1) + 1).clamp_min(0)
    inter = w * h
    return inter / (area[i] + area - inter)


def greedy_steps(dets, n_valid, thresh, vote):
    """The plain loop: (out, n_out, steps, pairs), where steps is the number
    of clusters (one head each) and pairs the IoUs the kernel computes, one
    per remaining row per step (the work this data needs)."""
    v = dets.shape[0]
    x1, y1, x2, y2, scores = dets.unbind(1)
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    idx = torch.arange(v, device=dets.device)
    remaining = idx < n_valid
    thresh = torch.tensor(thresh, dtype=torch.float32)
    out = torch.zeros_like(dets)
    cnt = steps = pairs = 0
    while bool(remaining.any()):
        i = int(torch.argmax(remaining.to(torch.uint8)))
        steps += 1
        pairs += int(remaining.sum())
        iou = _iou_with(x1, y1, x2, y2, area, i)
        member = (iou >= thresh) if vote else (iou > thresh)
        cluster = remaining & (member | (idx == i))
        remaining = remaining & ~cluster
        if not vote:
            out[cnt] = dets[i]
            cnt += 1
            continue
        csize = int(cluster.sum())
        if csize > 1:
            cw = torch.where(cluster, scores, 0.0)
            box = (dets[:, :4] * cw[:, None]).sum(0) / cw.sum()
            score = torch.where(cluster, scores, -torch.inf).max()
            out[cnt] = torch.cat([box, score[None]])
            cnt += 1
        elif not bool(remaining.any()):
            out[cnt] = dets[i]
            cnt += 1
    n_out = torch.tensor(cnt, dtype=torch.int32, device=dets.device)
    return out, n_out, steps, pairs


def _plain(dets, n_valid, thresh, vote):
    """The plain loop over one image, or over each image of a batch."""
    if dets.dim() == 2:
        return greedy_steps(dets, n_valid, thresh, vote)[:2]
    outs = [greedy_steps(d, n, thresh, vote)[:2]
            for d, n in zip(dets, n_valid)]
    return (torch.stack([o for o, _ in outs]),
            torch.stack([n for _, n in outs]))


def bbox_vote_device_reference(dets, n_valid, thresh):
    """Plain version of the vote: (out (V, 5), n_out) in float32, or
    (out (B, V, 5), n_out (B,)) for a batch."""
    return _plain(dets, n_valid, thresh, vote=True)


def nms_device_reference(dets, n_valid, thresh):
    """Plain version of NMS: the kept rows (V, 5) first, and their count
    (for a batch, per image)."""
    return _plain(dets, n_valid, thresh, vote=False)


def _launch(fn, entry, dets, n_valid, thresh):
    batched = dets.dim() == 3
    b, v = (dets.shape[0], dets.shape[1]) if batched else (1, dets.shape[0])
    if (dets.dtype != torch.float32 or dets.dim() not in (2, 3)
            or dets.shape[-1] != 5 or not dets.is_contiguous()
            or b == 0):
        raise ValueError(f"{fn.__name__}: dets must be a contiguous float32 "
                         f"(V, 5) or (B, V, 5) tensor, got {dets.dtype} "
                         f"{tuple(dets.shape)}")
    want = (b,) if batched else ()
    if (n_valid.device != dets.device or n_valid.dtype != torch.int32
            or tuple(n_valid.shape) != want or not n_valid.is_contiguous()):
        raise ValueError(f"{fn.__name__}: n_valid must be an int32 of shape "
                         f"{want} on {dets.device}, got {n_valid.dtype} "
                         f"{tuple(n_valid.shape)} on {n_valid.device}")
    if v > MAX_ROWS:
        raise ValueError(f"{fn.__name__}: {v} rows exceed the kernel's "
                         f"{MAX_ROWS} (lower TPU.VOTE_CAP)")
    lib = VOTE.load()
    # the kernel's scratch follows the rows of out in one allocation
    buf = torch.empty(b * (5 * v + scratch_words(v)), dtype=torch.float32,
                      device=dets.device)
    out = buf[:b * v * 5].view(dets.shape)
    n_out = torch.empty(want, dtype=torch.int32, device=dets.device)
    stream = torch.cuda.current_stream(dets.device).cuda_stream
    VOTE.check(getattr(lib, entry)(
        dets.data_ptr(), n_valid.data_ptr(), b, v, float(thresh),
        out.data_ptr(), n_out.data_ptr(), stream), fn.__name__)
    fn.launches += 1
    return out, n_out


def bbox_vote_device(dets, n_valid, thresh):
    """dets (V, 5) float32 sorted by descending score; n_valid 0-d int32
    (int on the CPU). Returns (out (V, 5), n_out 0-d int32): the voted rows
    in emission order, zeros beyond n_out. For a batch, dets (B, V, 5) and
    n_valid (B,) int32 give out (B, V, 5) and n_out (B,), each image voted
    alone; on the card one call of V1 (one count) for the batch."""
    if dets.device.type != "cuda":
        return bbox_vote_device_reference(dets, n_valid, thresh)
    return _launch(bbox_vote_device, "shf_bbox_vote", dets, n_valid, thresh)


def nms_device(dets, n_valid, thresh):
    """As ``bbox_vote_device``, for greedy NMS: the kept rows of dets in
    descending score order, zeros beyond n_out."""
    if dets.device.type != "cuda":
        return nms_device_reference(dets, n_valid, thresh)
    return _launch(nms_device, "shf_nms", dets, n_valid, thresh)


bbox_vote_device.launches = 0
nms_device.launches = 0
