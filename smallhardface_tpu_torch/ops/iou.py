"""Per-anchor max IoU and its argmax over the gt boxes of a training image.

Counterpart of ``smallhardface_tpu/ops/pallas_iou.py``: the TPU kernel
``_kernel`` (pallas_iou.py:34), reached through ``pallas_max_iou``, becomes
the CUDA C++ kernel ``csrc/iou.cu`` (K3) for Hopper (sm_90a). Each warp of
32 anchors skips the gt that cannot overlap the union box of its anchors,
pairs whose IoU is provably 0; its header says what bounds it on an H100,
what the design does about that, and why the result stays equal to the
plain version's to the bit. Unlike the Pallas kernel (G ≤ 512), it takes
any number of gt boxes, so ``train/targets.anchor_targets`` calls it for
every gt bucket.

- ``max_iou_reference``: the plain version, ``ops/bbox.max_iou_chunked``.
- ``max_iou``: the wrapper. On CPU tensors it is the plain version; on
  CUDA tensors it launches K3 on the current stream or raises, and never
  falls back. ``max_iou.launches`` counts the launches.
- ``IOU``: the kernel library, built with ``nvcc`` at first use without
  fused multiply-adds and with IEEE division, so that the kernel equals the
  plain version to the bit.
"""

from __future__ import annotations

import torch

from smallhardface_tpu_torch.ops.bbox import max_iou_chunked
from smallhardface_tpu_torch.ops.cuda_build import CI, VP, CudaLibrary

IOU = CudaLibrary("iou", "iou.cu", {"shf_max_iou": [VP] * 5 + [CI] * 2 + [VP]},
                  extra_flags=("-fmad=false", "-prec-div=true", "-ftz=false"))


def max_iou_reference(anchors, gt_boxes, gt_mask):
    """Plain version: (max IoU (N,) float32 clamped at 0, first argmax (N,)
    int32), masked gt at IoU −1."""
    return max_iou_chunked(anchors, gt_boxes, gt_mask)


def max_iou(anchors, gt_boxes, gt_mask):
    """anchors (N, 4) float32; gt_boxes (G, 4) float32; gt_mask (G,) bool.
    Returns (max_iou (N,) float32, argmax (N,) int32): for each anchor the
    largest IoU with an unmasked gt (+1 pixel convention), clamped at 0,
    and the first gt that reaches it (0 when no gt is unmasked)."""
    if anchors.device.type != "cuda":
        return max_iou_reference(anchors, gt_boxes, gt_mask)
    n, g = anchors.shape[0], gt_boxes.shape[0]
    for t, name, shape, dtype in ((anchors, "anchors", (n, 4), torch.float32),
                                  (gt_boxes, "gt_boxes", (g, 4),
                                   torch.float32),
                                  (gt_mask, "gt_mask", (g,), torch.bool)):
        if (t.device != anchors.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"max_iou: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {anchors.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    lib = IOU.load()
    best = torch.empty((n,), dtype=torch.float32, device=anchors.device)
    idx = torch.empty((n,), dtype=torch.int32, device=anchors.device)
    stream = torch.cuda.current_stream(anchors.device).cuda_stream
    IOU.check(lib.shf_max_iou(
        anchors.data_ptr(), gt_boxes.data_ptr(), gt_mask.data_ptr(),
        best.data_ptr(), idx.data_ptr(), n, g, stream), "max_iou")
    max_iou.launches += 1
    return best, idx


max_iou.launches = 0
