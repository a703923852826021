"""Spatial H-sharding of detection: one image's rows split over a list of
devices in one process.

Counterpart of ``smallhardface_tpu/parallel/mesh.py:72-78``
``make_spatial_mesh`` in its single-process role: the JAX package runs
spatial detection as one controller over the local devices
(``TPUDetector(spatial_mesh=…)``, ``test_runner.run_inference``'s units of
k devices, the service's first k), and XLA's partitioner writes the halo
exchanges. Here the unit is a list of k devices, each shard a tensor on
its device, and a halo is a tensor copy (``halo``). Nothing here needs a
process group; data parallelism over spatial units stays one process per
unit (``parallel/dist``).

A list that repeats one device, such as ``[cuda:0, cuda:0]``, is allowed:
the shards then run one after another on that device. That is how one
card (or the CPU, in the tests) runs the sharded path, with its exactness
and halo routing, but no speed or memory scaling.

**Alignment.** An input of H rows over k > 1 shards is padded with zero
rows up to ``padded_height(H, k)``, a multiple of ALIGN·k = 32·k, and
shard i owns rows [i·Hs, (i + 1)·Hs), Hs = H_pad / k, a multiple of 32:

- every shard boundary is a multiple of 16, so each 2×2 pool (Caffe's ceil
  mode, strides 1 to 8) sees the windows one device sees;
- at stride 8 each shard holds Hs / 8 ≥ 4 rows, the widest halo (the head
  at dilation 4), and at stride 16 Hs / 16 ≥ 2 rows, conv5's and the
  upsample's one-row halo;
- the forward runs in the masked mode with the true extent as
  ``valid_hw``, so the padded rows read as exact zeros before every
  convolution, which is the one-device forward's zero padding (masking is
  a no-op inside the extent).

One shard (k = 1) takes no padding and no halo: that is the one-device
forward.
"""

from __future__ import annotations

import torch

# rows of a shard are a multiple of this (see the module docstring)
ALIGN = 32


def padded_height(h, k):
    """H rows padded for k shards: h itself for one shard, else h rounded up
    to a multiple of ALIGN·k."""
    if k <= 1:
        return h
    m = ALIGN * k
    return -(-h // m) * m


def split(x, devices, dim=1):
    """x cut along ``dim`` into len(devices) equal shards of consecutive
    rows, the i-th on devices[i] (the forward needs ``padded_height``
    rows; K4 alone takes any even shard of at least 8)."""
    k = len(devices)
    rows = x.shape[dim]
    if rows % k:
        raise ValueError(f"spatial.split: {rows} rows do not split into {k} "
                         "equal shards")
    hs = rows // k
    return [x.narrow(dim, i * hs, hs).to(dev).contiguous()
            for i, dev in enumerate(devices)]


def shard_input(x, devices, valid_hw=None):
    """An NHWC batch x (B, H, W, C) as the shards of ``split`` over
    ``devices``, zero rows added up to ``padded_height``, and the valid
    extent the forward must mask to: ``valid_hw``, or (H, W) when rows were
    added and none was given, else None."""
    B, H, W, _ = x.shape
    hp = padded_height(H, len(devices))
    if hp != H:
        x = torch.cat([x, x.new_zeros((B, hp - H) + tuple(x.shape[2:]))], 1)
        if valid_hw is None:
            valid_hw = (H, W)
    return split(x, devices), valid_hw


def halo(shards, rows, dim=2):
    """Each shard with ``rows`` rows (along ``dim``) of each neighbour: the
    last rows of the shard above, then its own, then the first rows of the
    shard below, copied to its device. At the image's top and bottom edges
    nothing is added: the convolution's own zero padding stands there.
    Returns [(tensor, (top, bottom))], the rows added above and below.
    Slicing, ``.to`` and ``torch.cat`` only, so autograd carries the
    transposed exchange. ``halo.bytes`` counts the bytes of the neighbour
    rows copied."""
    k = len(shards)
    out = []
    for i, s in enumerate(shards):
        parts = [s]
        top = bottom = 0
        if i > 0:
            above = shards[i - 1]
            if above.shape[dim] < rows:
                raise ValueError(f"spatial.halo: a shard of {above.shape[dim]}"
                                 f" rows cannot give {rows}")
            parts.insert(0, above.narrow(dim, above.shape[dim] - rows,
                                         rows).to(s.device))
            top = rows
        if i < k - 1:
            below = shards[i + 1]
            if below.shape[dim] < rows:
                raise ValueError(f"spatial.halo: a shard of {below.shape[dim]}"
                                 f" rows cannot give {rows}")
            parts.append(below.narrow(dim, 0, rows).to(s.device))
            bottom = rows
        for p in parts:
            if p is not s:
                halo.bytes += p.numel() * p.element_size()
        out.append((torch.cat(parts, dim) if len(parts) > 1 else s,
                    (top, bottom)))
    return out


halo.bytes = 0


def gather(shards, dim=1):
    """The shards concatenated along ``dim`` on the first shard's device
    (the shard itself when there is one)."""
    if len(shards) == 1:
        return shards[0]
    dev = shards[0].device
    return torch.cat([s.to(dev) for s in shards], dim)


def amax(values):
    """The elementwise maximum of one tensor per shard, on the first
    shard's device: what JAX's partitioner reduces over the whole sharded
    tensor (int8's dynamic step, the calibration's max|input|)."""
    dev = values[0].device
    out = values[0]
    for v in values[1:]:
        out = torch.maximum(out, v.to(dev))
    return out


def local_devices(device):
    """This process's devices of ``device``'s type: every visible CUDA card,
    or the one CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def first_devices(device, k):
    """The first k local devices of ``device``'s type, the service's unit
    (JAX serve.py:75-84); ValueError when there are fewer."""
    local = local_devices(device)
    if k > len(local):
        raise ValueError(f"TPU.SPATIAL_DEVICES={k} exceeds the {len(local)} "
                         "local devices")
    return local[:k]


def unit(device, k, index=0):
    """Spatial unit ``index`` of k local devices, [index·k, index·k + k),
    the evaluation's (JAX test_runner.py:178-193, one unit per process
    here); ValueError when k does not divide the local device count or the
    unit lies beyond it."""
    local = local_devices(device)
    if len(local) % k:
        raise ValueError(f"TPU.SPATIAL_DEVICES={k} must divide the local "
                         f"device count ({len(local)})")
    if (index + 1) * k > len(local):
        raise ValueError(
            f"TPU.SPATIAL_DEVICES={k}: spatial unit {index} needs local "
            f"devices {index * k}..{index * k + k - 1}, there are "
            f"{len(local)}")
    return local[index * k:(index + 1) * k]
