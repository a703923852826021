"""Process groups for data-parallel training and evaluation.

Counterpart of ``smallhardface_tpu/parallel/mesh.py``. The JAX package
drives one mesh of devices from one process and sums the gradients with
``psum`` over its ``data`` axis; the port runs one process per card, as
the reference did (one Caffe solver per GPU joined by an NCCL allreduce,
reference ``caffe/src/caffe/parallel.cpp:125-257``), launched by
``torchrun``:

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m smallhardface_tpu_torch --device cuda ...

``init_distributed`` reads the launcher's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``) and joins the process group: NCCL between cards, gloo on
the CPU. ``SHF_DIST_BACKEND=gloo`` lets ranks share a card (NCCL refuses
two ranks on one). Without a launcher it does nothing, and every helper
below acts as the one rank of a world of one.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from smallhardface_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

BACKEND_ENV = "SHF_DIST_BACKEND"


def _launched():
    """Whether a launcher set this process up as a rank: a world of more
    than one, or a world of one with a rendezvous address."""
    size = os.environ.get("WORLD_SIZE")
    if size is None:
        return False
    return int(size) > 1 or "MASTER_ADDR" in os.environ


def init_distributed(device=None, spatial=1):
    """Join the process group the launcher's environment describes and
    return this rank's device: ``cuda:LOCAL_RANK % device_count`` for a
    CUDA ``device`` (made current), the CPU otherwise. The backend is NCCL
    for a card and gloo for the CPU; ``SHF_DIST_BACKEND=gloo`` picks gloo
    on cards too. With NCCL, more ranks on a node than cards raises before
    any collective. With ``spatial`` = k > 1 each rank owns a spatial unit
    of k cards, [LOCAL_RANK·k, LOCAL_RANK·k + k) (``spatial.unit``): the
    rank's device is the unit's first card, and LOCAL_WORLD_SIZE·k above
    the cards raises before any collective, whatever the backend. Without
    a launcher, or when the group already exists, it only resolves
    ``device``."""
    dev = resolve_device(device)
    if not _launched() or active():
        return dev
    rank_, world_ = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank_))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_))
    backend = os.environ.get(BACKEND_ENV) or (
        "nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"{BACKEND_ENV}={backend!r}: use 'nccl' or 'gloo'")
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if spatial > 1 and local_world * spatial > cards:
            raise RuntimeError(
                f"{local_world} ranks on this node with TPU.SPATIAL_DEVICES="
                f"{spatial} need {local_world * spatial} CUDA devices, there "
                f"are {cards}: each rank trains or evaluates over a unit of "
                f"its own {spatial} cards")
        if backend == "nccl" and local_world > cards:
            raise RuntimeError(
                f"{local_world} ranks on this node but {cards} CUDA "
                f"device(s): NCCL takes one card per rank; set "
                f"{BACKEND_ENV}=gloo to let ranks share a card")
        dev = torch.device("cuda", (local_rank * max(spatial, 1)) % cards)
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError(f"{BACKEND_ENV}=nccl needs a CUDA device; the CPU "
                         "takes gloo")
    dist.init_process_group(backend, init_method="env://", rank=rank_,
                            world_size=world_)
    logger.info("rank %d of %d on %s, backend %s", rank_, world_, dev,
                dist.get_backend())
    return dev


def active():
    """Whether this process is a rank of a process group."""
    return dist.is_available() and dist.is_initialized()


def world():
    return dist.get_world_size() if active() else 1


def rank():
    return dist.get_rank() if active() else 0


def local_rank():
    """This rank's index on its node (the launcher's LOCAL_RANK), 0 without
    a process group."""
    if not active():
        return 0
    return int(os.environ.get("LOCAL_RANK", rank()))


def backend():
    """The process group's backend ("nccl" or "gloo"), None without one."""
    return dist.get_backend() if active() else None


def shutdown():
    """Leave the process group, if there is one."""
    if active():
        dist.destroy_process_group()


def _collective_device():
    return (torch.device("cuda", torch.cuda.current_device())
            if backend() == "nccl" else torch.device("cpu"))


def allgather_max(values):
    """The element-wise maximum over the ranks of an int64 vector."""
    values = np.asarray(values, np.int64)
    if not active():
        return values
    mine = torch.from_numpy(values).to(_collective_device())
    parts = [torch.empty_like(mine) for _ in range(world())]
    dist.all_gather(parts, mine)
    return torch.stack(parts).amax(0).cpu().numpy()


def allgather_object(obj):
    """Every rank's ``obj`` (picklable), in rank order."""
    if not active():
        return [obj]
    out = [None] * world()
    dist.all_gather_object(out, obj)
    return out


def broadcast_object(obj, src=0):
    """Rank ``src``'s ``obj`` on every rank."""
    if not active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def barrier():
    if active():
        dist.barrier()


def allreduce_sum_(tensors):
    """Sum each tensor over the ranks, in place, as one collective: the
    tensors (one dtype, one device) are packed into one flat buffer, as
    JAX's single ``psum`` over the whole tree, then unpacked. Returns the
    bytes reduced (0 without a process group)."""
    if not active() or not tensors:
        return 0
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n
    return flat.numel() * flat.element_size()
