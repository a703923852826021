"""Fused VGG stem: conv1_1 + ReLU + conv1_2 + ReLU + 2×2/2 max pool.

Counterpart of ``smallhardface_tpu/ops/pallas_stem.py`` (forward only):
the TPU kernel ``_kernel`` (pallas_stem.py:69), reached through
``_stem_call`` / ``_stem_op`` / ``fused_stem``, becomes the CUDA C++ kernel
``csrc/stem.cu`` for Hopper (sm_90a). Its header says what bounds the stem
on an H100 and what the design does about it: the stem is bound by
device-memory traffic when written as separate passes (each conv writes
a full-resolution 64-channel fp32 tensor and the next pass reads it back;
the pooled output is 4× smaller), so the kernel keeps conv1_1 in shared
memory and conv1_2 in registers and writes only the pooled tile.

- ``fused_stem_reference``: the plain PyTorch version (two ``F.conv2d``,
  the masks, ``max_pool2d``). The CPU path and the kernel's oracle.
- ``fused_stem``: the wrapper. On a CPU tensor it takes the plain version;
  on a CUDA tensor it launches the kernel or raises. ``fused_stem.launches``
  counts kernel launches.
- ``build``: compiles the kernel with ``nvcc`` at first use into
  ``csrc/build/`` (keyed by a hash of the source) and loads it with ctypes,
  the idiom ``smallhardface_tpu/ops/native.py`` uses for host code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import shutil
import subprocess
import tempfile
import threading

import torch
import torch.nn.functional as F

from smallhardface_tpu_torch.models.layers import zero_outside

_CSRC = osp.abspath(osp.join(osp.dirname(__file__), "..", "csrc"))
_SRC = osp.join(_CSRC, "stem.cu")
_BUILD = osp.join(_CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
build_log = ""          # nvcc's output of the build this process ran


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 osp.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")):
        if cand and osp.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                       "the stem kernel is compiled from csrc/stem.cu at "
                       "first use")


def library_path():
    """The .so for the current source: csrc/build/stem_<sha256[:16]>.so."""
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return osp.join(_BUILD, f"stem_{h.hexdigest()[:16]}.so")


def build():
    """Compile (if this source was not built yet) and load the kernel
    library. Returns the ctypes handle. Safe to call repeatedly and from
    several processes: each builds to a temporary name and renames it."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not osp.exists(so):
            os.makedirs(_BUILD, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC],
                    capture_output=True, text=True, check=False)
                build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}):\n{build_log}")
                os.replace(tmp, so)
            finally:
                if osp.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(so)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.shf_stem_forward.argtypes = [vp] * 6 + [ci] * 5 + [vp]
        lib.shf_stem_forward.restype = ci
        lib.shf_cuda_error_string.argtypes = [ci]
        lib.shf_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def fused_stem_reference(x, w1, b1, w2, b2, valid_hw=None):
    """Plain PyTorch stem. x: NHWC (B, H, W, 3) fp32; w1 (64, 3, 3, 3) and
    w2 (64, 64, 3, 3) OIHW. With ``valid_hw=(vh, vw)`` the input and the
    conv1_1 activations are zero outside [0, vh) × [0, vw) before each conv
    reads them (pallas_stem.py:98-104, :120-123). Pooling keeps Caffe's
    ceil mode, so odd sizes work here. Returns NHWC (B, ⌈H/2⌉, ⌈W/2⌉, 64)."""
    h = x.permute(0, 3, 1, 2)
    if valid_hw is not None:
        h = zero_outside(h, *valid_hw)
    h = F.relu(F.conv2d(h, w1, b1, padding=1))
    if valid_hw is not None:
        h = zero_outside(h, *valid_hw)
    h = F.relu(F.conv2d(h, w2, b2, padding=1))
    h = F.max_pool2d(h, 2, 2, ceil_mode=True)
    return h.permute(0, 2, 3, 1).contiguous()


def _check(t, name, shape):
    if t.device.type != "cuda" or t.dtype != torch.float32:
        raise ValueError(f"fused_stem: {name} must be a CUDA float32 tensor, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_stem: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"fused_stem: {name} must be contiguous and "
                         "16-byte aligned")


def fused_stem(x, w1, b1, w2, b2, valid_hw=None):
    """relu(conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2) → 2×2/2 max pool,
    with exact valid-extent masking (see ``fused_stem_reference``).

    x: NHWC (B, H, W, 3) float32, contiguous; weights OIHW as the port
    keeps them. On a CPU tensor this is the plain version. On a CUDA
    tensor it launches the kernel on the current stream (H and W must be
    even) or raises; it never falls back. Returns NHWC (B, H/2, W/2, 64).
    """
    if x.device.type != "cuda":
        return fused_stem_reference(x, w1, b1, w2, b2, valid_hw)
    if x.dim() != 4 or x.shape[3] != 3:
        raise ValueError(f"fused_stem: x must be (B, H, W, 3), got "
                         f"{tuple(x.shape)}")
    B, H, W, _ = x.shape
    if H % 2 or W % 2:
        raise ValueError(f"fused_stem: the kernel needs even H and W, got "
                         f"{H}x{W}")
    # the kernel reads w1 as (27, 64) rows (dy, dx, ci) and w2 as 9 taps of
    # (ci, co): HWIO, the JAX package's layout
    w1k = w1.permute(2, 3, 1, 0).contiguous()
    w2k = w2.permute(2, 3, 1, 0).contiguous()
    _check(x, "x", (B, H, W, 3))
    _check(w1k, "w1", (3, 3, 3, 64))
    _check(b1, "b1", (64,))
    _check(w2k, "w2", (3, 3, 64, 64))
    _check(b2, "b2", (64,))
    vh, vw = (H, W) if valid_hw is None else (int(valid_hw[0]),
                                              int(valid_hw[1]))
    lib = build()
    out = torch.empty((B, H // 2, W // 2, 64), dtype=torch.float32,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.shf_stem_forward(
        x.data_ptr(), w1k.data_ptr(), b1.data_ptr(), w2k.data_ptr(),
        b2.data_ptr(), out.data_ptr(), B, H, W, vh, vw, stream)
    if err:
        raise RuntimeError("fused_stem: kernel launch failed: "
                           + lib.shf_cuda_error_string(err).decode())
    fused_stem.launches += 1
    return out


fused_stem.launches = 0
