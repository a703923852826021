"""Device faults worth a relaunch, and the injected one of the tests.

A sticky CUDA error (an illegal address, a device-side assert, an ECC
error, an Xid) leaves the process's CUDA context unusable: every later
CUDA call fails with the same error, so only a new process recovers
(``__main__``'s ``TRAIN.AUTO_RESUME`` relaunch). ``device_fault`` tells
such an error from everything else, as ``train_test._device_fault`` does
for the TPU runtime's errors.
"""

from __future__ import annotations

import torch

from smallhardface_tpu_torch.ops.cuda_build import LAUNCH_FAILED

# cudaGetErrorString of the errors that leave the context unusable
STICKY_CUDA_ERRORS = (
    "an illegal memory access was encountered",
    "unspecified launch failure",
    "device-side assert triggered",
    "uncorrectable ECC error",
    "misaligned address",
    "an illegal instruction was encountered",
    "hardware stack error",
)
# what cuBLAS and cuDNN report for their calls after such an error, as
# plain RuntimeErrors
EXECUTION_FAILED = ("CUBLAS_STATUS_EXECUTION_FAILED",
                    "CUDNN_STATUS_EXECUTION_FAILED")


def device_fault(exc):
    """True for a sticky CUDA error: a ``torch.AcceleratorError``, or an
    error of the port's kernel launches (``ops/cuda_build.check``), with
    one of STICKY_CUDA_ERRORS in its message; or cuBLAS's or cuDNN's
    execution failure. Running out of memory, a non-sticky CUDA error and
    every other exception are not."""
    if not isinstance(exc, RuntimeError):
        return False
    msg = str(exc)
    if any(s in msg for s in EXECUTION_FAILED):
        return True
    return any(s in msg for s in STICKY_CUDA_ERRORS) and (
        isinstance(exc, torch.AcceleratorError) or LAUNCH_FAILED in msg)


def injected_fault(var):
    """The sticky fault that the environment variable ``var`` injects
    (``SHF_FAULT_ITER`` in training, ``SHF_FAULT_TEST`` in evaluation)."""
    return torch.AcceleratorError(
        f"CUDA error: an illegal memory access was encountered (injected "
        f"device fault, {var})")
