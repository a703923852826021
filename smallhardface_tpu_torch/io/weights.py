"""Weights between the JAX package's layout and the port's.

Counterpart of ``smallhardface_tpu/io/checkpoint.load_params``
(``.caffemodel`` files: ``io/caffemodel.py``). Both packages address
parameters by the names of ``detector.param_shapes``; the JAX package
stores conv weights HWIO, the port OIHW. ``conv5_256_up`` is (4, 4, 1, C) in HWIO and
(C, 1, 4, 4) here, the grouped-deconv layout: the same transpose.

``qstate_from_numpy`` / ``qstate_to_numpy`` carry the int8 mode's
calibrated state (``models/detector.make_qstate``) across: the JAX
package's int8 weights are HWIO, the port's (O, 3, 3, C), the layout the
int8 kernel reads.
"""

from __future__ import annotations

import numpy as np
import torch

from smallhardface_tpu_torch.io import checkpoint

_HWIO_TO_OIHW = (3, 2, 0, 1)
_OIHW_TO_HWIO = (2, 3, 1, 0)


def params_from_numpy(tree):
    """{name: {'w': HWIO, 'b': (O,)}} numpy arrays → the same tree of
    float32 CPU tensors with conv weights OIHW."""
    out = {}
    for name, leaf in tree.items():
        out[name] = {}
        for k, v in leaf.items():
            a = np.array(v, dtype=np.float32)     # a writable copy
            if a.ndim == 4:
                a = a.transpose(_HWIO_TO_OIHW)
            out[name][k] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def params_to_numpy(params):
    """Inverse of ``params_from_numpy``: tensors (OIHW) → numpy (HWIO)."""
    out = {}
    for name, leaf in params.items():
        out[name] = {}
        for k, v in leaf.items():
            a = v.detach().cpu().numpy()
            if a.ndim == 4:
                a = a.transpose(_OIHW_TO_HWIO)
            out[name][k] = np.ascontiguousarray(a)
    return out


_HWIO_TO_OHWI = (3, 0, 1, 2)
_OHWI_TO_HWIO = (1, 2, 3, 0)


def qstate_from_numpy(qstate, device=None):
    """A JAX qstate ({'scales': {name: float32}, 'qw': {name: int8 HWIO},
    's_w': {name: float32 (O,)}}, numpy or JAX arrays) → the port's: the
    scales as float32 values in Python numbers, qw (O, 3, 3, C) int8 and
    s_w float32 tensors on ``device`` (the CPU when None)."""
    return {
        "scales": {n: float(np.float32(v))
                   for n, v in qstate["scales"].items()},
        "qw": {n: torch.from_numpy(np.ascontiguousarray(
            np.asarray(v, np.int8).transpose(_HWIO_TO_OHWI))).to(device)
            for n, v in qstate["qw"].items()},
        "s_w": {n: torch.from_numpy(np.array(v, np.float32)).to(device)
                for n, v in qstate["s_w"].items()}}


def qstate_to_numpy(qstate):
    """Inverse of ``qstate_from_numpy``: numpy float32 scales, int8 HWIO
    weights and float32 s_w, the JAX package's layout."""
    return {
        "scales": {n: np.float32(v) for n, v in qstate["scales"].items()},
        "qw": {n: np.ascontiguousarray(
            v.cpu().numpy().transpose(_OHWI_TO_HWIO))
            for n, v in qstate["qw"].items()},
        "s_w": {n: v.cpu().numpy() for n, v in qstate["s_w"].items()}}


def load_params(path):
    """Weights of an ``.npz`` checkpoint written by either package
    (``io/checkpoint.save``), as the port's tensors."""
    params, _, _, _ = checkpoint.load(path)
    return params_from_numpy(params)
