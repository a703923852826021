"""Weights between the JAX package's layout and the port's.

Counterpart of ``smallhardface_tpu/io/checkpoint.load_params`` (and of the
name mapping at ``io/caffemodel.py:148-185``, whose ``.caffemodel``
loading waits: ROADMAP queue 1, '.caffemodel loading'). Both packages
address parameters by the names of ``detector.param_shapes``; the JAX package stores conv weights
HWIO, the port OIHW. ``conv5_256_up`` is (4, 4, 1, C) in HWIO and
(C, 1, 4, 4) here, the grouped-deconv layout: the same transpose.
"""

from __future__ import annotations

import numpy as np
import torch

from smallhardface_tpu.io import checkpoint

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


def load_params(path):
    """Weights of a JAX-package ``.npz`` checkpoint (io/checkpoint.save), as
    the port's tensors."""
    params, _, _, _ = checkpoint.load(path)
    return params_from_numpy(params)
