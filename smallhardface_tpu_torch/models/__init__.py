"""The detection models, by ``MODEL.ARCH``. ``for_config`` gives the model's
module, which answers the same names for the inference driver, the CLI,
``test_runner`` and training: ``ARCH``, ``CONFIDENCE_THRESHOLD`` (its
detection cut), ``build(params, spec, device)`` (its forward, which also
answers ``level_extent`` and ``decode_level``), ``refuse(cfg, path,
spatial_devices=None)`` (raises for what it does not run: ``path``
"detect", "detect_many" or "train") and ``load_params(path, spec, seed)``.
"""

from __future__ import annotations

import importlib

# MODEL.ARCH → module of this package; imported when asked for, since
# ops.stem imports models.layers and models.detector imports ops.stem
MODELS = {"smallhardface": "detector", "retinaface_r50": "retinaface"}


def for_config(cfg):
    """The model module of ``cfg.MODEL.ARCH``; ValueError for another."""
    arch = str(cfg.MODEL.ARCH)
    if arch not in MODELS:
        raise ValueError(f"MODEL.ARCH={arch!r}: expected "
                         + " or ".join(repr(a) for a in MODELS))
    return importlib.import_module(f"{__name__}.{MODELS[arch]}")
