"""RetinaFace weights in Pytorch_Retinaface's state-dict layout.

``Resnet50_Final.pth`` of github.com/biubug6/Pytorch_Retinaface is the
``state_dict()`` of its ``RetinaFace`` module: "body.*" (torchvision's
ResNet-50 behind an ``IntermediateLayerGetter``), "fpn.*", "ssh<k>.*",
"ClassHead.<k>.conv1x1.*", "BboxHead.*", "LandmarkHead.*", saved from a
``DataParallel`` with every key prefixed "module.". Its ``load_model``
strips that prefix (``remove_prefix``) and reads a "state_dict" entry
where there is one; so does ``load_state_dict`` here. Each batch norm is
folded into the convolution before it, in float64: w·γ/sqrt(var + eps)
and β − mean·γ/sqrt(var + eps). The result is the parameter tree of
``models/retinaface.py``, which the port's ``.npz`` checkpoints
(``io/checkpoint.py``, ``io/weights.py``) save and load like any other.
"""

from __future__ import annotations

import torch

from smallhardface_tpu_torch.models import retinaface

PREFIX = "module."


def strip_prefix(state_dict, prefix=PREFIX):
    """Pytorch_Retinaface's ``remove_prefix``: each key that starts with
    ``prefix`` without it."""
    return {k[len(prefix):] if k.startswith(prefix) else k: v
            for k, v in state_dict.items()}


def fold(state_dict, eps=retinaface.BN_EPS):
    """The port's parameters ({name: {'w', 'b'}} float32 CPU tensors) from
    a Pytorch_Retinaface state dict without the "module." prefix, each
    batch norm folded into its convolution. Raises KeyError naming the
    first key that is missing."""
    params = {}
    for name, bn, _, _, _, _, _ in retinaface.conv_table():
        w = state_dict[f"{name}.weight"].detach().cpu().double()
        if bn is None:
            b = state_dict[f"{name}.bias"].detach().cpu().double()
        else:
            gamma, beta, mean, var = (
                state_dict[f"{bn}.{k}"].detach().cpu().double()
                for k in ("weight", "bias", "running_mean", "running_var"))
            scale = gamma / torch.sqrt(var + eps)
            w = w * scale[:, None, None, None]
            b = beta - mean * scale
        params[name] = {"w": w.float().contiguous(), "b": b.float()}
    return params


def load_state_dict(state_dict):
    """``fold`` of a state dict as Pytorch_Retinaface's ``load_model``
    reads one: its "state_dict" entry where there is one, the "module."
    prefix stripped."""
    if "state_dict" in state_dict:
        state_dict = state_dict["state_dict"]
    return fold(strip_prefix(state_dict))


def load_pth(path):
    """The port's parameters from a Pytorch_Retinaface ``.pth`` file
    (tensors only; nothing of the file is executed)."""
    return load_state_dict(torch.load(path, map_location="cpu",
                                      weights_only=True))
