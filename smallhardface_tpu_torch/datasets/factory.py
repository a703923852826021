"""Dataset factory (reference lib/datasets/factory.py).
The port's copy of ``smallhardface_tpu/datasets/factory.py``."""

from __future__ import annotations

from smallhardface_tpu_torch.datasets.wider import wider
from smallhardface_tpu_torch.datasets.fddb import fddb
from smallhardface_tpu_torch.datasets.general import general
from smallhardface_tpu_torch.datasets.pascalface import pascalface
from smallhardface_tpu_torch.datasets.afw import afw

__sets = {}

for _split in ["train", "val", "test"]:
    __sets[f"wider_{_split}"] = (lambda split=_split: wider(split))
for _split in ["val"]:
    __sets[f"fddb_{_split}"] = (lambda split=_split: fddb(split))
for _split in ["png", "jpg"]:
    __sets[f"general_{_split}"] = (lambda split=_split: general(split))
for _split in ["val"]:
    __sets[f"pascalface_{_split}"] = (lambda split=_split: pascalface(split))
for _split in ["val"]:
    __sets[f"afw_{_split}"] = (lambda split=_split: afw(split))


def get_imdb(name, path=None):
    """Get an image database by name."""
    if name not in __sets:
        raise KeyError(f"Unknown dataset: {name}")
    return __sets[name]()
