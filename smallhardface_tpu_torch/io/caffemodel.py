"""Caffe ``.caffemodel`` weights in and out of the port's parameter tree.

Counterpart of ``smallhardface_tpu/io/caffemodel.py``: ``read_caffemodel``
(:70), ``write_caffemodel`` (:87), ``export_params`` (:109) and
``load_into_params`` (:138) with its name mapping (:148-185). Schema
subset of the reference Caffe fork's ``caffe.proto``:

  NetParameter: name=1 (string), layer=100 (LayerParameter, new format),
                layers=2 (V1LayerParameter, legacy: the public VGG-16
                ImageNet caffemodel uses it).
  LayerParameter:   name=1, type=2 (string), blobs=7
  V1LayerParameter: name=4, type=5 (enum),   blobs=6
  BlobProto: shape=7 (BlobShape{dim=1 packed int64}), data=5 (float),
             legacy dims num=1 channels=2 height=3 width=4

Caffe stores conv blobs OIHW, the port's own layout, so weights cross
without a transpose; the grouped bilinear deconv ``conv5_256_up`` is a
(C, 1, kh, kw) blob, also the port's layout. The shared dilated-head
weights appear once per head layer (``head_1``, ``head_2``, ``head_4``:
Caffe's named-param sharing writes each layer's view); the loader takes
the first of them in the file for the structural ``head`` parameter.

``write_caffemodel`` writes the same bytes as the JAX package's writer:
a new-format NetParameter named "face", the layers in the order given
(``export_params`` gives them in sorted name order, the order of a JAX
parameter tree), each blob's shape then its packed little-endian floats.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from smallhardface_tpu_torch.io import protowire as pw

logger = logging.getLogger(__name__)


def _parse_blob(raw: bytes) -> np.ndarray:
    shape = None
    legacy = {}
    data = []
    for field, wt, val in pw.iter_fields(raw):
        if field == 7 and wt == pw.WIRE_LEN:      # BlobShape
            dims = []
            for f2, wt2, v2 in pw.iter_fields(val):
                if f2 == 1:
                    if wt2 == pw.WIRE_LEN:
                        dims.extend(pw.parse_packed_varints(v2))
                    else:
                        dims.append(v2)
            shape = tuple(dims)
        elif field == 5:                           # data (float)
            # packed (one run) or unpacked (one fixed32 per value)
            data.append(np.frombuffer(val, "<f4"))
        elif field in (1, 2, 3, 4) and wt == pw.WIRE_VARINT:
            legacy[field] = val
    arr = (np.concatenate(data) if data else np.zeros(0)).astype(np.float32)
    if shape is None and legacy:
        shape = tuple(legacy.get(k, 1) for k in (1, 2, 3, 4))
    if shape is not None:
        arr = arr.reshape(shape)
    return arr


def _parse_layer(raw: bytes, name_field: int, blobs_field: int):
    name = None
    blobs = []
    for field, wt, val in pw.iter_fields(raw):
        if field == name_field and wt == pw.WIRE_LEN:
            name = val.decode("utf-8")
        elif field == blobs_field and wt == pw.WIRE_LEN:
            blobs.append(_parse_blob(val))
    return name, blobs


def read_caffemodel(path):
    """Parse a .caffemodel into {layer_name: [np.ndarray float32 blobs]}
    (layers without blobs are left out)."""
    with open(path, "rb") as f:
        data = f.read()
    layers = {}
    for field, wt, val in pw.iter_fields(data):
        if field == 100 and wt == pw.WIRE_LEN:      # new-style layer
            name, blobs = _parse_layer(val, name_field=1, blobs_field=7)
        elif field == 2 and wt == pw.WIRE_LEN:      # legacy layers
            name, blobs = _parse_layer(val, name_field=4, blobs_field=6)
        else:
            continue
        if name and blobs:
            layers[name] = blobs
    return layers


def write_caffemodel(path, layers):
    """Serialize {layer_name: [blobs]} (numpy arrays or tensors) as a
    new-format binary NetParameter, in the given order."""
    out = bytearray()
    out += pw.emit_string(1, "face")
    for name, blobs in layers.items():
        layer = bytearray()
        layer += pw.emit_string(1, name)
        layer += pw.emit_string(2, "Convolution")
        for blob in blobs:
            if isinstance(blob, torch.Tensor):
                blob = blob.detach().cpu().numpy()
            blob = np.asarray(blob, dtype=np.float32)
            shape_payload = bytearray()
            for d in blob.shape:
                shape_payload += pw.emit_varint_field(1, int(d))
            body = pw.emit_len(7, bytes(shape_payload))
            body += pw.emit_len(5, blob.astype("<f4").tobytes())
            layer += pw.emit_len(7, body)
        out += pw.emit_len(100, bytes(layer))
    with open(path, "wb") as f:
        f.write(bytes(out))


def export_params(path, params):
    """Write the port's parameter tree ({name: {'w': OIHW, 'b'}} tensors)
    as a .caffemodel (inverse of ``load_into_params``), in sorted name
    order, the shared head once per dilation."""
    layers = {}
    for name in sorted(params):
        leaf = params[name]
        blobs = [leaf["w"]]
        if "b" in leaf:
            blobs.append(leaf["b"])
        if name == "head":
            for k in (1, 2, 4):
                layers[f"head_{k}"] = blobs
        else:
            layers[name] = blobs
    write_caffemodel(path, layers)


def load_into_params(path, params, strict=False, file_layers=None):
    """Name-addressed weight copy into an existing parameter tree
    ({name: {'w': OIHW, 'b'}} tensors), mirroring
    Net::CopyTrainedLayersFrom's silent layer-name matching in the
    reference Caffe fork.

    Returns a new tree: loaded leaves are float32 CPU tensors, unmatched
    model parameters keep their tensors, unmatched file layers are
    ignored (logged); a weight whose shape differs from the model's is
    skipped with a warning, or raises ValueError under ``strict``.
    ``file_layers``: a ``read_caffemodel(path)`` result, to skip parsing
    again."""
    if file_layers is None:
        file_layers = read_caffemodel(path)
    out = {k: dict(v) for k, v in params.items()}
    used = set()

    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def assign(pname, blobs):
        leaf = out[pname]
        w = blobs[0]
        if w.ndim != 4:
            raise ValueError(f"{pname}: expected a 4-D conv weight, got "
                             f"{w.shape}")
        if tuple(leaf["w"].shape) != w.shape:
            msg = (f"shape mismatch for {pname}: "
                   f"{tuple(leaf['w'].shape)} vs file {w.shape}")
            if strict:
                raise ValueError(msg)
            logger.warning(msg)
            return
        leaf["w"] = tensor(w)
        if len(blobs) > 1 and "b" in leaf:
            leaf["b"] = tensor(blobs[1].reshape(-1))

    for fname, blobs in file_layers.items():
        pname = fname
        if fname in ("head_1", "head_2", "head_4"):
            pname = "head"       # shared dilated-head weights
            if pname in used:
                continue
        if fname == "conv5_256_up":
            # the fixed bilinear kernel: Caffe stores (C, 1, kh, kw) groups
            if "conv5_256_up" in out:
                k = blobs[0]
                out["conv5_256_up"]["w"] = tensor(
                    k.reshape(k.shape[0], 1, k.shape[-2], k.shape[-1]))
            used.add("conv5_256_up")
            continue
        if pname not in out:
            logger.info("Ignoring file layer with no model param: %s", fname)
            continue
        assign(pname, blobs)
        used.add(pname)

    missing = [k for k in out if k not in used]
    if missing:
        logger.info("Params not found in %s (kept init): %s", path, missing)
    return out
