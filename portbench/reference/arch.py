"""The detector's architecture as data: VGG-16, the FPN-lite fusion and the
shared dilated heads of the smallhardface paper.

Frozen copy of ``smallhardface_tpu_torch/models/detector.py`` :41-183
(``VGG_STAGES``, ``ModelSpec``'s widths, ``param_shapes`` in the port's
OIHW layout, ``param_multipliers``) and :600-623 (``int8_layer_names``,
``_qsucc``). Only the flagship spec (``MODEL.DIFFERENT_DILATION``) is
kept. ``stages`` is an argument everywhere so that the CPU tests can run
the skeletal backbone.
"""

from __future__ import annotations

VGG16 = (("conv1", 64, 2), ("conv2", 128, 2), ("conv3", 256, 3),
         ("conv4", 512, 3), ("conv5", 512, 3))
ANCHOR_SCALES = (1, 2, 4)
HEAD_DILATIONS = (1, 2, 4)
FEAT_STRIDE = 8
LATERAL, FUSE, DIM_RED, HEAD, NUM_CLASSES = 256, 512, 128, 128, 2
BACKBONE_MULT, HEAD_MULT = 2.0, 1.0


def backbone(stages=VGG16):
    return [f"{s}_{i}" for s, _, n in stages for i in range(1, n + 1)]


def param_shapes(stages=VGG16):
    """{name: {'w': OIHW, 'b': (O,)}}; the fixed bilinear deconv
    'conv5_256_up' has only 'w' (C, 1, 4, 4)."""
    shapes, c = {}, 3
    for stage, o, n in stages:
        for i in range(1, n + 1):
            shapes[f"{stage}_{i}"] = {"w": (o, c, 3, 3), "b": (o,)}
            c = o
    out = {s: o for s, o, _ in stages}
    shapes["conv5_256"] = {"w": (LATERAL, out["conv5"], 1, 1), "b": (LATERAL,)}
    shapes["conv4_256"] = {"w": (LATERAL, out["conv4"], 1, 1), "b": (LATERAL,)}
    shapes["conv5_256_up"] = {"w": (LATERAL, 1, 4, 4)}
    shapes["conv4_fuse_final"] = {"w": (FUSE, 2 * LATERAL, 3, 3),
                                  "b": (FUSE,)}
    shapes["conv4_fuse_final_dim_red"] = {"w": (DIM_RED, FUSE, 3, 3),
                                          "b": (DIM_RED,)}
    shapes["head"] = {"w": (HEAD, DIM_RED, 3, 3), "b": (HEAD,)}
    for k in ANCHOR_SCALES:
        shapes[f"cls_score_{k}"] = {"w": (NUM_CLASSES, HEAD, 1, 1),
                                    "b": (NUM_CLASSES,)}
        shapes[f"bbox_pred_{k}"] = {"w": (4, HEAD, 1, 1), "b": (4,)}
    return shapes


def multipliers(stages=VGG16):
    """(lr_mult, decay_mult) per leaf: conv1_*, conv2_* and the deconv
    frozen; w (1, 1) and b (2, 1) elsewhere, the heads' biases without
    decay; × BACKBONE_MULT before the heads, × HEAD_MULT in them."""
    heads = {"head"} | {f"{p}_{k}" for p in ("cls_score", "bbox_pred")
                        for k in ANCHOR_SCALES}
    lr, decay = {}, {}
    for name, tree in param_shapes(stages).items():
        if name.startswith(("conv1_", "conv2_")) or name == "conv5_256_up":
            lr[name] = dict.fromkeys(tree, 0.0)
            decay[name] = dict.fromkeys(tree, 0.0)
            continue
        mult = HEAD_MULT if name in heads else BACKBONE_MULT
        lr[name] = {"w": mult, "b": 2.0 * mult}
        decay[name] = {"w": 1.0, "b": 0.0 if name in heads else 1.0}
    return lr, decay


def int8_layers(stages=VGG16):
    """The convs of the int8 serving mode: stages 2-5, the fusion convs
    and the shared head."""
    return [n for n in backbone(stages) if not n.startswith("conv1")] + [
        "conv4_fuse_final", "conv4_fuse_final_dim_red", "head"]


def int8_successor(stages=VGG16):
    """Each int8 conv → the conv whose input grid its output is
    requantized onto; absent (the last backbone conv, the head): the chain
    ends there in fp32."""
    chain = [n for n in backbone(stages) if not n.startswith("conv1")]
    succ = dict(zip(chain, chain[1:]))
    succ["conv4_fuse_final"] = "conv4_fuse_final_dim_red"
    succ["conv4_fuse_final_dim_red"] = "head"
    return succ
