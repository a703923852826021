"""Operations and bytes that the inputs need, from the shapes the harness
sent: each convolution and deconvolution counts 2·H·W·Cin·Cout·k² (a
depthwise deconvolution Cin = 1), on each level's valid ×16 extent and
not on a padded bucket; each input byte is read once and each output byte
written once. The work is counted once, whatever route computes it.

From ``smallhardface_tpu_torch/models/detector.py`` :186-220
(``forward_flops``), changed: per layer, with its bytes and precision;
the stem (K1: conv1_1, conv1_2 and the pool) and the int8 convolutions
(Q1) also listed on their own; training's backward counted as below.
"""

from __future__ import annotations

from portbench.reference import arch
from portbench.yardstick import peaks


def _layers(hb, wb, stages):
    """(name, kind, H, W, Cin, Cout, k, dilation) of every layer of one
    forward at input (hb, wb); kind is "conv", "deconv" or "pool"."""
    out, c, s = [], 3, 1
    last = len(stages) - 1
    for si, (stage, o, n) in enumerate(stages):
        for i in range(1, n + 1):
            out.append((f"{stage}_{i}", "conv", hb // s, wb // s, c, o, 3, 1))
            c = o
        if si < last:
            out.append((f"pool{si + 1}", "pool", hb // s, wb // s, c, c, 2, 1))
            s *= 2
    h16, w16, h8, w8 = hb // 16, wb // 16, hb // 8, wb // 8
    c4 = dict((st, o) for st, o, _ in stages)["conv4"]
    out += [("conv5_256", "conv", h16, w16, c, arch.LATERAL, 1, 1),
            ("conv5_256_up", "deconv", h16, w16, 1, arch.LATERAL, 4, 1),
            ("conv4_256", "conv", h8, w8, c4, arch.LATERAL, 1, 1),
            ("conv4_fuse_final", "conv", h8, w8, 2 * arch.LATERAL,
             arch.FUSE, 3, 1),
            ("conv4_fuse_final_dim_red", "conv", h8, w8, arch.FUSE,
             arch.DIM_RED, 3, 1)]
    for k, d in zip(arch.ANCHOR_SCALES, arch.HEAD_DILATIONS):
        out += [(f"head@{d}", "conv", h8, w8, arch.DIM_RED, arch.HEAD, 3, d),
                (f"cls_score_{k}", "conv", h8, w8, arch.HEAD,
                 arch.NUM_CLASSES, 1, 1),
                (f"bbox_pred_{k}", "conv", h8, w8, arch.HEAD, 4, 1, 1)]
    return out


def forward(hb, wb, items, precision="float32", stages=arch.VGG16):
    """Per layer of one forward launch over ``items`` inputs of valid extent
    (hb, wb): [{"name", "ops", "bytes", "peak", "q1"}]. Under "int8" the
    quantized layers read and write their int8 carriers (fp32 where the
    chain ends) and are priced at the int8 peak; every other layer keeps
    the fp32 contract."""
    int8 = precision == "int8"
    q_layers = set(arch.int8_layers(stages)) if int8 else set()
    succ = arch.int8_successor(stages)
    rows = []
    for name, kind, H, W, ci, co, k, _ in _layers(hb, wb, stages):
        base = name.split("@")[0]
        # the int8 chain pools its int8 carriers; pool1 pools the fp32 stem
        quant = base in q_layers or (int8 and kind == "pool"
                                     and name != "pool1")
        if kind == "pool":
            esize = 1 if quant else 4
            ops = 0.0
            nbytes = items * (H * W * ci + (H // 2) * (W // 2) * ci) * esize
        else:
            if kind == "deconv":
                ops = 2.0 * items * H * W * co * k * k
                Ho, Wo = 2 * H, 2 * W
            else:
                ops = 2.0 * items * H * W * ci * co * k * k
                Ho, Wo = H, W
            in_b = 1 if quant else 4
            out_b = 1 if quant and base in succ else 4
            w_b = (1 if quant else 4) * co * ci * k * k + 4 * co
            nbytes = (items * (H * W * ci * in_b + Ho * Wo * co * out_b)
                      + w_b)
        rows.append({"name": name, "ops": ops, "bytes": nbytes,
                     "peak": peaks.PEAK_INT8 if quant
                     else peaks.PEAK_FP32_CONTRACT,
                     "q1": quant and kind == "conv"})
    return rows


def stem(hb, wb, items):
    """K1's work for one launch: conv1_1 (3 → 64), conv1_2 (64 → 64), ReLUs
    and the 2×2 pool on (hb, wb), fp32: the image read once, the pooled
    64 channels written once, the weights read once. (ops, bytes)."""
    ops = 2.0 * items * hb * wb * 9 * (3 * 64 + 64 * 64)
    nbytes = (items * (hb * wb * 3 + (hb // 2) * (wb // 2) * 64) * 4
              + 4 * (64 * 27 + 64 + 64 * 576 + 64))
    return ops, nbytes


def train_step(hb, wb, stages=arch.VGG16):
    """One micro-batch's forward and backward at valid extent (hb, wb),
    fp32: the forward; the data gradient of every convolution whose input
    depends on a trainable weight (autograd computes no other); the weight
    gradient of every trainable one. Returns (ops, bytes), the bytes as
    three passes over the forward's (the backward reads each activation
    and gradient once and writes one gradient per activation)."""
    lr, _ = arch.multipliers(stages)
    rows = _layers(hb, wb, stages)
    fwd = forward(hb, wb, 1, "float32", stages)
    ops = sum(r["ops"] for r in fwd)
    nbytes = sum(r["bytes"] for r in fwd)
    grad_flows = False
    for (name, kind, H, W, ci, co, k, _), r in zip(rows, fwd):
        base = name.split("@")[0]
        trainable = lr.get(base, {}).get("w", 0.0) > 0
        if kind == "pool":
            if grad_flows:
                nbytes += 2 * r["bytes"]
            continue
        if grad_flows:
            ops += r["ops"]                      # data gradient
            nbytes += r["bytes"]
        if trainable:
            ops += r["ops"]                      # weight gradient
            nbytes += r["bytes"]
            grad_flows = True
    return ops, nbytes
