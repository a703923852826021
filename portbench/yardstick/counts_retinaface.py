"""Operations and bytes of RetinaFace-R50's forward, from the shapes the
harness sent: each convolution counts 2·H·W·Cin·Cout·k² on its output map
of the level's valid extent (ceil(h / s) × ceil(w / s) at output stride s,
the map the image has when run at its own size, not the ×32 bucket); its
input read once, its output written once, its weights and bias read once,
fp32, at the fp32 contract's peak. Pools, adds and the upsample count no
operations. The work is counted once, whatever route computes it.

From ``smallhardface_tpu_torch/models/retinaface.py`` :73-118
(``conv_table``), frozen: Pytorch_Retinaface's cfg_re50 widths.
"""

from __future__ import annotations

import math

from portbench.yardstick import peaks

# (planes, bottlenecks, stride) of ResNet-50's layer1-layer4
RESNET50 = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))
STEPS = (8, 16, 32)
OUT = 256
# the heads' outputs a position: 2 anchors × (2 classes, 4, 10)
HEADS = (("ClassHead", 4), ("BboxHead", 8), ("LandmarkHead", 20))


def convs():
    """(name, cin, cout, k, stride, output stride) of every convolution."""
    rows = [("body.conv1", 3, 64, 7, 2, 2)]
    cin, s = 64, 4
    for li, (planes, blocks, stride) in enumerate(RESNET50, 1):
        for i in range(blocks):
            st = stride if i == 0 else 1
            p = f"body.layer{li}.{i}"
            rows += [(f"{p}.conv1", cin, planes, 1, 1, s),
                     (f"{p}.conv2", planes, planes, 3, st, s * st),
                     (f"{p}.conv3", planes, 4 * planes, 1, 1, s * st)]
            if i == 0:
                rows.append((f"{p}.downsample", cin, 4 * planes, 1, st,
                             s * st))
            cin, s = 4 * planes, s * st
    for k, (c, st) in enumerate(zip((512, 1024, 2048), STEPS), 1):
        rows.append((f"fpn.output{k}", c, OUT, 1, 1, st))
    rows += [("fpn.merge2", OUT, OUT, 3, 1, 16),
             ("fpn.merge1", OUT, OUT, 3, 1, 8)]
    for k, st in enumerate(STEPS, 1):
        rows += [(f"ssh{k}.conv3X3", OUT, OUT // 2, 3, 1, st),
                 (f"ssh{k}.conv5X5_1", OUT, OUT // 4, 3, 1, st),
                 (f"ssh{k}.conv5X5_2", OUT // 4, OUT // 4, 3, 1, st),
                 (f"ssh{k}.conv7X7_2", OUT // 4, OUT // 4, 3, 1, st),
                 (f"ssh{k}.conv7x7_3", OUT // 4, OUT // 4, 3, 1, st)]
    for head, cout in HEADS:
        for k, st in enumerate(STEPS):
            rows.append((f"{head}.{k}", OUT, cout, 1, 1, st))
    return rows


def forward(h, w, items):
    """Per convolution of one forward launch over ``items`` inputs of
    valid extent (h, w): [{"name", "ops", "bytes", "peak", "q1"}]."""
    rows = []
    for name, ci, co, k, stride, s in convs():
        ho, wo = math.ceil(h / s), math.ceil(w / s)
        hi, wi = math.ceil(h * stride / s), math.ceil(w * stride / s)
        ops = 2.0 * items * ho * wo * ci * co * k * k
        nbytes = (4 * items * (hi * wi * ci + ho * wo * co)
                  + 4 * (co * ci * k * k + co))
        rows.append({"name": name, "ops": ops, "bytes": nbytes,
                     "peak": peaks.PEAK_FP32_CONTRACT, "q1": False})
    return rows
