"""Model-graph visualization — the caffe.draw analog used by the reference
to render prototxt nets to JPEG (lib/prototxt/manipulate.py:47,59). Emits
graphviz DOT (and renders it if `dot` is on PATH) from the declarative
ModelSpec.

Counterpart of ``smallhardface_tpu/tools/draw_net.py``: ``spec_to_dot``
reads the port's ``VGG_STAGES``, ``ANCHOR_SCALES``, ``HEAD_DILATIONS`` and
``ModelSpec`` and gives the JAX tool's DOT text character for character.

Usage: python -m smallhardface_tpu_torch.tools.draw_net [--out net.dot]
           [--single-head]
"""

from __future__ import annotations

import argparse
import shutil
import subprocess


def spec_to_dot(spec):
    from smallhardface_tpu_torch.models.detector import (
        VGG_STAGES, ANCHOR_SCALES, HEAD_DILATIONS)

    lines = ["digraph face {", "  rankdir=LR;",
             '  node [shape=box, style=rounded];',
             '  data [shape=oval];']
    prev = "data"
    for stage, out_c, n in VGG_STAGES:
        for i in range(1, n + 1):
            name = f"{stage}_{i}"
            lines.append(f'  {name} [label="{name}\\n3x3/{out_c} +ReLU"];')
            lines.append(f"  {prev} -> {name};")
            prev = name
        if stage != "conv5":
            pool = f"pool{stage[-1]}"
            lines.append(f'  {pool} [label="{pool}\\nmax 2x2/2"];')
            lines.append(f"  {prev} -> {pool};")
            prev = pool
    lines += [
        '  conv5_256 [label="conv5_256\\n1x1/256 +ReLU"];',
        "  conv5_3 -> conv5_256;",
        '  conv5_256_up [label="conv5_256_up\\nbilinear deconv 4x4/2 '
        '(fixed)"];',
        "  conv5_256 -> conv5_256_up;",
        '  conv4_256 [label="conv4_256\\n1x1/256 +ReLU"];',
        "  conv4_3 -> conv4_256;",
        '  conv4_fuse [label="conv4_fuse\\nconcat"];',
        "  conv5_256_up -> conv4_fuse; conv4_256 -> conv4_fuse;",
        '  conv4_fuse_final [label="conv4_fuse_final\\n3x3/512 +ReLU"];',
        "  conv4_fuse -> conv4_fuse_final;",
    ]
    head_src = "conv4_fuse_final"
    if spec.different_dilation:
        lines.append('  dim_red [label="conv4_fuse_final_dim_red\\n'
                     '3x3/128 +ReLU"];')
        lines.append("  conv4_fuse_final -> dim_red;")
        head_src = "dim_red"
        for k, d in zip(ANCHOR_SCALES, HEAD_DILATIONS):
            h = f"head_{k}"
            lines.append(f'  {h} [label="{h}\\n3x3/128 dil={d}\\n'
                         '(shared weights)"];')
            lines.append(f"  {head_src} -> {h};")
            lines.append(f'  cls_{k} [label="cls_score_{k}\\n1x1/2"];')
            lines.append(f'  box_{k} [label="bbox_pred_{k}\\n1x1/4"];')
            lines.append(f"  {h} -> cls_{k}; {h} -> box_{k};")
            lines.append(f"  cls_{k} -> proposal; box_{k} -> proposal;")
    else:
        lines.append('  head [label="head\\n3x3/128"];')
        lines.append(f"  {head_src} -> head;")
        lines.append('  cls [label="cls_score\\n1x1/6"];')
        lines.append('  box [label="bbox_pred\\n1x1/12"];')
        lines.append("  head -> cls; head -> box;")
        lines.append("  cls -> proposal; box -> proposal;")
    lines.append('  proposal [label="proposal decode\\n(on-device)", '
                 'shape=oval];')
    lines.append("}")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="net.dot")
    p.add_argument("--single-head", action="store_true")
    args = p.parse_args(argv)

    from smallhardface_tpu_torch.models.detector import ModelSpec
    spec = ModelSpec(different_dilation=not args.single_head)
    dot = spec_to_dot(spec)
    with open(args.out, "w") as f:
        f.write(dot)
    print(f"wrote {args.out}")
    if shutil.which("dot") and args.out.endswith(".dot"):
        png = args.out[:-4] + ".png"
        subprocess.run(["dot", "-Tpng", args.out, "-o", png], check=False)
        print(f"rendered {png}")


if __name__ == "__main__":
    main()
