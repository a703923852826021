#!/usr/bin/env python3
"""The readings that the limits of ``reference/compare.py`` rest on, for
one cell, over many seeds in one process, on the card.

    python3 portbench/control.py --workload <cell> --seconds <s>
                                 --seeds <n> [<n> ...]

For each seed it runs the cell as ``run.py`` does, for ``--seconds``
(long enough to finish the sample that a run compares), and prints one
JSON line: the program's numbers against the reference (the lower
readings), the control's (the reference one precision lower in the
program's place: TF32 for an fp32 configuration, a 4-bit grid for an int8
one) and, for a training cell, the fault "half of the batch left out".
Each side is judged as a run is (``reference/compare.judge``, the same
names and limits): ``correct`` for the program, which should be true,
``control.correct`` and ``fault_half.correct``, which should be false.
The last line sums them up: the largest program reading and the smallest
control and fault readings of each number, and how many seeds each side
came out correct on.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import run  # noqa: E402
from portbench.reference import compare  # noqa: E402

SIDES = ("control", "fault_half")


def judged(readings):
    """{side: correct} for the program ("") and each control or fault
    side whose readings are there."""
    out = {"": compare.judge(readings)[0]}
    for side in SIDES:
        part = {k[len(side) + 1:]: v for k, v in readings.items()
                if k.startswith(side + ".")}
        if part:
            out[side] = compare.judge(part)[0]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    run.environment()
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    rows = []
    for seed in a.seeds:
        args = run.parse(["--workload", a.workload, "--seed", str(seed),
                          "--seconds", str(a.seconds), "--trace", "0"])
        res, _ = run.run_cell(args, dev, control=True)
        row = {"seed": seed, "correct": res["correct"],
               **{f"{side}.correct": ok for side, ok
                  in judged(res["readings"]).items() if side},
               **res["readings"],
               "metrics": {k: v["value"] for k, v in res["metrics"].items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    keys = sorted({k for r in rows for k in r
                   if k not in ("seed", "metrics")
                   and not k.endswith("correct")})
    summary = {k: sum(bool(r[k]) for r in rows if k in r)
               for k in sorted({k for r in rows for k in r
                                if k.endswith("correct")})}
    for k in keys:
        vals = [r[k] for r in rows if k in r]
        summary[k] = {"max": max(vals), "min": min(vals), "n": len(vals)}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
