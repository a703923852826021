#!/usr/bin/env python3
"""Run one benchmark cell of the PyTorch port once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1> [--workloads <folder>]

The cell is ``portbench/workloads/<cell>.json`` (or ``<folder>/<cell>.json``):
its configuration (``portbench/configs/<config>.json``), its driver
(``portbench/drivers/<driver>.py``) and its traffic. A run makes its
inputs and weights from the seed, warms up the cell's shapes (set-up),
measures for ``--seconds``, checks the window's outputs against the plain
reference (``portbench/reference/``) and prints, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics; with ``--trace 1`` its
per-layer ones, each read by ``portbench/metrics/<metric>.py``),
``device`` and, last, ``checks``: each compared number with its limit.
The same numbers end standard error.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with 2 and prints no result. Caches stay inside the checkout: the port's
kernels in ``smallhardface_tpu_torch/csrc/build``, Triton's in
``portbench/.cache/triton``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--workloads", default=None,
                    help="folder of workload files (default: "
                         "portbench/workloads)")
    return ap.parse_args(argv)


def environment():
    """Fixed cache folders inside the checkout, and no JAX behind any
    library the port loads."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def run_cell(args, device, stages=None, control=False):
    """Run the cell on ``device`` and return (result dict, check rows).
    ``stages``: another backbone (the CPU tests' skeletal one);
    ``control``: also read the control and the faults (``control.py``),
    which the benchmark's own runs do not."""
    from portbench import common
    ctx = common.Context(args, device, stages)
    ctx.control = control
    driver = common.load_module(
        os.path.join(HERE, "drivers", f"{ctx.cell['driver']}.py"),
        f"portbench_driver_{ctx.cell['driver']}")
    try:
        out = driver.run(ctx)
    finally:
        ctx.close()
    from portbench.reference import compare
    correct, rows = compare.judge(out["numbers"])
    # an answer that never comes is not correct either
    correct = correct and out["failed"] == 0
    bench = common.benchmark()
    units = out.get("units", {})
    if ctx.trace:
        names = common.cell_metrics(bench, args.workload, "per_layer")
        if names is None:
            names = sorted(f[:-3] for f in os.listdir(
                os.path.join(HERE, "metrics")) if f.endswith(".py"))
        metrics = {}
        for name in names:
            reader = common.load_module(
                os.path.join(HERE, "metrics", f"{name}.py"),
                "portbench_metric_" + name.replace(".", "_"))
            value = reader.read(out["rec"])
            if value is not None:
                metrics[name] = {"value": value, "unit": reader.UNIT}
    else:
        names = common.cell_metrics(bench, args.workload, "end_to_end")
        e2e = out["e2e"]
        metrics = {k: {"value": v, "unit": units[k]} for k, v in e2e.items()
                   if names is None or k in names}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": out["device"]}
    if ctx.trace and out.get("breakdown"):
        result["breakdown"] = out["breakdown"]
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    if control:
        result["readings"] = out["numbers"]
    return result, rows


def main(argv=None):
    args = parse(argv)
    environment()
    import torch
    from portbench import common
    chips = int(common.workload(args.workload, args.workloads)
                .get("chips", 1))
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        common.log(f"portbench: the cell needs {chips} CUDA card(s); this "
                   f"machine has {have}")
        return 2
    try:
        import smallhardface_tpu_torch  # noqa: F401
    except ImportError as e:
        common.log(f"portbench: the port is not in this checkout ({e})")
        return 2
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    result, rows = run_cell(args, device)
    found = common.forbidden_modules()
    if found:
        common.log("portbench: modules of JAX or the JAX package were "
                   f"loaded: {found}; no result")
        return 3
    for name, value, limit in rows:
        common.log(f"check {name} = {value!r} (limit {limit!r})")
    for k, v in result["metrics"].items():
        if not math.isfinite(v["value"]):
            common.log(f"portbench: metric {k} is not finite: {v['value']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
