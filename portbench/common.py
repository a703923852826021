"""What every driver shares: the cell's files, the configuration, the
weights, the traffic pool, the stage hook, the window and the records that
the per-layer readers take.

Files are found by name: ``configs/<config>.json``, ``workloads/<cell>.json``
(or the folder ``--workloads`` names), ``drivers/<driver>.py`` (its
``run(ctx)``) and ``metrics/<metric>.py`` (its ``read(rec)``).
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the modules the result may not coexist with, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "smallhardface_tpu")
# random-init heads score every anchor near 0.5; a background bias on
# cls_score_k ([bg, fg] = [+b, -b]) lets only the tail pass the 0.05 cut.
# chip_smoke.py sets b = 1.55 for its seed; here b is set per seed so that
# this share of the anchors of a 480x640 probe image passes, which gives
# every seed about 16k boxes above the cut of a 1024-wide image and a full
# vote of 2,048 rows
PASS_SHARE = 0.035
PASS_LOGIT = math.log(0.05 / 0.95)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(name, folder=None):
    return load_json(os.path.join(folder or os.path.join(HERE, "workloads"),
                                  f"{name}.json"))


def config(name, folder=None):
    """``configs/<name>.json``, or ``<folder>/<name>.json`` where a workloads
    folder holds one."""
    if folder and os.path.exists(os.path.join(folder, f"{name}.json")):
        return load_json(os.path.join(folder, f"{name}.json"))
    return load_json(os.path.join(HERE, "configs", f"{name}.json"))


def _merge(a, b):
    for k, v in b.items():
        if isinstance(v, dict) and isinstance(a.get(k), dict):
            _merge(a[k], v)
        else:
            a[k] = v
    return a


def config_dict(conf):
    """The configuration as a plain dict: the repo's default TOML, the
    configuration's TOML over it, then its ``amend`` pairs (values read as
    TOML literals), the way the port's ``cfg_from_file`` and
    ``cfg_from_list`` build it."""
    import tomllib
    tree = {}
    for path in (os.path.join(os.path.dirname(conf["toml"]), "default.toml"),
                 conf["toml"]):
        with open(os.path.join(ROOT, path), "rb") as f:
            _merge(tree, tomllib.load(f))
    amend = conf.get("amend", [])
    for key, val in zip(amend[::2], amend[1::2]):
        node = tree
        *path, last = key.split(".")
        for p in path:
            node = node[p]
        node[last] = tomllib.loads(f"v = {val}")["v"]
    return tree


def benchmark():
    path = os.path.join(ROOT, "BENCHMARK.json")
    return load_json(path) if os.path.exists(path) else None


def cell_metrics(bench, cell, section):
    """The names of ``section``'s metrics that ``cell`` reports, or None
    when BENCHMARK.json does not list the cell."""
    if bench is None or cell not in {w["name"] for w in bench["workloads"]}:
        return None
    return [m["name"] for m in bench[section]
            if cell in m.get("workloads", [cell])]


def process_age_s():
    """Seconds since this process started (its start time in /proc)."""
    with open("/proc/self/stat") as f:
        start = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


class Context:
    """One run of one cell: its files, arguments, device and records."""

    def __init__(self, args, device, stages=None):
        self.args = args
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(int(args.trace))
        self.cell = workload(args.workload, args.workloads)
        self.cell_name = args.workload
        self.conf = config(self.cell["config"], args.workloads)
        self.cfgd = config_dict(self.conf)
        self.device = device
        self.stages = stages            # None: VGG-16
        self.tmp = None

    @property
    def on_card(self):
        return self.device.type == "cuda"

    def sync(self):
        if self.on_card:
            import torch
            torch.cuda.synchronize(self.device)

    def port_config(self):
        """Load the configuration into the port's global ``cfg``: the
        defaults first (``cfg_from_file`` merges into what is there), then
        the configuration's TOML and its amend pairs."""
        from smallhardface_tpu_torch import config as pc
        pc.cfg_from_file(os.path.join(ROOT, os.path.dirname(
            self.conf["toml"]), "default.toml"))
        pc.cfg_from_file(os.path.join(ROOT, self.conf["toml"]))
        if self.conf.get("amend"):
            pc.cfg_from_list(list(self.conf["amend"]))
        return pc.cfg

    def weights(self):
        """The detector's weights from the seed, on the device, fp32, in a
        few large calls: one normal draw for every weight from a generator
        on the device, cut and scaled per leaf (He-normal for the
        backbone, 0.01 elsewhere), zero biases, the fixed bilinear deconv
        and the background bias on the score heads."""
        import torch
        from portbench.reference import arch
        stages = self.stages or arch.VGG16
        shapes = arch.param_shapes(stages)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        names = [n for n in sorted(shapes) if n != "conv5_256_up"]
        sizes = [math.prod(shapes[n]["w"]) for n in names]
        flat = torch.randn(sum(sizes), generator=gen, device=self.device)
        backbone = set(arch.backbone(stages))
        params, off = {}, 0
        for n, size in zip(names, sizes):
            o, c, kh, kw = shapes[n]["w"]
            std = math.sqrt(2.0 / (kh * kw * c)) if n in backbone else 0.01
            w = flat[off:off + size].view(o, c, kh, kw).mul_(std)
            params[n] = {"w": w, "b": torch.zeros(o, device=self.device)}
            off += size
        k = np.array([0.25, 0.75, 0.75, 0.25], np.float32)
        up = torch.from_numpy(np.outer(k, k)).to(self.device)
        params["conv5_256_up"] = {"w": up.expand(
            *shapes["conv5_256_up"]["w"]).contiguous()}
        b = self._background_bias(params, stages)
        for s in arch.ANCHOR_SCALES:
            params[f"cls_score_{s}"]["b"] = torch.tensor(
                [b, -b], device=self.device)
        return params

    def _background_bias(self, params, stages):
        """b such that PASS_SHARE of a probe image's anchors score above
        0.05 (foreground probability sigmoid(l_fg - l_bg - 2b)), from the
        plain reference's fp32 forward."""
        import torch
        from portbench.gen import images
        from portbench.reference.net import Net
        rng = np.random.default_rng(self.seed + 3)
        mean = np.asarray(self.cfgd["PIXEL_MEANS"], np.float32).reshape(3)
        x = images.background(480, 640, rng).astype(np.float32) - mean
        with torch.no_grad():
            logits, _ = Net(params, "fp32", stages)(
                torch.from_numpy(x)[None].to(self.device))
        d = (logits[..., 1] - logits[..., 0]).flatten().double()
        return float((torch.quantile(d, 1.0 - PASS_SHARE) - PASS_LOGIT) / 2)

    def pool(self):
        """The cell's image pool (``gen/images.make_pool``), and each image
        written as a JPEG under a folder of TMPDIR, its path in "path"."""
        from portbench.gen import images
        c = self.cell
        pool = images.make_pool(
            self.seed, int(c["images"]), c["shapes"],
            images.parse_range(c["faces"]),
            images.parse_range(c["face_px"]))
        if c.get("eval_batch", 1) > 1:
            pool = images.grouped(pool, int(c["eval_batch"]), self.seed)
        import tempfile
        self.tmp = tempfile.TemporaryDirectory(prefix="portbench-")
        for i, item in enumerate(pool):
            item["index"] = i
            item["path"] = os.path.join(self.tmp.name, f"{i:03d}.jpg")
            with open(item["path"], "wb") as f:
                f.write(item["jpeg"])
        return pool

    def close(self):
        if self.tmp is not None:
            self.tmp.cleanup()
            self.tmp = None

    # -- memory ----------------------------------------------------------
    def reset_peak(self):
        if self.on_card:
            import torch
            self.setup_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def window_peak(self):
        """(peak bytes in the window, peak bytes of the whole run)."""
        if not self.on_card:
            return None, None
        import torch
        w = torch.cuda.max_memory_allocated(self.device)
        return w, max(w, getattr(self, "setup_peak", 0))


@contextlib.contextmanager
def phase_b(ctx, box):
    """The profiled part of a traced run (on the card), or nothing."""
    if ctx.on_card:
        from portbench.yardstick.trace import profiled
        with profiled(ctx.device, box):
            t = time.perf_counter()
            yield
            box["window_s"] = time.perf_counter() - t
    else:
        t = time.perf_counter()
        yield
        box["window_s"] = time.perf_counter() - t
        box["trace"] = None


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))
