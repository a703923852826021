"""The flagship training step as ``train_loop.train_net`` runs it: each
iteration's ``TRAIN.ITERSIZE`` samples padded to one bucket
(``assemble_batch``), uploaded from pinned host memory, ``grad_step``
(``LossFn``: the fused preprocess, the forward, K3 and OHEM, the losses;
the backward per micro-batch), then ``solver.apply_update`` and the
metrics read back, as ``tools/train_time.Step`` runs it.

The samples are drawn as ``train_net`` draws them: the port's loader
(``RoIDataLoader.plan_minibatch``, under the configuration's
``RNG_SEED``) over the pool and its mirror images, one training scale an
iteration from ``RNG_SEED``'s stream, aspect grouping, and the
configuration's crop (``TRAIN.AUGMENT.CROP``). The pool's face layout
comes from ``RNG_SEED`` too, so every seed draws the same scales, crops
and buckets; the seed draws the pixels, the weights and the order of the
``pool_iters`` iterations. The pixels are the benchmark's own: the
original image (mirrored where drawn), the gt boxes scaled and cropped
here from the draws; the photometric distortion, host-only, is left out.

The window cycles through the iterations; each pass restarts from the
set-up weights and solver slots (random weights at the base rate would
drift over many passes). The reference follows the window's first three
iterations: their losses, the first gradient as the solver took it and
the weights after the third, kept as the window runs them.

End to end: ``train_iters_per_s`` (iterations whose metrics were read back
within the window, over its length), ``peak_mem_gib``, ``setup_s``.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import common, evalcore

UNITS = {"train_iters_per_s": "iters/s", "peak_mem_gib": "GiB",
         "setup_s": "s"}
REF_STEPS = 3


def roidb(pool, flipped):
    """The pool as roidb entries (``datasets/imdb``'s keys), and with
    ``flipped`` each image's mirror after them, its boxes mirrored as
    ``imdb.append_flipped_images`` mirrors them."""
    out = []
    for j, item in enumerate(pool):
        h, w = item["shape"]
        out.append({"image": j, "height": h, "width": w, "flipped": False,
                    "boxes": item["boxes"].astype(np.float32),
                    "gt_classes": np.ones(len(item["boxes"]), np.int32)})
    if flipped:
        for e in list(out):
            b = e["boxes"].copy()
            b[:, 0] = e["width"] - e["boxes"][:, 2] - 1
            b[:, 2] = e["width"] - e["boxes"][:, 0] - 1
            out.append(dict(e, flipped=True, boxes=b))
    return out


def sample(pool, entry, plan):
    """The sample of one loader draw: the original image (mirrored if
    drawn), its scale and crop, and the gt boxes scaled and, where the
    draw cropped, kept by centre and clipped to the crop
    (``loader._sample_crop``'s rule)."""
    img = pool[entry["image"]]["image"]
    if entry["flipped"]:
        img = np.ascontiguousarray(img[:, ::-1])
    s = float(plan["im_scale"])
    hs, ws = (int(v) for v in plan["crop"])
    height, width = int(plan["height"]), int(plan["width"])
    hr = int(round(entry["height"] * s))
    wr = int(round(entry["width"] * s))
    gt = entry["boxes"] * np.float32(s)
    if (hs, ws, height, width) != (0, 0, hr, wr):
        xc = (gt[:, 0] + gt[:, 2]) / 2
        yc = (gt[:, 1] + gt[:, 3]) / 2
        gt = gt[(xc >= ws) & (xc < ws + width)
                & (yc >= hs) & (yc < hs + height)]
        gt[:, [0, 2]] = np.clip(gt[:, [0, 2]] - ws, 0.0, width)
        gt[:, [1, 3]] = np.clip(gt[:, [1, 3]] - hs, 0.0, height)
    gt = np.hstack([gt, np.ones((len(gt), 1), np.float32)])
    return {"height": height, "width": width, "data": img, "im_scale": s,
            "crop": (hs, ws), "gt_boxes": gt.astype(np.float32),
            "im_idx": plan["im_idx"]}


def samples(ctx, cfg):
    """The pool and ``pool_iters`` iterations of ``TRAIN.ITERSIZE``
    samples each, drawn as ``train_net`` draws them (the module's note),
    in the seed's order."""
    from portbench.gen import images
    from smallhardface_tpu_torch.train.loader import RoIDataLoader
    c = ctx.cell
    seed = int(cfg.RNG_SEED)
    pool = images.make_pool(ctx.seed, int(c["images"]), c["shapes"],
                            images.parse_range(c["faces"]),
                            images.parse_range(c["face_px"]),
                            layout_seed=seed)
    db = roidb(pool, bool(cfg.TRAIN.USE_FLIPPED))
    loader = RoIDataLoader(db)
    n_iters, per = int(c["pool_iters"]), int(cfg.TRAIN.ITERSIZE)
    scale_seq = np.random.RandomState(seed).randint(
        0, len(cfg.TRAIN.SCALES.SHORT_SIDE), size=n_iters)
    iters = []
    for it in range(n_iters):
        plans = [loader.plan_minibatch(int(scale_seq[it]))
                 for _ in range(per)]
        iters.append([sample(pool, db[p["im_idx"]], p) for p in plans])
    order = np.random.default_rng(ctx.seed + 2).permutation(n_iters)
    return pool, [iters[i] for i in order]


class Step:
    """The training step over the pool's iterations, one model and solver
    state from set-up to the window (``tools/train_time.Step``'s step)."""

    def __init__(self, ctx, params, iters):
        import torch
        from smallhardface_tpu_torch.models import detector as dm
        from smallhardface_tpu_torch.train import solver, targets
        from smallhardface_tpu_torch.train import train_loop as tl
        cfg = ctx.port_config()
        self.tl, self.solver, self.cfg = tl, solver, cfg
        self.device = ctx.device
        spec = dm.build_spec(cfg)
        self.lr_mults, self.decay_mults = dm.param_multipliers(spec)
        self.model = dm.Detector(params, spec, ctx.device, trainable=True)
        self.params = self.model.tree()
        self.solver_type = str(cfg.TRAIN.SOLVER_TYPE)
        self.opt_state = solver.init_state(
            {n: {k: v.detach() for k, v in leaf.items()}
             for n, leaf in self.params.items()}, self.solver_type)
        pin = ctx.on_card
        self.batches = []
        for it in iters:
            arrays, _, bucket = tl.assemble_batch(
                it, len(it), list(cfg.TPU.MAX_GT_BUCKETS))
            host = dict(arrays)
            for k in ("data", "gt", "gt_mask"):
                t = torch.from_numpy(arrays[k])
                host[k] = t.pin_memory() if pin else t
            self.batches.append((host, bucket))
        self.loss_fn = tl.LossFn(targets.from_cfg(cfg), ctx.device)
        self._start = [t.detach().clone() for t in self._state()]
        # the trainable leaves ("name/key") and their rate multipliers
        self.mults = {f"{n}/{k}": self.lr_mults[n][k]
                      for n, leaf in self.params.items() for k in leaf
                      if self.lr_mults[n][k] > 0}
        self.kept = {"metrics": []}

    def keep(self, k, metrics):
        """What the reference follows, from the first iterations of the
        window's first pass: each one's metrics, the momentum slot after
        the first (the first gradient times its rate) and the weights
        after the last."""
        kept = self.kept
        kept["metrics"].append(metrics)
        pick = [key.split("/") for key in self.mults]
        if k == 0:
            kept["h1"] = {f"{n}/{kk}": self.opt_state["h1"][n][kk].detach()
                          .clone() for n, kk in pick}
        if k == REF_STEPS - 1:
            kept["w"] = {f"{n}/{kk}": self.params[n][kk].detach().clone()
                         for n, kk in pick}

    def _state(self):
        return [t for tree in (self.params, *self.opt_state.values())
                for leaf in tree.values() for t in leaf.values()]

    def reset(self):
        import torch
        with torch.no_grad():
            for t, t0 in zip(self._state(), self._start):
                t.copy_(t0)

    def __call__(self, i, it, stages):
        host, bucket = self.batches[i]
        self.loss_fn.stages = stages
        with stages("upload"):
            batch = dict(host)
            for k in ("data", "gt", "gt_mask"):
                batch[k] = host[k].to(self.device, non_blocking=True)
        metrics = self.tl.grad_step(self.model, self.loss_fn, batch,
                                    bucket[2:4], len(host["data"]),
                                    stages=stages)
        with stages("update"):
            self.solver.apply_update(
                self.params, {n: {k: v.grad for k, v in leaf.items()}
                              for n, leaf in self.params.items()},
                self.opt_state, solver_type=self.solver_type,
                rate=self.solver.learning_rate(it, self.cfg),
                lr_mults=self.lr_mults, decay_mults=self.decay_mults,
                weight_decay=float(self.cfg.TRAIN.WEIGHT_DECAY),
                momentum=float(self.cfg.TRAIN.MOMENTUM), iteration=it)
        with stages("metrics"):
            return metrics.cpu().numpy()


def _loop(step, n_iters, stages, seconds=None, count=None):
    """Iterations cycling through the pool, each pass from the set-up
    state; the first ``REF_STEPS`` run whatever the deadline, and the step
    keeps what the reference follows from them. Returns (iterations read
    back before the deadline, run)."""
    t_end = None if seconds is None else time.perf_counter() + seconds
    done = k = 0
    while True:
        if (t_end is not None and time.perf_counter() >= t_end
                and k >= REF_STEPS):
            break
        if count is not None and k >= max(count, REF_STEPS):
            break
        i = k % n_iters
        if i == 0:
            step.reset()
        metrics = step(i, k, stages)
        if k < REF_STEPS:
            step.keep(k, metrics)
        k += 1
        if t_end is None or time.perf_counter() <= t_end:
            done += 1
    return done, k


def _control(ctx, params, iters, ref, w0, r_grads, skip):
    """Readings of the control (the reference in TF32 in the program's
    place) and of the fault "half of the batch left out" (the reference
    on one micro-batch of two, its mean over that one), each against the
    fp32 reference ``ref`` after its three iterations."""
    from portbench.reference import arch, compare
    from portbench.reference import train as rtrain
    out = {}
    ch_r = {k: v.detach() - w0[k] for k, v in ref.leaves().items()}
    ref_losses = ref.losses
    for name, mode, keep in (("control", "tf32", None),
                             ("fault_half", "fp32", 1)):
        t = rtrain.Trainer(params, ctx.cfgd, ctx.device, mode,
                           ctx.stages or arch.VGG16)
        gap, g1 = 0.0, None
        for k in range(REF_STEPS):
            loss, grads = t.step(iters[k][:keep] if keep else iters[k], k)
            g1 = grads if k == 0 else g1
            for j, (cls, reg) in enumerate(loss):
                r = sum(ref_losses[k][j])
                gap = max(gap, abs(cls + reg - r) / max(abs(r), 1e-30))
        ch = {k: v.detach() - w0[k] for k, v in t.leaves().items()}
        out[f"{name}.loss_gap"] = gap
        out[f"{name}.grad_gap"] = compare.leaf_gap(g1, r_grads)
        out[f"{name}.change_gap"] = compare.leaf_gap(ch, ch_r, skip)
        del t
    return out


def run(ctx):
    from portbench.reference import arch
    from portbench.reference import compare
    from portbench.reference import train as rtrain
    from portbench.yardstick import counts, peaks
    from portbench.yardstick.trace import Stages
    from smallhardface_tpu_torch.utils.timer import no_stages
    cfg = ctx.port_config()
    if ctx.on_card:
        from smallhardface_tpu_torch.ops import cuda_build, iou, stem
        cuda_build.build_all([stem.STEM, iou.IOU])
    c = ctx.cell
    _, iters = samples(ctx, cfg)
    params = ctx.weights()
    step = Step(ctx, params, iters)
    # warm-up: every bucket shape of the pool once; the window's first
    # pass starts again from the set-up state
    seen = set()
    for i, (_, bucket) in enumerate(step.batches):
        if bucket not in seen:
            seen.add(bucket)
            step(i, i, no_stages)
    ctx.sync()
    ctx.reset_peak()
    setup_s = common.process_age_s()
    n_iters = len(iters)
    box = {}
    if not ctx.trace:
        done, ran = _loop(step, n_iters, no_stages, seconds=ctx.seconds)
    else:
        n_b = int(c.get("trace_iters", 4))
        with common.phase_b(ctx, box):
            _, ran = _loop(step, n_iters, Stages(), count=n_b)
        done = ran
    ctx.sync()
    peak_window, peak_run = ctx.window_peak()
    kept, mults = step.kept, step.mults
    del step
    evalcore.free(ctx)
    # the reference: the window's first three iterations from the set-up
    # weights
    t = time.perf_counter()
    trainer = rtrain.Trainer(params, ctx.cfgd, ctx.device, "fp32",
                             ctx.stages or arch.VGG16)
    w0 = {k: v.detach().clone() for k, v in trainer.leaves().items()}
    loss_gap, r_grads = 0.0, None
    trainer.losses = []
    for k in range(REF_STEPS):
        out, grads = trainer.step(iters[k], k)
        trainer.losses.append(out)
        if k == 0:
            r_grads = grads
        for j, (cls, reg) in enumerate(out):
            m = kept["metrics"][k]
            p_loss = float(m[0, j] + m[1, j])
            loss_gap = max(loss_gap, abs(p_loss - (cls + reg))
                           / max(abs(cls + reg), 1e-30))
    med = float(np.median([float(g.double().norm())
                           for g in r_grads.values()]))
    skip = {k for k, g in r_grads.items()
            if float(g.double().norm()) < 1e-3 * med}
    # the first gradient: the momentum slot over the reference's rate
    rate = rtrain.learning_rate(0, ctx.cfgd)
    g1 = {key: h / (rate * mults[key]) for key, h in kept["h1"].items()}
    ch_p = {k: kept["w"][k] - w0[k] for k in w0}
    ch_r = {k: v.detach() - w0[k] for k, v in trainer.leaves().items()}
    nums = {"loss_gap": loss_gap,
            "grad_gap": compare.leaf_gap(g1, r_grads),
            "change_gap": compare.leaf_gap(ch_p, ch_r, skip)}
    if getattr(ctx, "control", False):
        nums.update(_control(ctx, params, iters, trainer, w0, r_grads, skip))
    common.log(f"reference: {REF_STEPS} iterations in "
               f"{time.perf_counter() - t:.1f} s; leaves left out of the "
               f"change: {sorted(skip)}")
    for k, v in nums.items():
        common.log(f"reading {k} = {v!r}")
    out = {"numbers": nums, "attempted": ran, "failed": 0, "units": UNITS,
           "device": evalcore.device_fields(ctx, peak_run,
                                            box if ctx.trace else None)}
    if not ctx.trace:
        out["e2e"] = {"train_iters_per_s": done / ctx.seconds,
                      "peak_mem_gib": (peak_window or 0) / 2 ** 30,
                      "setup_s": setup_s}
        common.log(f"window: {done} iterations in {ctx.seconds} s")
    else:
        layers = []
        for k in range(ran):
            for s in iters[k % n_iters]:
                ops, _ = counts.train_step(rtrain.snap(s["height"], 16),
                                           rtrain.snap(s["width"], 16),
                                           ctx.stages or arch.VGG16)
                layers.append({"ops": ops,
                               "peak": peaks.PEAK_FP32_CONTRACT})
        out["rec"] = evalcore.record("train", ran, {}, 0, box,
                                     {"layers": layers})
        out["breakdown"] = evalcore.breakdown(box)
    return out
