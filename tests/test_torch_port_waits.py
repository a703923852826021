"""The wait spans: inside each stage of ``TorchDetector`` and of the
training step, a span "wait_<stage>" wraps each call that waits for the
device (a copy of host numbers from pageable memory, a readback), and
nothing else.

On the CPU, at the skeletal width: a recording hook over an fp32
``detect_async`` + ``finalize_async``, a calibrated int8 ``detect_many``
of four images and ``train_time.Step`` (``LossFn``, ``grad_step`` at
ITERSIZE 2 with OHEM, the solver, the metrics read back) sees every span
in order, each wait span inside its stage and none inside a wait span,
and the outputs equal to the bit to a run without a hook; under
``torch.profiler`` the "stage:wait_*" ranges lie inside their stage's
ranges; the benchmark's six readers of the spans on hand-made records.

On the card (marker ``cuda``; this file imports neither jax nor the JAX
package, so ``python -m pytest --noconftest tests/test_torch_port_waits.py
-q -m cuda`` runs it there): the same three paths at full width with
``torch.cuda.set_sync_debug_mode("error")`` outside every wait span, so
that a call that waits for the card outside one fails.
"""

import contextlib
import copy
import importlib.util
import os

import numpy as np
import pytest
import torch

from smallhardface_tpu_torch.config import CONFIG_DIR, cfg, cfg_from_file
from smallhardface_tpu_torch.detect import TorchDetector
from smallhardface_tpu_torch.models import detector as tdm
from smallhardface_tpu_torch.tools import measure, pyramid_time, train_time
from smallhardface_tpu_torch.train import train_loop as ttl
from smallhardface_tpu_torch.utils.timer import no_stages
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKELETAL = (("conv1", 8, 1), ("conv2", 8, 1), ("conv3", 16, 1),
            ("conv4", 16, 1), ("conv5", 16, 1))
# the wait spans that open outside every stage: the bucketed forward's
# per-item extents, the dynamic int8 mode's step groups
TOP_LEVEL_WAITS = ("wait_extents", "wait_groups")


class Recorder:
    """A stage hook that records each span it opens, in order, with the
    span it opened inside (None at the top)."""

    def __init__(self):
        self.opened, self.stack = [], []

    @contextlib.contextmanager
    def __call__(self, name, level=None):
        parent = self.stack[-1] if self.stack else None
        self.opened.append(((name, level), parent))
        self.stack.append((name, level))
        try:
            yield
        finally:
            self.stack.pop()

    def names(self):
        return [span for span, _ in self.opened]

    def check_nesting(self):
        """Each wait span inside its stage (same level), or at the top
        for the top-level sites; nothing inside a wait span."""
        for (name, level), parent in self.opened:
            if parent is not None:
                assert not parent[0].startswith("wait_"), (name, parent)
            if not name.startswith("wait_"):
                continue
            if name in TOP_LEVEL_WAITS:
                assert parent is None, (name, parent)
            else:
                assert parent == (name[len("wait_"):], level), (name, parent)


class SyncGuard:
    """A stage hook that lets the card synchronise only inside a wait
    span: ``torch.cuda.set_sync_debug_mode(outside)`` everywhere else
    while ``armed``, "default" inside a wait span. It counts the wait
    spans it opened."""

    def __init__(self, outside="error"):
        self.outside, self.waits = outside, 0

    @contextlib.contextmanager
    def __call__(self, name, level=None):
        if not name.startswith("wait_"):
            yield
            return
        self.waits += 1
        torch.cuda.set_sync_debug_mode("default")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(self.outside)

    @contextlib.contextmanager
    def armed(self):
        torch.cuda.set_sync_debug_mode(self.outside)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")


@contextlib.contextmanager
def _config(toml, **amend):
    """The port's global config loaded as a benchmark cell loads it (the
    defaults, then ``toml``), with ``amend`` ("SECTION__KEY": value)
    over it; restored after."""
    saved = copy.deepcopy(cfg)
    try:
        cfg_from_file(os.path.join(CONFIG_DIR, "default.toml"))
        cfg_from_file(os.path.join(CONFIG_DIR, toml))
        for key, v in amend.items():
            section, k = key.split("__")
            cfg[section][k] = v
        yield cfg
    finally:
        cfg.clear()
        cfg.update(saved)


def _detector(device, b=1.2):
    """The configured detector with seeded weights, its heads biased by
    ``b`` so that the tail of the anchors passes the 0.05 cut (the vote
    has rows to merge)."""
    spec = tdm.build_spec(cfg)
    params = tdm.init_params(torch.Generator().manual_seed(3), spec)
    for k in tdm.ANCHOR_SCALES:
        params[f"cls_score_{k}"]["b"] = torch.tensor([b, -b])
    return TorchDetector(params, spec, device)


def _images(n, h, w):
    return [pyramid_time.synthetic_image(h, w, seed=s) for s in range(n)]


def fp32_detect(det, im):
    """The fp32 evaluation's path: ``detect_async`` then
    ``finalize_async``."""
    return det.finalize_async(det.detect_async(im, 0.05), 0.05)[0]


def int8_many(det, ims):
    """The int8 evaluation's path: ``detect_many`` of one group."""
    return [r[0] for r in det.detect_many(ims, 0.05, max_batch=4)]


def _spans(name, level, n):
    return [(name, level)] * n


def _expected_detect(levels):
    """The spans of one image's ``detect_async`` + ``finalize_async``:
    per level six copies in preproc (two scalars of each of two resize
    matrices, the extents) and seven in decode (four per-item fields,
    the base anchors, the widths to un-mirror about, the inverse
    scales); the image's upload; the row count and the rows."""
    seq = [("prep", None), ("upload", None), ("wait_upload", None)]
    for li in range(levels):
        seq += ([("preproc", li)] + _spans("wait_preproc", li, 6)
                + [("forward", li), ("decode", li)]
                + _spans("wait_decode", li, 7))
    return seq + [("decode", None), ("vote", None), ("readback", None),
                  ("wait_readback", None), ("wait_readback", None)]


def _expected_many(levels, n):
    """The spans of ``detect_many`` over one group of ``n`` images: per
    level the two per-item extents before the level's stages, four
    copies a resize pair an image and the extents in preproc, decode as
    for one image; a readback per image."""
    seq = [("prep", None), ("upload", None), ("wait_upload", None)]
    for li in range(levels):
        seq += (_spans("wait_extents", li, 2) + [("preproc", li)]
                + _spans("wait_preproc", li, 4 * n + 2)
                + [("forward", li), ("decode", li)]
                + _spans("wait_decode", li, 7))
    seq += [("decode", None), ("vote", None)]
    for _ in range(n):
        seq += [("readback", None)] + _spans("wait_readback", None, 2)
    return seq


def _expected_step(iter_size):
    """The spans of one ``train_time.Step`` call: per micro-batch four
    copies in preproc (the resize matrices' scalars) and the base
    anchors in targets; the metrics read back."""
    seq = [("upload", None)]
    for _ in range(iter_size):
        seq += ([("preproc", None)] + _spans("wait_preproc", None, 4)
                + [("forward", None), ("targets", None),
                   ("wait_targets", None), ("backward", None)])
    return seq + [("reduce", None), ("update", None), ("metrics", None),
                  ("wait_metrics", None)]


@pytest.fixture
def skeletal(monkeypatch):
    monkeypatch.setattr(tdm, "VGG_STAGES", SKELETAL)
    monkeypatch.setattr(ttl, "BUCKET", 32)
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_detect_async_wait_spans(skeletal):
    with _config("smallhardface.toml", TEST__SCALES=[50, 90]):
        det = _detector("cpu")
        im = _images(1, 96, 128)[0]
        plain = fp32_detect(det, im)
        rec = Recorder()
        det.stages = rec
        got = fp32_detect(det, im)
    assert len(plain) > 1 and np.array_equal(got, plain)
    assert rec.names() == _expected_detect(2)
    rec.check_nesting()


def test_detect_many_int8_wait_spans(skeletal):
    with _config("smallhardface-int8.toml", TEST__SCALES=[50, 90]):
        det = _detector("cpu")
        ims = _images(4, 96, 128)
        det.calibrate_int8(ims[:1])
        plain = int8_many(det, ims)
        rec = Recorder()
        det.stages = rec
        got = int8_many(det, ims)
    assert all(np.array_equal(a, b) for a, b in zip(got, plain))
    assert rec.names() == _expected_many(2, 4)
    rec.check_nesting()


def test_dynamic_int8_step_groups_wait_at_the_top(skeletal):
    """Uncalibrated int8 uploads each level's step groups before the
    level's stages: one top-level wait span a level."""
    with _config("smallhardface-int8.toml", TEST__SCALES=[50, 90]):
        det = _detector("cpu")
        rec = Recorder()
        det.stages = rec
        fp32_detect(det, _images(1, 96, 128)[0])
    groups = [s for s in rec.names() if s[0] == "wait_groups"]
    assert groups == [("wait_groups", 0), ("wait_groups", 1)]
    rec.check_nesting()


def test_training_step_wait_spans(skeletal):
    """``train_time.Step`` (``grad_step`` at ITERSIZE 2 with OHEM, the
    solver, the metrics read back) under the recording hook: the spans in
    order, and the plain step's metrics and weights to the bit."""
    with _config("smallhardface.toml"):
        samples = train_time.make_samples(96, 128, 2)
        plain = train_time.Step(cfg, "cpu", samples)
        want = [plain(it) for it in range(2)]
        rec = Recorder()
        step = train_time.Step(cfg, "cpu", samples, stages=rec)
        got = [step(it) for it in range(2)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for name, leaf in plain.params.items():
        for k, v in leaf.items():
            assert torch.equal(v, step.params[name][k]), (name, k)
    assert rec.names() == _expected_step(2) * 2
    rec.check_nesting()


def _profiled_ranges(fn):
    """The stage ranges of one run of ``fn(hook)`` under torch.profiler
    (CPU activity): [(name, start µs, end µs)]."""
    from torch.profiler import ProfilerActivity, profile
    hook = measure.Stages()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(hook)
    return [(n, a, b) for n, a, b, _ in measure.Trace(prof).ranges
            if n.startswith(measure.STAGE_PREFIX)]


@pytest.mark.parametrize("path", ["detect", "train"])
def test_wait_ranges_lie_inside_their_stage_ranges(path, skeletal):
    """On the profiler's timeline each "stage:wait_<s>[.L<k>]" range lies
    inside a "stage:<s>[.L<k>]" range, and every wait span is a range."""
    if path == "detect":
        with _config("smallhardface.toml", TEST__SCALES=[50, 90]):
            det = _detector("cpu")
            im = _images(1, 96, 128)[0]

            def run(hook):
                det.stages = hook
                fp32_detect(det, im)
            ranges = _profiled_ranges(run)
        n_waits = sum(1 for s in _expected_detect(2) if s[0][:5] == "wait_")
    else:
        with _config("smallhardface.toml"):
            step = train_time.Step(cfg, "cpu",
                                   train_time.make_samples(96, 128, 2))

            def run(hook):
                step.set_stages(hook)
                step(0)
            ranges = _profiled_ranges(run)
        n_waits = sum(1 for s in _expected_step(2) if s[0][:5] == "wait_")
    prefix = measure.STAGE_PREFIX + "wait_"
    waits = [r for r in ranges if r[0].startswith(prefix)]
    assert len(waits) == n_waits
    for name, a, b in waits:
        parent = measure.STAGE_PREFIX + name[len(prefix):]
        assert any(n == parent and s <= a and b <= e
                   for n, s, e in ranges), name


# ---- the benchmark's readers of the spans ----------------------------

def _reader(name):
    path = os.path.join(ROOT, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trace(ranges, device):
    """A benchmark ``Trace`` as the profiler would give it."""
    from portbench.yardstick.trace import Trace
    tr = Trace.__new__(Trace)
    tr.ranges, tr.device = ranges, device
    return tr


def _rec(kind, trace, host_s=None, items=2, host_items=4):
    return {"kind": kind, "items": items, "host_s": host_s or {},
            "host_items": host_items, "trace": trace, "window_s": 1.0,
            "work": {"layers": [], "k1": [], "q1": []}}


# host ranges (µs): a decode stage 0-100 holding a wait 40-60, a readback
# 200-300 holding a wait 210-290, and a third wait 400-410; device events
# 0-50 | 70-100 | 150-250 | 500-520: gaps 50-70 (opens at 50, in the
# first wait), 100-150 (opens in no wait) and 250-500 (opens at 250, in
# the readback's wait)
RANGES = [("stage:decode.L0", 0.0, 100.0), ("stage:wait_decode.L0", 40.0,
                                            60.0),
          ("stage:readback", 200.0, 300.0),
          ("stage:wait_readback", 210.0, 290.0),
          ("stage:wait_decode.L1", 400.0, 410.0), ("other", 0.0, 600.0)]
DEVICE = [("k", 0.0, 50.0, 1.0), ("k", 70.0, 100.0, 60.0),
          ("k", 150.0, 250.0, 120.0), ("k", 500.0, 520.0, 420.0)]


@pytest.mark.parametrize("kind", ["eval", "train"])
def test_readers_on_a_hand_made_trace(kind):
    tr = _trace(RANGES, DEVICE)
    per = {"eval": "image", "train": "iter"}[kind]
    syncs = _reader(f"syncs_per_{per}.{kind}")
    assert syncs.read(_rec(kind, tr)) == pytest.approx(3 / 2)
    drained = _reader(f"sync_drained_idle_pct.{kind}")
    assert drained.read(_rec(kind, tr)) == pytest.approx(
        100.0 * (20 + 250) / (20 + 50 + 250))
    other = {"eval": "train", "train": "eval"}[kind]
    assert syncs.read(_rec(other, tr)) is None
    assert drained.read(_rec(other, tr)) is None
    if kind == "train":
        wait = _reader("host_wait_ms_per_iter.train")
        assert wait.read(_rec(kind, tr)) == pytest.approx(
            (20 + 80 + 10) / 1e3 / 2)
    else:
        wait = _reader("host_wait_ms_per_image.eval")
        host = {"decode": 0.5, "wait_decode": 0.2, "wait_readback": 0.1,
                "readback": 0.15}
        assert wait.read(_rec(kind, None, host)) == pytest.approx(
            0.3 * 1e3 / 4)


def test_readers_give_nothing_without_wait_spans():
    """On the CPU (no trace), and on a program without wait spans (no
    "wait_" stage or range), every reader returns None."""
    no_waits = _trace([r for r in RANGES if "wait_" not in r[0]], DEVICE)
    for name in ("syncs_per_image.eval", "sync_drained_idle_pct.eval",
                 "host_wait_ms_per_image.eval"):
        r = _reader(name)
        assert r.read(_rec("eval", None, {"decode": 0.5})) is None
        assert r.read(_rec("eval", no_waits, {"decode": 0.5})) is None
    for name in ("syncs_per_iter.train", "sync_drained_idle_pct.train",
                 "host_wait_ms_per_iter.train"):
        r = _reader(name)
        assert r.read(_rec("train", None)) is None
        assert r.read(_rec("train", no_waits)) is None


def test_drained_share_is_zero_when_no_gap_opens_in_a_wait():
    ranges = [("stage:wait_decode.L0", 500.0, 510.0)]
    tr = _trace(ranges, DEVICE)
    assert _reader("sync_drained_idle_pct.eval").read(
        _rec("eval", tr)) == 0.0


# ---- on the card -----------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the sync check reads the CUDA "
                    "runtime's synchronisations")
    from smallhardface_tpu_torch.ops import (conv_int8, cuda_build, iou,
                                             nms_device, stem)
    tdm.pin_fp32_numerics()
    cuda_build.build_all([stem.STEM, stem.STEM_GRAD, iou.IOU,
                          nms_device.VOTE, conv_int8.CONV_INT8])
    return torch.device("cuda")


def card_paths(device):
    """The three hot paths at full width on ``device``, each as (name,
    run(hook)) with its detector or step built and warmed up: an fp32
    ``detect_async`` + ``finalize_async`` of a 768×1024 image over the
    flagship pyramid, a calibrated int8 ``detect_many`` of four such
    images at max_batch 4, a flagship training step at ITERSIZE 2 with
    OHEM and the solver."""
    with _config("smallhardface.toml"):
        det = _detector(device, pyramid_time.CLS_BIAS)
        im = _images(1, 768, 1024)[0]
        fp32_detect(det, im)
    with _config("smallhardface-int8.toml"):
        det8 = _detector(device, pyramid_time.CLS_BIAS)
        ims = _images(4, 768, 1024)
        det8.calibrate_int8(ims[:1])
        int8_many(det8, ims)
    with _config("smallhardface.toml"):
        step = train_time.Step(cfg, device,
                               train_time.make_samples(640, 800, 2))
        step(0)
    return [
        ("fp32_detect_async", _hooked(
            "smallhardface.toml", lambda h: setattr(det, "stages", h),
            lambda: fp32_detect(det, im))),
        ("int8_detect_many", _hooked(
            "smallhardface-int8.toml", lambda h: setattr(det8, "stages", h),
            lambda: int8_many(det8, ims))),
        ("flagship_train_step", _hooked(
            "smallhardface.toml", step.set_stages, lambda: step(0)))]


def _hooked(toml, set_hook, fn):
    """``run(hook)``: ``fn()`` under ``toml``'s config with the stage hook
    set by ``set_hook``, put back to ``no_stages`` after."""
    def run(hook):
        with _config(toml):
            set_hook(hook)
            try:
                return fn()
            finally:
                set_hook(no_stages)
    return run


@pytest.mark.cuda
def test_no_sync_outside_a_wait_span_on_the_card(cuda):
    """Each path once more with the card's synchronisations an error
    outside every wait span: a call that waits for the card and that no
    span names raises."""
    for name, run in card_paths(cuda):
        guard = SyncGuard("error")
        with guard.armed():
            run(guard)
        torch.cuda.synchronize()
        assert guard.waits > 0, name
