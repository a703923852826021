"""The wait spans: inside each stage of ``TorchDetector`` and of the
training step, a span "wait_<stage>" wraps each call that waits for the
device (a copy of host numbers from pageable memory, a readback), and
nothing else.

Detection copies every number its levels read to the device once a
``_pyramid`` call (the level table), from pinned memory and without
waiting, so its only waits are the readback's.

On the CPU, at the skeletal width: a recording hook over an fp32
``detect_async`` + ``finalize_async``, a calibrated int8 ``detect_many``
of four images and ``train_time.Step`` (``LossFn``, ``grad_step`` at
ITERSIZE 2 with OHEM, the solver, the metrics read back) sees every span
in order, each wait span inside its stage and none inside a wait span,
and the outputs equal to the bit to a run without a hook; under
``torch.profiler`` the "stage:wait_*" ranges lie inside their stage's
ranges; one copy of the level table a ``_pyramid`` call and device;
the benchmark's six readers of the spans on hand-made records.

On the card (marker ``cuda``; this file imports neither jax nor the JAX
package, so ``python -m pytest --noconftest tests/test_torch_port_waits.py
-q -m cuda`` runs it there): the same three paths at full width with
``torch.cuda.set_sync_debug_mode("error")`` outside every wait span, so
that a call that waits for the card outside one fails; and three
pyramids queued behind a busy card, equal to the bit to each one run
alone.
"""

import contextlib
import copy
import importlib.util
import os

import numpy as np
import pytest
import torch

from smallhardface_tpu_torch import detect as detect_mod
from smallhardface_tpu_torch.config import (CONFIG_DIR, PORT_CONFIG_DIR, cfg,
                                            cfg_from_file)
from smallhardface_tpu_torch.detect import TorchDetector
from smallhardface_tpu_torch.models import detector as tdm
from smallhardface_tpu_torch.models import retinaface as rm
from smallhardface_tpu_torch.tools import measure, pyramid_time, train_time
from smallhardface_tpu_torch.train import train_loop as ttl
from smallhardface_tpu_torch.utils.timer import no_stages
import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKELETAL = (("conv1", 8, 1), ("conv2", 8, 1), ("conv3", 16, 1),
            ("conv4", 16, 1), ("conv5", 16, 1))
RETINA_TOML = os.path.join(PORT_CONFIG_DIR, "retinaface-r50.toml")


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
        """Each wait span inside its stage (same level); nothing inside a
        wait span."""
        for (name, level), parent in self.opened:
            if parent is not None:
                assert not parent[0].startswith("wait_"), (name, parent)
            if name.startswith("wait_"):
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
    defaults, then ``toml``: a name in ``CONFIG_DIR`` or a path), with
    ``amend`` ("SECTION__KEY": value) over it; restored after."""
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
    the image and the level table go up without a wait, and no level
    waits; the row count and the rows are the two waits."""
    seq = [("prep", None), ("upload", None)]
    for li in range(levels):
        seq += [("preproc", li), ("forward", li), ("decode", li)]
    return seq + [("decode", None), ("vote", None), ("readback", None),
                  ("wait_readback", None), ("wait_readback", None)]


def _expected_many(levels, n):
    """The spans of ``detect_many`` over one group of ``n`` images: no
    level waits (its per-item extents are views of the level table);
    a readback per image."""
    seq = [("prep", None), ("upload", None)]
    for li in range(levels):
        seq += [("preproc", li), ("forward", li), ("decode", li)]
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


class Uploads:
    """``detect.upload_arrays`` wrapped: each copy's host arrays and
    device, in order."""

    def __init__(self, monkeypatch):
        self.copies, real = [], detect_mod.upload_arrays

        def upload(arrays, device):
            self.copies.append((arrays, device))
            return real(arrays, device)
        monkeypatch.setattr(detect_mod, "upload_arrays", upload)


def test_dynamic_int8_step_groups_wait_at_the_top(skeletal, monkeypatch):
    """Uncalibrated int8 carries each level's step groups in the level
    table: the 64×80 level's pair shares a step, the 96×128 level (at
    least FLIP_SPLIT_PX pixels) splits it; no "wait_groups" span opens,
    and the readback's are the only waits."""
    with _config("smallhardface-int8.toml", TEST__SCALES=[50, 90],
                 TPU__FLIP_SPLIT_PX=8000):
        det = _detector("cpu")
        rec = Recorder()
        det.stages = rec
        uploads = Uploads(monkeypatch)
        fp32_detect(det, _images(1, 96, 128)[0])
    ((table, _),) = uploads.copies
    assert table["groups"].tolist() == [[0, 0], [0, 1]]
    assert [s for s in rec.names() if s[0].startswith("wait_")] == [
        ("wait_readback", None)] * 2
    rec.check_nesting()


def _pyramids(monkeypatch):
    """``TorchDetector._pyramid`` wrapped: the number of calls, in a
    list."""
    calls, real = [], TorchDetector._pyramid

    def pyramid(self, *a, **k):
        calls.append(1)
        return real(self, *a, **k)
    monkeypatch.setattr(TorchDetector, "_pyramid", pyramid)
    return calls


@pytest.mark.parametrize("path", ["detect_async", "dynamic_int8_many",
                                  "spatial"])
def test_one_level_table_copy_a_pyramid_per_device(path, skeletal,
                                                   monkeypatch):
    """Every ``_pyramid`` call copies its level numbers to each device of
    its unit exactly once, all levels in one table: fp32 ``detect_async``;
    ``detect_many`` of four images under dynamic int8 in batches of two
    (two calls, the step groups in the table); a spatial unit of two
    CPU shards (one device, repeated: one copy)."""
    toml = "smallhardface-int8.toml" if "int8" in path else (
        "smallhardface.toml")
    with _config(toml, TEST__SCALES=[50, 90]):
        spec = tdm.build_spec(cfg)
        params = tdm.init_params(torch.Generator().manual_seed(3), spec)
        det = TorchDetector(params, spec, "cpu",
                            spatial_devices=(["cpu"] * 2 if path == "spatial"
                                             else None))
        ims = _images(4, 96, 128)
        calls, uploads = _pyramids(monkeypatch), Uploads(monkeypatch)
        if path == "dynamic_int8_many":
            det.detect_many(ims, 0.05, max_batch=2)
        else:
            fp32_detect(det, ims[0])
    assert len(calls) == (2 if path == "dynamic_int8_many" else 1)
    assert [d for _, d in uploads.copies] == [torch.device("cpu")] * len(
        calls)
    n = 2 if path == "dynamic_int8_many" else 1
    for table, _ in uploads.copies:
        assert ("groups" in table) == (path == "dynamic_int8_many")
        assert all(v.shape[0] == 2 for v in table.values())
        assert table["h_s"].shape == (2, n)


def test_training_preprocess_copies_its_four_numbers(monkeypatch):
    """Training's ``preprocess_image`` keeps its host numbers: the two
    resize matrices' inverse scale and translation, four copies to the
    device a micro-batch."""
    to, real = [], torch.Tensor.to

    def counted(self, *a, **k):
        to.append(1)
        return real(self, *a, **k)
    data = torch.from_numpy(_images(1, 64, 96)[0])
    mean = torch.tensor([102.9801, 115.9465, 122.7717])
    monkeypatch.setattr(torch.Tensor, "to", counted)
    x = ttl.preprocess_image(data, 0.75, (4, 8), (40, 60), (48, 64), mean)
    monkeypatch.undo()
    assert len(to) == 4 and x.shape == (48, 64, 3)


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


def _run_ahead_case(path, device, monkeypatch):
    """(run_queued(ims), run_alone(ims), images) of one path on the card:
    SHF fp32 ``detect_async`` at skeletal width, RetinaFace-R50's
    ``detect_async`` (random weights), dynamic int8 ``detect_many`` in
    batches of two, each at two small scales. ``run_queued`` issues three
    pyramids before it reads any back; ``run_alone`` reads each back
    before the next is issued."""
    if path == "fp32_detect_async":
        monkeypatch.setattr(tdm, "VGG_STAGES", SKELETAL)
        det = _detector(device)
        ims = _images(3, 192, 256)
    elif path == "retinaface_detect_async":
        params = rm.init_params(torch.Generator().manual_seed(5))
        det = TorchDetector(params, None, device)
        ims = _images(3, 192, 256)
    else:
        det = _detector(device)
        ims = _images(6, 192, 256)
    if path == "int8_detect_many":
        def queued(ims):
            return [r[0] for r in det.detect_many(ims, 0.05, max_batch=2)]

        def alone(ims):
            return [r[0] for i in range(0, len(ims), 2)
                    for r in det.detect_many(ims[i:i + 2], 0.05,
                                             max_batch=2)]
        return queued, alone, ims

    def queued(ims):
        handles = [det.detect_async(im, 0.05) for im in ims]
        return [det.finalize_async(h, 0.05)[0] for h in handles]

    def alone(ims):
        return [fp32_detect(det, im) for im in ims]
    return queued, alone, ims


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["fp32_detect_async",
                                  "retinaface_detect_async",
                                  "int8_detect_many"])
def test_queued_pyramids_equal_each_run_alone_on_the_card(path, cuda,
                                                          monkeypatch):
    """Three pyramids issued while the card is still busy (about half a
    second of ``torch.cuda._sleep``), then read back, give each image's
    rows equal to the bit to the image run alone: no pinned block of the
    raw image or the level table, and no device view of either, is
    reused while its pyramid is queued, and each readback waits for its
    own image's work."""
    toml, amend = {
        "fp32_detect_async": ("smallhardface.toml", {}),
        "retinaface_detect_async": (RETINA_TOML, {
            "TEST__PYRAMID_BASE_SIZE": [128, 4000]}),
        "int8_detect_many": ("smallhardface-int8.toml", {}),
    }[path]
    with _config(toml, TEST__SCALES=[128, 256], **amend):
        queued, alone, ims = _run_ahead_case(path, cuda, monkeypatch)
        want = alone(ims)
        torch.cuda.synchronize()
        torch.cuda._sleep(10 ** 9)
        got = queued(ims)
    assert len(got) == len(ims) and all(len(w) > 1 for w in want)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
