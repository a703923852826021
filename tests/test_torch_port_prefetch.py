"""The port's training prefetch (smallhardface_tpu_torch/train/train_loop.py
``train_net``, loader.py ``plan_minibatch`` / ``render_minibatch``) against
its serial order and the JAX loop, on the CPU:

- a sample's draws (``plan_minibatch``, in order) and its pixels
  (``render_minibatch``, on a pool of threads) equal ``get_minibatch``'s
  samples to the bit, at a host downscale and a device upscale, with the
  crop forced on and off, over flipped entries and an epoch boundary; the
  renders leave the loader's state alone;
- train_net with its threads gives a final.npz equal to the bit to
  train_net with the inline executor (augmentation, two images an
  iteration, easy-image marks, a snapshot between);
- with a delay injected into the draws, the renders or process_metrics,
  the drawn index sequence across the epoch boundaries of
  tests/test_torch_port_train.py's mining test still equals the JAX
  loop's under its inline executor;
- a device fault raised on the prefetch thread or a render thread reaches
  the caller as the same object, which ``device_fault`` classifies;
- no prefetch or render thread outlives train_net, whether it returns,
  stops on SIGINT or raises with a fetch in flight (in a subprocess, where
  the handlers go on the main thread).
"""

import json
import os
import pickle
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from smallhardface_tpu.config import cfg as jcfg
from smallhardface_tpu.train import train_loop as jtl
from smallhardface_tpu_torch.config import cfg as tcfg
from smallhardface_tpu_torch.train import loader as tloader
from smallhardface_tpu_torch.train import train_loop as ttl
from smallhardface_tpu_torch.utils.faults import device_fault, injected_fault
import torch_threads  # noqa: F401
from tests.test_torch_port_loader import _roidb, both_cfgs  # noqa: F401
from tests.test_torch_port_train import (  # noqa: F401
    _InlineExecutor, _run_both, port_cfg)
from tests.test_train_loop import _tiny_roidb, train_cfg  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_sample(want, got):
    assert want.keys() == got.keys()
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert w.dtype == got[k].dtype, k
            np.testing.assert_array_equal(w, got[k], err_msg=k)
        else:
            assert w == got[k], k


@pytest.mark.parametrize("crop_prob", [0.0, 1.0], ids=["no_crop", "crop"])
@pytest.mark.parametrize("scale_idx", [0, 1], ids=["downscale", "upscale"])
def test_parallel_renders_equal_get_minibatch(tmp_path, both_cfgs,  # noqa: F811
                                              monkeypatch, scale_idx,
                                              crop_prob):
    """both_cfgs' scales are 64 (a host downscale of the 120×160 images)
    and 240 (a device upscale); two passes over the 12 entries."""
    monkeypatch.setitem(tcfg.TRAIN.AUGMENT.CROP, "PROB", crop_prob)
    roidb = _roidb(tmp_path)
    serial, split = tloader.RoIDataLoader(roidb), tloader.RoIDataLoader(roidb)
    want = [serial.get_minibatch(scale_idx) for _ in range(2 * len(roidb))]
    plans = [split.plan_minibatch(scale_idx) for _ in range(len(want))]
    state = pickle.dumps(split.state_dict())
    with ThreadPoolExecutor(max_workers=4) as pool:
        got = list(pool.map(tloader.render_minibatch, plans))
    assert pickle.dumps(split.state_dict()) == state
    assert state == pickle.dumps(serial.state_dict())
    for w, g in zip(want, got):
        _same_sample(w, g)
    entries = [roidb[w["im_idx"]] for w in want]
    assert {e["flipped"] for e in entries} == {False, True}
    for w, e in zip(want, entries):
        shrunk = w["data"].shape[:2] < (e["height"], e["width"])
        assert shrunk == (scale_idx == 0)
        assert w["im_scale"] == (1.0 if scale_idx == 0 else 2.0)
    assert any(w["crop"] != (0, 0) for w in want) == (crop_prob == 1.0)


def test_decoded_extent_must_match_the_roidb(tmp_path, both_cfgs):  # noqa: F811
    roidb = _roidb(tmp_path, n=1)
    for e in roidb:
        e["height"] += 1
    plan = tloader.RoIDataLoader(roidb).plan_minibatch(0)
    with pytest.raises(ValueError, match="roidb entry says"):
        tloader.render_minibatch(plan)


def test_threads_equal_inline_order(tmp_path, port_cfg, monkeypatch):  # noqa: F811
    """Two images an iteration, augmentation on, every image marked easy
    (non-smooth: mark_easy draws its own stream and a drawn mark disables
    the image for good), a snapshot at 3 and epoch boundaries of an
    8-image roidb; the threads switch every microsecond."""
    for key, value in (("ITERSIZE", 2), ("SNAPSHOT", 3)):
        monkeypatch.setitem(tcfg.TRAIN, key, value)
    monkeypatch.setitem(tcfg.TRAIN.AUGMENT, "ENABLE", True)
    for key, value in (("THRESHOLD", 0.0), ("PROB", 0.2), ("SMOOTH", False)):
        monkeypatch.setitem(tcfg.TRAIN.DISABLE_EASY_IMAGE, key, value)
    roidb = _tiny_roidb(tmp_path, n=8)
    finals = {}
    for mode in ("thread", "inline"):
        out = str(tmp_path / mode)
        os.makedirs(out)
        if mode == "inline":
            monkeypatch.setattr(ttl, "ThreadPoolExecutor", _InlineExecutor)
        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            ttl.train_net(roidb, out, None, 8, device="cpu")
        finally:
            sys.setswitchinterval(switch)
        finals[mode] = np.load(os.path.join(out, "final.npz"))
    a, b = finals["thread"], finals["inline"]
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    state = pickle.loads(a["extra//loader_state"].tobytes())[0]
    assert any("skip" in m for m in state["mining"].values())


@pytest.mark.parametrize("where", ["draw", "render", "metrics"])
def test_marks_under_delays_match_jax(tmp_path, port_cfg, monkeypatch,  # noqa: F811
                                      where):
    """The setup of test_mining_marks_at_epoch_boundary_match_jax, with
    the JAX loop's executor inline and the port's threads slowed at one
    place: the draws (before every index), the renders, or
    process_metrics (in the progress hook). A draw slower than the CPU's
    step lets the main thread's marks land first when it applies them
    itself, as the JAX loop does: that design fails the "draw" case."""
    from smallhardface_tpu.train import loader as jloader
    monkeypatch.setattr(jtl, "ThreadPoolExecutor", _InlineExecutor)
    delay = 0.15 if where == "draw" else 0.05
    drawn = {"jax": [], "port": []}
    for key, mod in (("jax", jloader), ("port", tloader)):
        orig = mod.RoIDataLoader._next_index

        def record(self, orig=orig, key=key):
            if key == "port" and where == "draw":
                time.sleep(delay)
            idx = orig(self)
            drawn[key].append(int(idx))
            return idx
        monkeypatch.setattr(mod.RoIDataLoader, "_next_index", record)
    if where == "render":
        render = ttl.render_minibatch

        def slow_render(plan):
            time.sleep(delay)
            return render(plan)
        monkeypatch.setattr(ttl, "render_minibatch", slow_render)
    elif where == "metrics":
        train_net = ttl.train_net

        def slow_hook_train_net(*args, progress_hook=None, **kwargs):
            def hook(it, metrics):
                time.sleep(delay)
                if progress_hook is not None:
                    progress_hook(it, metrics)
            return train_net(*args, progress_hook=hook, **kwargs)
        monkeypatch.setattr(ttl, "train_net", slow_hook_train_net)
    for c in (jcfg, tcfg):
        monkeypatch.setitem(c.TRAIN.DISABLE_EASY_IMAGE, "THRESHOLD", 0.0)
        monkeypatch.setitem(c.TRAIN.DISABLE_EASY_IMAGE, "PROB", 0.3)
        monkeypatch.setitem(c.TRAIN, "SNAPSHOT", 100)
    roidb = _tiny_roidb(tmp_path, n=5)
    _run_both(tmp_path, roidb, 13)
    assert len(drawn["port"]) == len(drawn["jax"]) >= 13
    assert drawn["port"] == drawn["jax"]


@pytest.mark.parametrize("where", ["prefetch", "render"])
def test_worker_fault_reaches_the_caller(tmp_path, port_cfg, monkeypatch,  # noqa: F811
                                         where):
    """An injected sticky fault raised by the third fetch, on the prefetch
    thread (assemble_batch) or on a render thread, is what train_net
    raises, and device_fault calls it a fault."""
    raised, calls = [], {"n": 0}
    name = "assemble_batch" if where == "prefetch" else "render_minibatch"
    orig = getattr(ttl, name)

    def faulty(*args):
        calls["n"] += 1
        if calls["n"] == 3:
            raised.append(injected_fault(f"test, {where} thread"))
            raise raised[-1]
        return orig(*args)
    monkeypatch.setattr(ttl, name, faulty)
    before = set(threading.enumerate())
    with pytest.raises(Exception) as info:
        ttl.train_net(_tiny_roidb(tmp_path), str(tmp_path), None, 6,
                      device="cpu")
    assert info.value is raised[0]
    assert device_fault(info.value)
    assert not set(threading.enumerate()) - before


CHILD = r"""
import json, os, signal, sys, threading, time
sys.path.insert(0, {repo!r})
import numpy as np
from smallhardface_tpu_torch.config import cfg
from smallhardface_tpu_torch.models import detector as tdm
from smallhardface_tpu_torch.train import train_loop as ttl
from smallhardface_tpu_torch.utils.faults import injected_fault

tmp = sys.argv[1]
cfg.TRAIN.SCALES.SHORT_SIDE = [64]
cfg.TRAIN.SCALES.MAX_SIZE = 128
cfg.TRAIN.AUGMENT.ENABLE = True
cfg.TRAIN.ITERSIZE = 2
cfg.TRAIN.SNAPSHOT = 100
cfg.TRAIN.RESUME = ""
cfg.TPU.MAX_GT_BUCKETS = [8]
tdm.VGG_STAGES = (("conv1", 8, 1), ("conv2", 8, 1), ("conv3", 16, 1),
                  ("conv4", 16, 1), ("conv5", 16, 1))
ttl.BUCKET = 32
rng = np.random.RandomState(0)
roidb = []
for i in range(4):
    im = rng.randint(0, 255, (64, 80, 3), dtype=np.uint8)
    x1 = 10 + 5 * i
    im[12:36, x1:x1 + 24] = 250
    roidb.append({{"image": im, "flipped": False,
                  "boxes": np.array([[x1, 12, x1 + 23, 35]], np.float64),
                  "gt_classes": np.ones(1, np.int32),
                  "width": 80, "height": 64}})
before = set(threading.enumerate())


def left():
    return sorted(t.name for t in set(threading.enumerate()) - before)


def run(name, max_iter, **kwargs):
    out = os.path.join(tmp, name)
    os.makedirs(out)
    ttl.train_net(roidb, out, None, max_iter, device="cpu", **kwargs)
    return sorted(os.listdir(out))


result = {{"return": {{"files": run("return", 3)}}}}
result["return"]["left"] = left()


def sigint_at_first(it, metrics):
    if it == 1:
        os.kill(os.getpid(), signal.SIGINT)


result["sigint"] = {{"files": run("sigint", 6, progress_hook=sigint_at_first)}}
result["sigint"]["left"] = left()

# a device fault in the second step while the fetch of batch 2, slowed,
# is in flight
grad_step, render = ttl.grad_step, ttl.render_minibatch
steps = []


def faulty_step(*args):
    steps.append(1)
    if len(steps) == 2:
        raise injected_fault("test, main thread")
    return grad_step(*args)


def slow_render(plan):
    time.sleep(0.3)
    return render(plan)


ttl.grad_step, ttl.render_minibatch = faulty_step, slow_render
try:
    run("raise", 6)
    result["raise"] = {{"raised": None}}
except Exception as exc:
    result["raise"] = {{"raised": type(exc).__name__}}
result["raise"]["left"] = left()
print("RESULT " + json.dumps(result))
"""


@pytest.fixture(scope="module")
def lifetimes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lifetimes")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD.format(repo=REPO), str(tmp)],
        capture_output=True, text=True, timeout=240, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


@pytest.mark.parametrize("how", ["return", "sigint", "raise"])
def test_no_thread_outlives_train_net(lifetimes, how):
    got = lifetimes[how]
    assert got["left"] == [], got
    if how == "return":
        assert "final.npz" in got["files"]
    elif how == "sigint":
        # the hook of iteration 1 runs in iteration 2, so the stop and its
        # snapshot come at 3
        assert got["files"] == ["face_iter_3.npz"], got
    else:
        assert got["raised"] == "AcceleratorError", got
