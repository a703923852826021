"""SIGINT and SIGHUP in the port's train_net against the JAX loop's
(smallhardface_tpu/train/train_loop.py:779-805, :873-880, :954-961).

SIGHUP asks for a snapshot at the next iteration; SIGINT for a snapshot
and a stop. Both loops decide at the top of an iteration, so a signal
sent from the progress hook (which runs one iteration late, or at once on
a snapshot iteration) acts at the same iteration in both.

signal.signal works only on the main thread, and a pytest-xdist worker
need not run tests there (the loops then skip their handlers), so the
runs happen in a subprocess: the port's and the JAX train_net on
tests/test_train_loop._tiny_roidb with the skeletal network, from the
same JAX-initialised weights, each sending itself SIGHUP at its hook's
second call and SIGINT at its fourth. Then:

- both write snapshots at the same iterations and stop at the same one;
- the port's last snapshot is within the tolerance of
  test_train_net_matches_jax (rtol 1e-3, atol 1e-6) of the JAX one's;
- a port resume from the signal's snapshot to max_iter ends equal to the
  bit to an uninterrupted port run that wrote the same snapshots (SIGHUP
  where the other got SIGINT). A snapshot iteration hands the pending
  easy-image marks to the loader before the next fetch, and the marks act
  at the epoch reshuffle that 4 images and 8 iterations include, so an
  uninterrupted run without those snapshots may sample otherwise in both
  packages;
- the handlers in place before train_net are back after it returns and
  after it raises (an injected fault, SHF_FAULT_ITER).
"""

import json
import os
import re
import subprocess
import sys

import numpy as np

import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_ITER = 8

CHILD = r"""
import json, os, pathlib, signal, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir", os.path.join({repo!r},
                                                            ".jax_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from smallhardface_tpu.config import cfg as jcfg
from smallhardface_tpu.io import checkpoint as jckpt
from smallhardface_tpu.models import detector as jdm
from smallhardface_tpu.parallel.mesh import make_mesh
from smallhardface_tpu.train import train_loop as jtl
from smallhardface_tpu_torch.config import cfg as tcfg
from smallhardface_tpu_torch.models import detector as tdm
from smallhardface_tpu_torch.train import train_loop as ttl
from tests.test_train_loop import _tiny_roidb

tmp = pathlib.Path(sys.argv[1])
max_iter = {max_iter}
settings = {{
    "TRAIN.SCALES.SHORT_SIDE": [64], "TRAIN.SCALES.MAX_SIZE": 128,
    "TRAIN.AUGMENT.ENABLE": False, "TRAIN.ITERSIZE": 1,
    "TRAIN.SNAPSHOT": 100, "TPU.MAX_GT_BUCKETS": [8],
    "MODEL.DIFFERENT_DILATION.ENABLE": True,
    "TRAIN.DISABLE_EASY_IMAGE.ENABLE": True,
    "TRAIN.DISABLE_EASY_IMAGE.SMOOTH": True, "TRAIN.RESUME": ""}}
for c in (jcfg, tcfg):
    for path, v in settings.items():
        *parents, key = path.split(".")
        node = c
        for p in parents:
            node = node[p]
        node[key] = v
jdm.VGG_STAGES = tdm.VGG_STAGES = (
    ("conv1", 8, 1), ("conv2", 8, 1), ("conv3", 16, 1), ("conv4", 16, 1),
    ("conv5", 16, 1))
jtl.BUCKET = ttl.BUCKET = 32
roidb = _tiny_roidb(tmp)
init = str(tmp / "init.npz")
params = jdm.init_params(jax.random.PRNGKey(1), jdm.build_spec(jcfg))
jckpt.save(init, {{n: {{k: np.asarray(v) for k, v in leaf.items()}}
                  for n, leaf in params.items()}})


def previous(signum, frame):
    pass


def restored():
    return (signal.getsignal(signal.SIGINT) is previous
            and signal.getsignal(signal.SIGHUP) is previous)


def hook_sending(signals, seen):
    def hook(it, metrics):
        seen.append(it)
        sig = signals.get(len(seen))
        if sig is not None:
            os.kill(os.getpid(), sig)
    return hook


signal.signal(signal.SIGINT, previous)
signal.signal(signal.SIGHUP, previous)
stop = {{2: signal.SIGHUP, 4: signal.SIGINT}}
twice = {{2: signal.SIGHUP, 4: signal.SIGHUP}}
runs = {{
    "jax": lambda d, hook: jtl.train_net(roidb, d, init, max_iter,
                                         mesh=make_mesh(1),
                                         progress_hook=hook),
    "port": lambda d, hook: ttl.train_net(roidb, d, init, max_iter,
                                          device="cpu", progress_hook=hook),
    "port_uninterrupted": lambda d, hook: ttl.train_net(
        roidb, d, init, max_iter, device="cpu", progress_hook=hook),
}}
out = {{}}
for key, run in runs.items():
    d = tmp / key
    d.mkdir()
    seen = []
    run(str(d), hook_sending(twice if key == "port_uninterrupted" else stop,
                             seen))
    out[key] = {{"hooks": seen, "restored": restored(),
                "files": sorted(os.listdir(d))}}
last = max(int(f[len("face_iter_"):-4]) for f in out["port"]["files"]
           if f.startswith("face_iter_"))
tcfg.TRAIN.RESUME = str(tmp / "port" / f"face_iter_{{last}}.npz")
(tmp / "resumed").mkdir()
ttl.train_net(roidb, str(tmp / "resumed"), init, max_iter, device="cpu")
tcfg.TRAIN.RESUME = ""
out["resumed"] = {{"restored": restored(),
                  "files": sorted(os.listdir(tmp / "resumed"))}}
os.environ["SHF_FAULT_ITER"] = "2"
(tmp / "fault").mkdir()
try:
    ttl.train_net(roidb, str(tmp / "fault"), init, max_iter, device="cpu")
    raised = None
except Exception as e:
    raised = type(e).__name__
out["fault"] = {{"raised": raised, "restored": restored()}}
print("RESULT " + json.dumps(out))
"""


def _snapshot_iters(files):
    return sorted(int(f[len("face_iter_"):-4]) for f in files
                  if f.startswith("face_iter_"))


def test_signals_snapshot_and_stop_like_jax(tmp_path):
    code = CHILD.format(repo=REPO, max_iter=MAX_ITER)
    env = dict(os.environ)
    env.pop("SHF_FAULT_ITER", None)
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line, = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    out = json.loads(line[len("RESULT "):])
    jax_run, port = out["jax"], out["port"]

    # the same snapshots and the same stop, in both packages
    snaps = _snapshot_iters(port["files"])
    assert snaps == _snapshot_iters(jax_run["files"]) == [4, 5]
    assert port["hooks"] == jax_run["hooks"] == [1, 2, 3, 4, 5]
    stops = re.findall(r"Stopping at iteration (\d+) on signal", proc.stderr)
    assert stops == ["5", "5"], stops
    assert "final.npz" not in port["files"] + jax_run["files"]

    # the port's signal snapshot against JAX's
    got = np.load(tmp_path / "port" / "face_iter_5.npz")
    want = np.load(tmp_path / "jax" / "face_iter_5.npz")
    keys = [k for k in want.files if k.startswith("params//")]
    assert keys and set(keys) <= set(got.files)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-6,
                                   err_msg=k)
    assert int(got["meta//iteration"]) == 5

    # a resume from it reaches the uninterrupted run's weights to the bit
    assert _snapshot_iters(out["port_uninterrupted"]["files"]) == [4, 5, 8]
    a = np.load(tmp_path / "port_uninterrupted" / "final.npz")
    b = np.load(tmp_path / "resumed" / "final.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    # the previous handlers are back after a return and after a raise
    for key in ("jax", "port", "port_uninterrupted", "resumed"):
        assert out[key]["restored"], key
    assert out["fault"] == {"raised": "AcceleratorError", "restored": True}
