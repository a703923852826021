"""Data-parallel training and multi-process evaluation in the port
(smallhardface_tpu_torch/parallel/dist.py, train/train_loop.py,
test_runner.py) against the JAX package on a 2-device mesh, with two
port ranks over gloo on the CPU, on the skeletal backbone, BUCKET 32 and
the 64×80 JPEGs of tests/test_train_loop.py:

- (a) one step's all-reduced gradient against the JAX make_train_step over
  make_mesh(2) on the same two ranks' data: rtol 1e-4, atol 1e-4·peak of
  each leaf (the tolerance of test_micro_batch_loss_and_grads_match_jax),
  the two ranks' gradients equal to the bit, the frozen leaves without one;
- (b) train_net for 3 iterations with mining on: rank r's losses against
  row r of the JAX hook's metrics (rtol 1e-3), the final weights within
  rtol 1e-3, atol 1e-6, both ranks' weights equal to the bit, the frozen
  leaves unchanged, rank 1 writing no file;
- (c) a snapshot at 2 and a resume to 4 equal to the bit to the straight
  4-iteration run, the snapshot's sampler list of 2 states; each package
  resumes the other's two-rank snapshot with both samplers restored and
  lands within (b)'s tolerance of the other's straight run;
- (d) SIGHUP then SIGINT sent to rank 1 only: rank 0 writes the snapshots
  and both ranks stop at the same iteration (the counterpart of
  tests/test_multihost.py::test_two_process_signal_agreement);
- (e) two ranks' test_net on 5 images gives the one-process
  detections.pkl array for array, rank 1 writing nothing; with a cache on
  rank 0 only, no rank detects and none hangs;
- (f) the raises: TPU.NUM_DEVICES other than the world, NCCL with more
  ranks than cards (a monkeypatched device count), and a spatial
  evaluation unit larger than the one CPU, which spatial training clamps
  with JAX's warning instead;
- (g) ``__main__.main`` --train true --test true as two ranks on a
  synthetic WIDER tree: one run directory per phase whatever each rank's
  clock, ``stderr.log`` (rank 0) and ``stderr.rank1.log``, equal weights
  digests in both ranks' train summaries, and the result on rank 0 only.

Each rank is a ``python -c`` child with torchrun's environment; a child
that fails or outlives RANK_TIMEOUT has its peers killed.
"""

import glob
import json
import logging
import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import jax
import torch

from smallhardface_tpu.config import cfg as jcfg
from smallhardface_tpu.io import checkpoint as jckpt
from smallhardface_tpu.models import detector as jdm
from smallhardface_tpu.parallel.mesh import make_mesh
from smallhardface_tpu.train import solver as jsolver
from smallhardface_tpu.train import targets as jtg
from smallhardface_tpu.train import train_loop as jtl
from smallhardface_tpu_torch.config import cfg as tcfg
from smallhardface_tpu_torch.models import detector as tdm
from smallhardface_tpu_torch.parallel import dist as pdist
from smallhardface_tpu_torch.train import train_loop as ttl
from tests.test_torch_port_train import (  # noqa: F401 (fixtures)
    MIRRORED, _jax_params, port_cfg, train_cfg)
from tests.test_train_loop import _tiny_roidb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 120          # seconds any child may take
RTOL_GRAD = 1e-4
RTOL_TRAIN, ATOL_TRAIN = 1e-3, 1e-6

CHILD = r"""
import json, logging, os, pickle, signal, sys
import numpy as np
import torch
torch.set_num_threads(1)
from smallhardface_tpu_torch import test_runner
from smallhardface_tpu_torch.config import cfg
from smallhardface_tpu_torch.io.weights import (params_from_numpy,
                                                params_to_numpy)
from smallhardface_tpu_torch.models import detector as tdm
from smallhardface_tpu_torch.parallel import dist as pdist
from smallhardface_tpu_torch.train import targets
from smallhardface_tpu_torch.train import train_loop as ttl

job = json.load(open(sys.argv[1]))
for path, value in job["cfg"].items():
    node = cfg
    *parents, leaf = path.split(".")
    for p in parents:
        node = node[p]
    node[leaf] = value
tdm.VGG_STAGES = tuple(tuple(s) for s in job["stages"])
ttl.BUCKET = job["bucket"]
messages = []


class Keep(logging.Handler):
    def emit(self, record):
        messages.append(record.getMessage())


logging.basicConfig(level=logging.INFO)
logging.getLogger().addHandler(Keep())
device = pdist.init_distributed("cpu")
rank = pdist.rank()
out = job["out"]
result = {"world": pdist.world(), "backend": pdist.backend()}


def grad():
    with open(job["batch"], "rb") as f:
        arrays, out_shape, params = pickle.load(f)
    arrays = {k: v[rank] for k, v in arrays.items()}
    batch = {k: torch.from_numpy(v) if k in ("data", "gt", "gt_mask")
             else v for k, v in arrays.items()}
    model = tdm.Detector(params_from_numpy(params), tdm.build_spec(cfg),
                         device, trainable=True)

    def reduce(grads):
        result["bytes"] = pdist.allreduce_sum_(grads)
        return pdist.world()
    ttl.grad_step(model, ttl.LossFn(targets.from_cfg(cfg), device), batch,
                  tuple(out_shape), int(cfg.TRAIN.ITERSIZE), reduce)
    result["grads"] = params_to_numpy(
        {n: {k: v.grad for k, v in leaf.items() if v.grad is not None}
         for n, leaf in model.tree().items()})


def train():
    with open(job["roidb"], "rb") as f:
        roidb = pickle.load(f)
    for run in job["runs"]:
        cfg.TRAIN.RESUME = run.get("resume", "")
        rows, seen = [], []

        def hook(it, m):
            seen.append(it)
            rows.append(np.asarray(m["cls_loss"]).ravel()
                        + np.asarray(m["reg_loss"]).ravel())
            if run.get("signals") and rank == 1:
                if it == 2:
                    os.kill(os.getpid(), signal.SIGHUP)
                if it == 5:
                    os.kill(os.getpid(), signal.SIGINT)
        d = os.path.join(out, run["name"], f"rank{rank}")
        os.makedirs(d)
        del messages[:]
        model = ttl.train_net(roidb, d, job.get("init"), run["iters"],
                              device=device, progress_hook=hook)
        result[run["name"]] = {
            "losses": rows, "seen": seen, "log": list(messages),
            "weights": params_to_numpy(model.tree())}


class FakeImdb:
    num_classes = 2
    name = "fake"

    def __init__(self, paths):
        self._paths = paths

    def __len__(self):
        return len(self._paths)

    def image_path_at(self, i):
        return self._paths[i]

    def evaluate_detections(self, all_boxes, output_dir=None,
                            method_name="x", step=0):
        return "ok"


def evaluate():
    spec = tdm.build_spec(cfg)
    params = tdm.init_params(torch.Generator().manual_seed(0), spec)
    imdb = FakeImdb(job["images"])
    d = os.path.join(out, f"rank{rank}")
    os.makedirs(d)
    result["first"] = test_runner.test_net(
        imdb, d, thresh=0.05, no_cache=False, params=params, spec=spec,
        device=device)
    # again: rank 0 holds the cache, rank 1 none; nobody may detect
    calls = []
    run_inference = test_runner.run_inference
    test_runner.run_inference = lambda *a, **k: calls.append(1) or \
        run_inference(*a, **k)
    result["cached"] = test_runner.test_net(
        imdb, d, thresh=0.05, no_cache=False, params=params, spec=spec,
        device=device)
    result["cached_inference_calls"] = len(calls)


def cli():
    import datetime
    import types
    from smallhardface_tpu_torch import __main__ as main_mod
    if rank == 1:
        # a clock a second (and more) behind rank 0's: the run directory
        # must still be rank 0's
        class Behind(datetime.datetime):
            @classmethod
            def now(cls, tz=None):
                return datetime.datetime(2001, 1, 1)
        main_mod.datetime = types.SimpleNamespace(datetime=Behind)
    result["return"] = main_mod.main(job["argv"])


{"grad": grad, "train": train, "eval": evaluate, "cli": cli}[job["job"]]()
with open(os.path.join(out, f"result{rank}.pkl"), "wb") as f:
    pickle.dump(result, f)
pdist.shutdown()
print("CHILD_OK", rank)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(tmp, job, world=2):
    """Run CHILD as ``world`` ranks (world 1: one process, no launcher
    environment) and return each rank's result dict. A rank that fails
    has its peers killed; so does one that outlives RANK_TIMEOUT."""
    out = str(tmp)
    os.makedirs(out, exist_ok=True)
    job = dict(job, out=out, stages=[list(s) for s in jdm.VGG_STAGES],
               bucket=jtl.BUCKET,
               cfg={**{p: _get(jcfg, p) for p in MIRRORED},
                    **job.get("cfg", {})})
    spec = os.path.join(out, "job.json")
    with open(spec, "w") as f:
        json.dump(job, f)
    port = _free_port()
    procs, logs = [], []
    for r in range(world):
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                            "MASTER_PORT", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                            pdist.BACKEND_ENV)}
        if world > 1:
            env.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                       LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
        env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        log = open(os.path.join(out, f"rank{r}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CHILD, spec], cwd=REPO, env=env,
            stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            failed = any(p.poll() not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate(timeout=RANK_TIMEOUT)
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0 and f"CHILD_OK {r}" in texts[r], (
            f"rank {r} rc={p.returncode}\n" + texts[r][-3000:])
    results = []
    for r in range(world):
        with open(os.path.join(out, f"result{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _get(cfg, path):
    node = cfg
    for p in path.split("."):
        node = node[p]
    return node


def _pickle(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    return str(path)


def _assert_close_trees(got, want, rtol, atol_of, what):
    assert set(got) == set(want), what
    for name, leaf in want.items():
        assert set(got[name]) == set(leaf), f"{what} {name}"
        for k, w in leaf.items():
            np.testing.assert_allclose(got[name][k], w, rtol=rtol,
                                       atol=atol_of(w),
                                       err_msg=f"{what} {name}/{k}")


def _assert_equal_trees(a, b, what):
    assert set(a) == set(b), what
    for name, leaf in a.items():
        for k, v in leaf.items():
            np.testing.assert_array_equal(v, b[name][k],
                                          err_msg=f"{what} {name}/{k}")


def _npz_equal(a, b):
    a, b = np.load(a), np.load(b)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _jax_train(roidb, out, init, iters, resume="", hook=None):
    os.makedirs(out, exist_ok=True)
    old = jcfg.TRAIN.RESUME
    jcfg.TRAIN.RESUME = resume
    try:
        jtl.train_net(roidb, out, init, iters, mesh=make_mesh(2),
                      progress_hook=hook)
    finally:
        jcfg.TRAIN.RESUME = old
    return jckpt.load(os.path.join(out, "final.npz"))[0]


def test_grad_scale_matches_jax_mesh(tmp_path, port_cfg):  # noqa: F811
    """(a) The all-reduced gradient is the JAX step's: the sum over both
    ranks' micro-batches divided by n_dev × iter_size, once."""
    n_dev, iter_size = 2, 1
    spec = jdm.build_spec(jcfg)
    rng = np.random.RandomState(11)
    samples = [{
        "height": 64, "width": 80,
        "data": rng.randint(0, 255, (64, 80, 3), dtype=np.uint8),
        "im_scale": 1.0, "crop": np.zeros(2, np.float32),
        "gt_boxes": np.array([[8. + 5 * k, 10., 30. + 5 * k, 33., 1.]],
                             np.float32),
        "im_idx": k} for k in range(n_dev * iter_size)]
    batch, _, bucket = jtl.assemble_batch(samples, n_dev, iter_size,
                                          list(jcfg.TPU.MAX_GT_BUCKETS))
    out_shape = (bucket[2], bucket[3])
    params = _jax_params(3)
    ranks = _run_ranks(tmp_path / "ranks", {
        "job": "grad", "batch": _pickle(tmp_path / "batch.pkl",
                                        (batch, out_shape, params))})

    step = jtl.make_train_step(spec, jtg.from_cfg(jcfg), make_mesh(n_dev),
                               iter_size, weight_decay=0.0, momentum=0.0)
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, params)
    p1, _, _ = step(jparams, jsolver.init_state(jparams, "SGD"),
                    np.float32(1.0), np.int32(0), out_shape,
                    *[batch[k] for k in ("data", "scale", "crop", "gt",
                                         "gt_mask", "im_hw", "valid_hw")])
    lr_mults, _ = jdm.param_multipliers(spec)
    want = {n: {k: (params[n][k] - np.asarray(p1[n][k])) / lr_mults[n][k]
                for k in leaf if lr_mults[n][k] > 0}
            for n, leaf in params.items()}
    want = {n: leaf for n, leaf in want.items() if leaf}
    got = {n: leaf for n, leaf in ranks[0]["grads"].items() if leaf}
    _assert_close_trees(got, want, RTOL_GRAD,
                        lambda w: RTOL_GRAD * max(np.abs(w).max(), 1e-12),
                        "grad")
    _assert_equal_trees(ranks[0]["grads"], ranks[1]["grads"], "rank 1")
    n_floats = sum(v.size for leaf in want.values() for v in leaf.values())
    assert ranks[0]["bytes"] == ranks[1]["bytes"] == 4 * n_floats
    assert ranks[0]["backend"] == "gloo" and ranks[0]["world"] == 2


def _jax_hook(rows):
    return lambda it, m: rows.append(np.asarray(m["cls_loss"])[:, 0]
                                     + np.asarray(m["reg_loss"])[:, 0])


def test_train_net_two_ranks_match_jax_mesh(tmp_path, port_cfg):  # noqa: F811
    """(b) Three iterations with mining on, two ranks against one JAX
    process on a 2-device mesh."""
    roidb = _tiny_roidb(tmp_path)
    init = str(tmp_path / "init.npz")
    params = _jax_params(1)
    jckpt.save(init, params)
    jrows = []
    want = _jax_train(roidb, str(tmp_path / "jax"), init, 3,
                      hook=_jax_hook(jrows))
    ranks = _run_ranks(tmp_path / "port", {
        "job": "train", "init": init,
        "roidb": _pickle(tmp_path / "roidb.pkl", roidb),
        "runs": [{"name": "three", "iters": 3}]})
    for r in range(2):
        got = ranks[r]["three"]
        np.testing.assert_allclose(np.concatenate(got["losses"]),
                                   np.array(jrows)[:, r], rtol=RTOL_TRAIN)
    weights = ranks[0]["three"]["weights"]
    _assert_close_trees(weights, want, RTOL_TRAIN, lambda w: ATOL_TRAIN,
                        "final")
    _assert_equal_trees(weights, ranks[1]["three"]["weights"], "rank 1")
    final = jckpt.load(str(tmp_path / "port" / "three" / "rank0" /
                           "final.npz"))[0]
    _assert_equal_trees(final, weights, "final.npz")
    lr_mults, _ = tdm.param_multipliers(tdm.build_spec(tcfg))
    for name, leaf in weights.items():
        for k, v in leaf.items():
            if lr_mults[name][k] == 0:
                np.testing.assert_array_equal(v, params[name][k])
    assert os.listdir(tmp_path / "port" / "three" / "rank1") == []


def test_two_rank_resume_bit_identical_and_across_packages(
        tmp_path, port_cfg, caplog):  # noqa: F811
    """(c) Snapshot at 2, resume to 4: equal to the bit to the straight
    run; each package resumes the other's two-rank snapshot with both
    samplers restored."""
    roidb = _tiny_roidb(tmp_path)
    init = str(tmp_path / "init.npz")
    jckpt.save(init, _jax_params(1))
    jax_dir = str(tmp_path / "jax")
    jrows = []
    jax_straight = _jax_train(roidb, jax_dir, init, 4, hook=_jax_hook(jrows))
    port = tmp_path / "port"
    straight = str(port / "straight" / "rank0")
    ranks = _run_ranks(port, {
        "job": "train", "init": init,
        "roidb": _pickle(tmp_path / "roidb.pkl", roidb),
        "runs": [
            {"name": "straight", "iters": 4},
            {"name": "resumed", "iters": 4,
             "resume": os.path.join(straight, "face_iter_2.npz")},
            {"name": "from_jax", "iters": 4,
             "resume": os.path.join(jax_dir, "face_iter_2.npz")}]})
    _npz_equal(os.path.join(straight, "final.npz"),
               str(port / "resumed" / "rank0" / "final.npz"))
    extra = jckpt.load(os.path.join(straight, "face_iter_2.npz"))[3]
    states = pickle.loads(np.asarray(extra["loader_state"]).tobytes())
    assert len(states) == 2 and states[0]["perm"] != states[1]["perm"]
    for name in ("straight", "resumed", "from_jax"):
        assert os.listdir(port / name / "rank1") == []
    for r in range(2):
        for name in ("resumed", "from_jax"):
            assert "Restored sampler state for 2 ranks" in \
                ranks[r][name]["log"], (r, name)
        # the port resumed from JAX's snapshot draws JAX's images
        np.testing.assert_allclose(
            np.concatenate(ranks[r]["from_jax"]["losses"]),
            np.array(jrows)[2:, r], rtol=RTOL_TRAIN)
    _assert_close_trees(ranks[0]["from_jax"]["weights"], jax_straight,
                        RTOL_TRAIN, lambda w: ATOL_TRAIN, "port from JAX")
    # and JAX resumed from the port's snapshot
    krows = []
    with caplog.at_level(logging.INFO, "smallhardface_tpu.train.train_loop"):
        from_port = _jax_train(roidb, str(tmp_path / "jax_from_port"), init,
                               4, resume=os.path.join(straight,
                                                      "face_iter_2.npz"),
                               hook=_jax_hook(krows))
    assert any("Restored sampler state for 2 ranks" in rec.getMessage()
               for rec in caplog.records)
    for r in range(2):
        np.testing.assert_allclose(
            np.array(krows)[:, r],
            np.concatenate(ranks[r]["straight"]["losses"])[2:],
            rtol=RTOL_TRAIN)
    _assert_close_trees(from_port, ranks[0]["straight"]["weights"],
                        RTOL_TRAIN, lambda w: ATOL_TRAIN, "JAX from port")


def test_signal_to_one_rank_acts_on_both(tmp_path, port_cfg):  # noqa: F811
    """(d) SIGHUP at rank 1's hook of iteration 2 and SIGINT at its hook of
    5: the hook of iteration X runs during iteration X + 1, the flags are
    gathered at the start of the next, so rank 0 snapshots at 4 and both
    stop at 7 with a snapshot, as the JAX processes do."""
    roidb = _tiny_roidb(tmp_path)
    ranks = _run_ranks(tmp_path / "port", {
        "job": "train", "roidb": _pickle(tmp_path / "roidb.pkl", roidb),
        "cfg": {"TRAIN.SNAPSHOT": 100},
        "runs": [{"name": "signals", "iters": 50, "signals": True}]})
    assert [ranks[r]["signals"]["seen"][-1] for r in range(2)] == [7, 7]
    rank0 = tmp_path / "port" / "signals" / "rank0"
    assert sorted(os.listdir(rank0)) == ["face_iter_4.npz",
                                         "face_iter_7.npz"]
    assert os.listdir(tmp_path / "port" / "signals" / "rank1") == []
    assert any("SIGHUP received" in m for m in ranks[1]["signals"]["log"])
    assert not any("SIGHUP received" in m
                   for m in ranks[0]["signals"]["log"])
    for r in range(2):
        assert "Stopping at iteration 7 on signal" in \
            ranks[r]["signals"]["log"]


def test_two_rank_eval_matches_one_process(tmp_path, port_cfg):  # noqa: F811
    """(e) Each rank detects its block; the gathered detections.pkl, written
    by rank 0 alone, equals one process's array for array. A second call
    finds rank 0's cache: no rank detects, and both return."""
    import cv2
    rng = np.random.RandomState(0)
    images = []
    for i in range(5):
        images.append(str(tmp_path / f"t{i}.jpg"))
        cv2.imwrite(images[-1], rng.randint(0, 255, (70, 90, 3),
                                            dtype=np.uint8))
    eval_cfg = {"TEST.SCALES": [50, 90], "TEST.FLIP": True,
                "TPU.TEST_BUCKET": 64, "TEST.N_DETS_PER_MODULE": 100}
    job = {"job": "eval", "images": images, "cfg": eval_cfg}
    one, = _run_ranks(tmp_path / "one", job, world=1)
    two = _run_ranks(tmp_path / "two", job)
    assert (one["first"], two[0]["first"], two[1]["first"]) == (
        "ok", "ok", None)
    assert (two[0]["cached"], two[1]["cached"]) == ("ok", None)
    assert two[0]["cached_inference_calls"] == 0
    assert two[1]["cached_inference_calls"] == 0
    assert os.listdir(tmp_path / "two" / "rank1") == []

    def load(d):
        with open(os.path.join(d, "rank0", "detections.pkl"), "rb") as f:
            return pickle.load(f)
    a, b = load(tmp_path / "one"), load(tmp_path / "two")
    assert len(a) == len(b) == 2 and len(a[1]) == len(b[1]) == 5
    for i, (x, y) in enumerate(zip(a[1], b[1])):
        np.testing.assert_array_equal(x, y, err_msg=f"image {i}")


def test_num_devices_other_than_world_raises(tmp_path, port_cfg,  # noqa: F811
                                             monkeypatch):
    """(f) TPU.NUM_DEVICES must be -1 or the world size."""
    monkeypatch.setitem(tcfg.TPU, "NUM_DEVICES", 2)
    with pytest.raises(ValueError, match="TPU.NUM_DEVICES=2 but this run "
                                         "has 1 rank"):
        ttl.train_net(_tiny_roidb(tmp_path), str(tmp_path), None, 1,
                      device="cpu")
    assert not glob.glob(str(tmp_path / "*.npz"))
    monkeypatch.setitem(tcfg.TPU, "NUM_DEVICES", 1)
    ttl._check_world(1)
    monkeypatch.setitem(tcfg.TPU, "NUM_DEVICES", -1)
    ttl._check_world(4)


@pytest.mark.parametrize("backend", ["", "nccl"])
def test_nccl_with_more_ranks_than_cards_raises(monkeypatch, backend):
    """(f) Two ranks on a node with one card: NCCL refuses before joining
    any group, and names the override."""
    for k, v in dict(RANK="1", LOCAL_RANK="1", WORLD_SIZE="2",
                     LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv(pdist.BACKEND_ENV, backend)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="SHF_DIST_BACKEND=gloo"):
        pdist.init_distributed("cuda")
    assert not pdist.active()


def test_without_a_launcher_init_is_a_no_op(monkeypatch):
    """No WORLD_SIZE, or a world of one without a rendezvous address: one
    process, and every helper acts as the one rank of a world of one."""
    for k in ("WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert pdist.init_distributed("cpu") == torch.device("cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert pdist.init_distributed("cpu") == torch.device("cpu")
    assert not pdist.active()
    assert (pdist.world(), pdist.rank(), pdist.backend()) == (1, 0, None)
    t = torch.arange(3.0)
    assert pdist.allreduce_sum_([t]) == 0
    assert torch.equal(t, torch.arange(3.0))
    np.testing.assert_array_equal(pdist.allgather_max([3, 1]), [3, 1])
    assert pdist.allgather_object("x") == ["x"]
    assert pdist.broadcast_object("y") == "y"


@pytest.mark.parametrize("where", ["train_net", "test_net"])
def test_spatial_still_raises(tmp_path, port_cfg, monkeypatch,  # noqa: F811
                              caplog, where):
    """(f) A unit of 2 over the one CPU: spatial training (ported,
    tests/test_torch_port_spatial_train.py) clamps it to the one device
    with JAX make_mesh's warning and trains; spatial evaluation
    (tests/test_torch_port_spatial.py) refuses it, with JAX's words."""
    monkeypatch.setitem(tcfg.TPU, "SPATIAL_DEVICES", 2)
    if where == "train_net":
        with caplog.at_level(logging.WARNING, logger=ttl.__name__):
            ttl.train_net(_tiny_roidb(tmp_path), str(tmp_path), None, 1,
                          device="cpu")
        assert ("Requested 2 devices but only 1 available (cpu backend); "
                "using 1") in caplog.text
        assert os.path.exists(os.path.join(str(tmp_path), "final.npz"))
    else:
        from smallhardface_tpu_torch import test_runner
        with pytest.raises(ValueError, match="must divide the local device"):
            test_runner.run_inference(None, None, None, 0.05, device="cpu")


def test_cli_two_ranks_share_one_run_directory(tmp_path,
                                               port_cfg):  # noqa: F811
    """(g) The command line as two ranks: rank 0's LOG.TIME names the run
    directory of both (rank 1's clock is set years behind), each rank logs
    to its own file, rank 0 alone writes and evaluates."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import synth_wider
    data = str(tmp_path / "data")
    synth_wider.build(data, n_images=3, im_size=96)
    root = str(tmp_path / "root")
    argv = ["--train", "true", "--test", "true", "--device", "cpu",
            "--conf", os.path.join(REPO, "smallhardface_tpu", "configs",
                                   "smallhardface.toml"),
            "--amend", "DATA_DIR", data, "ROOT_DIR", root, "EXP_DIR", "dp",
            "TRAIN.ITERS", "2", "TRAIN.ITERSIZE", "1", "TRAIN.PRETRAINED",
            "", "TRAIN.SCALES.SHORT_SIDE", "[64]", "TRAIN.SCALES.MAX_SIZE",
            "128", "TRAIN.AUGMENT.ENABLE", "False", "TPU.MAX_GT_BUCKETS",
            "[8]", "TEST.SCALES", "[50, 90]", "TEST.NO_CACHE", "False"]
    ranks = _run_ranks(tmp_path / "ranks", {"job": "cli", "argv": argv})
    assert ranks[0]["return"].startswith("Easy: ")
    assert ranks[1]["return"] is None
    train_dir, = glob.glob(os.path.join(root, "output", "dp", "wider_train",
                                        "*"))
    test_dir, = glob.glob(os.path.join(root, "output", "dp", "wider_val",
                                       "*"))
    assert "2001" not in train_dir
    assert sorted(os.listdir(train_dir)) == [
        "cfgs.txt", "face_iter_2.npz", "final.caffemodel", "final.npz",
        "stderr.log", "stderr.rank1.log"]
    assert sorted(os.listdir(test_dir)) == [
        "cfgs.txt", "detections.pkl", "result.tar.gz", "stderr.log",
        "stderr.rank1.log"]
    summaries = []
    for name in ("stderr.log", "stderr.rank1.log"):
        with open(os.path.join(train_dir, name)) as f:
            line, = (ln for ln in f if "train summary " in ln)
        summaries.append(json.loads(line.split("train summary ", 1)[1]))
    assert [s["rank"] for s in summaries] == [0, 1]
    assert summaries[0]["weights_sha256"] == summaries[1]["weights_sha256"]
    assert summaries[0]["allreduce_bytes"] > 0
    assert len(summaries[1]["allreduce_ms"]) == 2
