"""Dataset evaluation in the port (smallhardface_tpu_torch/datasets, evals,
test_runner, __main__) on the CPU against the JAX package's, on the
synthetic trees of scripts/synth_wider.py and scripts/synth_bench.py:

- each dataset class: the same image list, the same WIDER roidb, and the
  same files from its detection writer (byte for byte) and the same result
  from its evaluator;
- wider_eval and face_eval: the same APs (exactly: both are the same
  float64 numpy code);
- test_net over a synthetic WIDER val set with the same converted weights,
  a skeletal backbone and a binding TPU.VOTE_CAP: every image's detections
  agree by the golden fixture's rule (tests/test_torch_port_slice.py:
  _agree), the Easy/Medium/Hard string is the same, and a second call
  reuses detections.pkl;
- ``python -m smallhardface_tpu_torch --train true --test true`` through
  ``__main__.main`` with ``--device cpu`` at a tiny size;
- TPU.HOST_PREPROC, the reference-exact host path, against the JAX one on
  the golden fixture.
"""

import copy
import filecmp
import os
import pickle
import sys
import tarfile

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from smallhardface_tpu.config import cfg as jcfg
from smallhardface_tpu.io import checkpoint as jckpt
from smallhardface_tpu.models import detector as jdm
from smallhardface_tpu_torch.config import cfg as tcfg
from smallhardface_tpu_torch.models import detector as tdm
from smallhardface_tpu_torch.train import train_loop as ttl
from tests.test_full_detect_golden import (  # noqa: F401 (golden_cfg)
    THRESH, _fixture_inputs, golden_cfg)
from tests.test_torch_port_slice import _agree, port_cfg  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import synth_bench  # noqa: E402
import synth_wider  # noqa: E402

SKELETAL = (("conv1", 8, 1), ("conv2", 8, 1), ("conv3", 16, 1),
            ("conv4", 16, 1), ("conv5", 16, 1))
LAYOUTS = {
    "wider_val": lambda root: synth_wider.build(root, n_images=3,
                                                im_size=96),
    "wider_train": lambda root: synth_wider.build(root, n_images=3,
                                                  im_size=96),
    "afw_val": synth_bench.build_afw,
    "fddb_val": synth_bench.build_fddb,
    "pascalface_val": synth_bench.build_pascal,
    "general_jpg": synth_bench.build_general,
}


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    root = str(tmp_path / "data")
    os.makedirs(root)
    for c in (jcfg, tcfg):
        monkeypatch.setitem(c, "DATA_DIR", root)
    return root


def _dets(rng, n_images, n=5):
    """all_boxes[class][image]: random (n, 5) float32 rows."""
    rows = []
    for _ in range(n_images):
        xy = rng.uniform(0, 60, (n, 2))
        wh = rng.uniform(8, 30, (n, 2))
        rows.append(np.column_stack([xy, xy + wh, rng.uniform(0.05, 1, n)])
                    .astype(np.float32))
    return [[], rows]


def _same_tree(a, b):
    """Every file under a and b byte for byte, and each archive's members
    (an archive itself carries its time of writing)."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(r, f), root)
                      for r, _, fs in os.walk(root) for f in fs)
    assert files(a) == files(b)
    for rel in files(a):
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if not rel.endswith(".tar.gz"):
            assert filecmp.cmp(pa, pb, shallow=False), rel
            continue
        with tarfile.open(pa) as ta, tarfile.open(pb) as tb:
            members = sorted(m.name for m in ta.getmembers() if m.isfile())
            assert members and members == sorted(
                m.name for m in tb.getmembers() if m.isfile())
            for m in members:
                assert (ta.extractfile(m).read()
                        == tb.extractfile(m).read()), m


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_dataset_matches_jax(data_dir, tmp_path, name):
    from smallhardface_tpu.datasets.factory import get_imdb as jget
    from smallhardface_tpu_torch.datasets.factory import get_imdb as tget
    LAYOUTS[name](data_dir)
    jdb, tdb = jget(name), tget(name)
    assert jdb.name == tdb.name and len(jdb) == len(tdb) > 0
    assert jdb.num_classes == tdb.num_classes
    assert [jdb.image_path_at(i) for i in range(len(jdb))] == [
        tdb.image_path_at(i) for i in range(len(tdb))]
    if name.startswith("wider"):
        want = jdb.roidb
        for f in os.listdir(os.path.join(data_dir, "cache")):
            os.unlink(os.path.join(data_dir, "cache", f))
        got = tdb.roidb
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(np.asarray(g[k]),
                                              np.asarray(w[k]), err_msg=k)
    all_boxes = _dets(np.random.RandomState(len(name)), len(jdb))
    out = {}
    for key, db in (("jax", jdb), ("port", tdb)):
        out[key] = str(tmp_path / key)
        os.makedirs(out[key])
        result = db.evaluate_detections(all_boxes, output_dir=out[key])
        out[key + "_result"] = result.replace(out[key], "<out>")
    assert out["port_result"] == out["jax_result"]
    if name.startswith("wider"):
        assert out["port_result"].startswith("Easy: ")
    _same_tree(out["jax"], out["port"])


@pytest.mark.parametrize("which", ["wider", "voc"])
def test_evaluators_match_jax(data_dir, tmp_path, which):
    rng = np.random.RandomState(5)
    if which == "voc":
        from smallhardface_tpu.evals import face_eval as jfe
        from smallhardface_tpu_torch.evals import face_eval as tfe
        gt = {f"im{i}": (rng.uniform(0, 80, (4, 4)).cumsum(1),
                         rng.rand(4) < 0.2) for i in range(6)}
        dets = [(f"im{rng.randint(0, 7)}", float(rng.rand()),
                 *rng.uniform(0, 80, 4).cumsum()) for _ in range(60)]
        want, got = jfe.voc_pr(gt, dets), tfe.voc_pr(gt, dets)
        assert got[2] == want[2] and 0 < got[2] < 1
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        return
    from smallhardface_tpu.datasets.wider import wider
    from smallhardface_tpu.evals.wider_eval import wider_eval as jwe
    from smallhardface_tpu_torch.evals.wider_eval import wider_eval as twe
    samples = synth_wider.build(data_dir, n_images=4, im_size=96)
    pred = str(tmp_path / "pred")
    all_boxes = [[], []]
    for _, boxes in samples:      # the faces, jittered, and some misses
        hit = np.column_stack([boxes + rng.normal(0, 3, boxes.shape),
                               rng.uniform(0.3, 1, len(boxes))])
        miss = np.column_stack([rng.uniform(0, 60, (3, 2)),
                                rng.uniform(70, 90, (3, 2)),
                                rng.uniform(0.05, 0.9, 3)])
        all_boxes[1].append(np.vstack([hit, miss]).astype(np.float32))
    wider("val").write_detections(all_boxes, pred)
    gt_dir = os.path.join(data_dir, "ground_truth")
    ap_j, pr_j = jwe(pred, gt_dir, parallel=False)
    ap_t, pr_t = twe(pred, gt_dir, parallel=False)
    assert ap_t == ap_j and 0 < min(ap_t)
    for a, b in zip(pr_t, pr_j):
        np.testing.assert_array_equal(a, b)


def test_wider_eval_spawned_pool_gives_the_same_ap(data_dir, tmp_path):
    """The three settings evaluated in a spawned pool of 3 (safe under a
    process that has initialised CUDA) give the APs and curves of the
    in-process evaluation, on a synth_wider tree."""
    from smallhardface_tpu_torch.datasets.wider import wider
    from smallhardface_tpu_torch.evals.wider_eval import wider_eval
    rng = np.random.RandomState(6)
    samples = synth_wider.build(data_dir, n_images=4, im_size=96)
    all_boxes = [[], []]
    for _, boxes in samples:
        hit = np.column_stack([boxes + rng.normal(0, 3, boxes.shape),
                               rng.uniform(0.3, 1, len(boxes))])
        miss = np.column_stack([rng.uniform(0, 60, (3, 2)),
                                rng.uniform(70, 90, (3, 2)),
                                rng.uniform(0.05, 0.9, 3)])
        all_boxes[1].append(np.vstack([hit, miss]).astype(np.float32))
    pred = str(tmp_path / "pred")
    wider("val").write_detections(all_boxes, pred)
    gt_dir = os.path.join(data_dir, "ground_truth")
    ap, pr = wider_eval(pred, gt_dir, parallel=False)
    ap_pool, pr_pool = wider_eval(pred, gt_dir, parallel=True)
    assert ap_pool == ap and 0 < min(ap)
    for a, b in zip(pr_pool, pr):
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def eval_cfg(port_cfg, data_dir, monkeypatch):
    """The golden fixture's TEST settings in both packages, a small pyramid,
    a binding vote cap, the flagship's heads and the skeletal backbone in
    both."""
    for c in (jcfg, tcfg):
        monkeypatch.setitem(c.TEST, "SCALES", [50, 90])
        monkeypatch.setitem(c.TPU, "DEVICE_VOTE", True)
        monkeypatch.setitem(c.TPU, "VOTE_CAP", 32)
        monkeypatch.setitem(c.TPU, "EVAL_BATCH", 1)
        monkeypatch.setitem(c.MODEL.DIFFERENT_DILATION, "ENABLE", True)
    monkeypatch.setattr(jdm, "VGG_STAGES", SKELETAL)
    monkeypatch.setattr(tdm, "VGG_STAGES", SKELETAL)


def _skeletal_weights(path):
    spec = jdm.build_spec(jcfg)
    params = jdm.init_params(jax.random.PRNGKey(7), spec)
    for k in (1, 2, 4):
        params[f"cls_score_{k}"]["b"] = jnp.asarray([1.2, -1.2])
    jckpt.save(path, jax.tree_util.tree_map(np.asarray, params))


def test_test_net_matches_jax(eval_cfg, data_dir, tmp_path, monkeypatch):
    from smallhardface_tpu import test_runner as jtr
    from smallhardface_tpu.datasets.factory import get_imdb as jget
    from smallhardface_tpu_torch import test_runner as ttr
    from smallhardface_tpu_torch.datasets.factory import get_imdb as tget
    synth_wider.build(data_dir, n_images=6, im_size=96)
    model = str(tmp_path / "weights.npz")
    _skeletal_weights(model)
    for c in (jcfg, tcfg):
        monkeypatch.setitem(c.TEST, "MODEL", model)
    # one JAX device, as the port has one
    one = jax.local_devices()[:1]
    monkeypatch.setattr(jtr.jax, "local_devices", lambda: one)
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(out_j)
    os.makedirs(out_t)
    want = jtr.test_net(jget("wider_val"), out_j, no_cache=False)
    got = ttr.test_net(tget("wider_val"), out_t, no_cache=False,
                       device="cpu")
    assert got == want and got.startswith("Easy: ")
    for name in ("detections.pkl", "result.tar.gz"):
        assert os.path.exists(os.path.join(out_t, name))
    with open(os.path.join(out_j, "detections.pkl"), "rb") as f:
        dets_j = pickle.load(f)[1]
    with open(os.path.join(out_t, "detections.pkl"), "rb") as f:
        dets_t = pickle.load(f)[1]
    assert len(dets_t) == len(dets_j) == 6
    for a, b in zip(dets_t, dets_j):
        _agree(a, b)
    assert any(len(b) > 1 for b in dets_j)

    def no_inference(*args, **kwargs):
        raise AssertionError("detections.pkl was not reused")
    monkeypatch.setattr(ttr, "run_inference", no_inference)
    assert ttr.test_net(tget("wider_val"), out_t, no_cache=False,
                        device="cpu") == got


def test_cli_train_then_test(data_dir, monkeypatch):
    """--train true --test true: trains on wider_train, writes final.npz,
    evaluates with it on wider_val, writes detections.pkl and
    result.tar.gz, cfgs.txt and stderr.log in each phase's directory."""
    from smallhardface_tpu_torch.__main__ import main
    synth_wider.build(data_dir, n_images=3, im_size=96)
    monkeypatch.setattr(tdm, "VGG_STAGES", SKELETAL)
    monkeypatch.setattr(ttl, "BUCKET", 32)
    saved = copy.deepcopy(tcfg)
    exp_dir = f"torch_port_cli_{os.getpid()}"
    root = os.path.join(REPO, "output", exp_dir)
    try:
        result = main([
            "--train", "true", "--test", "true", "--device", "cpu",
            "--conf", os.path.join(REPO, "smallhardface_tpu", "configs",
                                   "smallhardface.toml"),
            "--amend", "DATA_DIR", data_dir, "EXP_DIR", exp_dir,
            "TRAIN.ITERS", "2", "TRAIN.ITERSIZE", "1",
            "TRAIN.SCALES.SHORT_SIDE", "[64]", "TRAIN.SCALES.MAX_SIZE",
            "128", "TRAIN.AUGMENT.ENABLE", "False", "TPU.MAX_GT_BUCKETS",
            "[8]", "TEST.SCALES", "[50, 90]", "TEST.NO_CACHE", "False"])
        assert result.startswith("Easy: ")
        train_dir, = (os.path.join(root, "wider_train", d)
                      for d in os.listdir(os.path.join(root, "wider_train")))
        test_dir, = (os.path.join(root, "wider_val", d)
                     for d in os.listdir(os.path.join(root, "wider_val")))
        assert tcfg.TEST.MODEL == os.path.join(train_dir, "final.npz")
        for d, names in ((train_dir, ("final.npz", "cfgs.txt",
                                      "stderr.log")),
                         (test_dir, ("detections.pkl", "result.tar.gz",
                                     "cfgs.txt", "stderr.log"))):
            for n in names:
                assert os.path.exists(os.path.join(d, n)), (d, n)
    finally:
        tcfg.clear()
        tcfg.update(saved)
        import shutil
        shutil.rmtree(root, ignore_errors=True)


def test_host_preproc_matches_jax(port_cfg):
    """TPU.HOST_PREPROC in both packages on the golden fixture: cv2 resize
    on the host, one float32 upload per level, the float64 host vote."""
    from smallhardface_tpu.detect import TPUDetector
    from smallhardface_tpu_torch.detect import TorchDetector
    from smallhardface_tpu_torch.io.weights import params_from_numpy
    im, spec, params = _fixture_inputs()
    jcfg.TPU.HOST_PREPROC = tcfg.TPU.HOST_PREPROC = True
    want = TPUDetector(params, spec).detect(im, thresh=THRESH)[0][0]
    tree = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
            for k, v in params.items()}
    det = TorchDetector(params_from_numpy(tree),
                        tdm.ModelSpec(different_dilation=True), "cpu")
    assert det.host_preproc and not det.device_vote
    got = det.detect(im, thresh=THRESH)[0][0]
    _agree(got, want)
