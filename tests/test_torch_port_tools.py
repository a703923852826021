"""The port's run tools against the JAX package's: parse_log on a log the
port's train_net wrote (the rows and the --buckets summary), compare_dets
on the inputs of tests/test_checkpoint_tools.py (two pickles, a WIDER txt
tree and a tarball: the same table), and device_query on a machine
without a CUDA card."""

import logging
import os
import pickle
import re
import sys
import tarfile

import numpy as np
import pytest
import torch

from smallhardface_tpu.tools import compare_dets as jcompare
from smallhardface_tpu.tools import parse_log as jparse
from smallhardface_tpu_torch import __main__ as cli
from smallhardface_tpu_torch.tools import compare_dets as tcompare
from smallhardface_tpu_torch.tools import device_query
from smallhardface_tpu_torch.tools import parse_log as tparse
from smallhardface_tpu_torch.train import train_loop as ttl
import torch_threads  # noqa: F401
from tests.test_torch_port_train import port_cfg  # noqa: F401
from tests.test_train_loop import _tiny_roidb, train_cfg  # noqa: F401


@pytest.fixture
def port_log(tmp_path, port_cfg):  # noqa: F811
    """stderr.log of a 21-iteration port run on the CPU, in the command
    line's format: "iter" lines at iterations 1, 20 and 21."""
    path = str(tmp_path / "stderr.log")
    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter(cli.LOG_FORMAT, cli.LOG_DATEFMT))
    root = logging.getLogger()
    old_level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        out = str(tmp_path / "run")
        os.makedirs(out)
        ttl.train_net(_tiny_roidb(tmp_path), out, None, 21, device="cpu")
    finally:
        root.removeHandler(handler)
        root.setLevel(old_level)
        handler.close()
    return path


def test_parse_log_reads_the_port_log_like_jax(port_log, tmp_path,
                                               monkeypatch, capsys):
    rows = tparse.parse(port_log)
    assert [r["iteration"] for r in rows] == [1, 20, 21]
    assert all(r["wall_ts"] is not None and r["bucket"] for r in rows)
    assert rows == jparse.parse(port_log)
    # the stamp's milliseconds are zero-padded, so they read as written
    with open(port_log) as f:
        ms = [int(re.match(r"\S+,(\d+) ", ln).group(1)) for ln in f
              if " iter " in ln]
    assert [round(r["wall_ts"] % 1 * 1000) % 1000 for r in rows] == ms
    record = logging.makeLogRecord({"msg": "x", "levelname": "INFO"})
    record.created, record.msecs = 1e9 + 0.005, 5.0
    line = logging.Formatter(cli.LOG_FORMAT, cli.LOG_DATEFMT).format(record)
    assert round(tparse._wall_ts(line) % 1, 6) == 0.005
    assert tparse.bucket_summary(rows) == jparse.bucket_summary(rows)
    outputs = []
    for key, mod in (("port", tparse), ("jax", jparse)):
        csv = str(tmp_path / f"{key}.csv")
        for args in (["--buckets", port_log], [port_log, csv]):
            monkeypatch.setattr(sys, "argv", ["parse_log"] + args)
            mod.main()
        outputs.append(capsys.readouterr().out.replace(csv, "<csv>"))
        with open(csv) as f:
            outputs.append(f.read())
    assert outputs[0] == outputs[2] and outputs[1] == outputs[3]
    assert '"lines": 3' in outputs[0]


def _dets_pickles(tmp_path):
    dets = [[], [np.array([[1.0, 2, 10, 12, 0.9]]),
                 np.array([[5.0, 5, 20, 25, 0.7]])]]
    other = [[], [np.array([[1.0, 2, 10, 12, 0.9]]),
                  np.array([[50.0, 50, 60, 65, 0.7]])]]
    paths = []
    for name, d in (("a.pkl", dets), ("b.pkl", dets), ("c.pkl", other)):
        paths.append(str(tmp_path / name))
        with open(paths[-1], "wb") as f:
            pickle.dump(d, f)
    return paths


def _wider_trees(tmp_path):
    for side, score in (("a", 0.9), ("b", 0.905)):
        d = tmp_path / side / "detections" / "0--ev"
        d.mkdir(parents=True)
        (d / "img_0.txt").write_text(
            "0--ev/img_0.jpg\n2\n10 20 30 40 %.3f \n50 60 20 20 0.500 \n"
            % score)
    with tarfile.open(tmp_path / "b.tar.gz", "w:gz") as tf:
        tf.add(tmp_path / "b" / "detections", arcname="detections")
    return str(tmp_path / "a"), str(tmp_path / "b.tar.gz")


def test_compare_dets_matches_jax(tmp_path, monkeypatch, capsys):
    a, b, c = _dets_pickles(tmp_path)
    tree, tar = _wider_trees(tmp_path)
    cases = ([a, b], [a, c], [tree, tar],
             [tree, tar, "--score-tol", "0.001"])
    for args in cases:
        outs = []
        for mod in (tcompare, jcompare):
            monkeypatch.setattr(sys, "argv", ["compare_dets"] + args)
            mod.main()
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1] and "mean match-rate" in outs[0], args
    assert "mean match-rate 0.5000" in outs[0]


def test_device_query_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert device_query.main() == 0
    out = capsys.readouterr().out
    assert "no CUDA device" in out and torch.__version__ in out
