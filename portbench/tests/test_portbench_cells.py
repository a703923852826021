"""Every kind of cell end to end on the CPU at a tiny size: the last
line's keys, ``correct`` against the reference, the per-layer records of
a traced run, and a cell that only new files define."""

import json

import pytest

import tiny

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
E2E = {"tiny-eval": {"images_per_s", "peak_mem_gib", "setup_s"},
       "tiny-b4": {"images_per_s", "peak_mem_gib", "setup_s"},
       "tiny-train": {"train_iters_per_s", "peak_mem_gib", "setup_s"}}


@pytest.fixture
def folder(tmp_path):
    return tiny.write(str(tmp_path))


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_cell_runs_correct(folder, cell, monkeypatch):
    res, rows = tiny.run(folder, cell, monkeypatch)
    assert set(res) == KEYS and list(res)[-1] == "checks"
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == E2E[cell]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert rows and all(v <= lim for _, v, lim in rows)
    json.loads(json.dumps(res))


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_traced_run_reads_host_metrics(folder, cell, monkeypatch):
    """On the CPU a traced run has no device trace: the device readers
    return nothing and only host numbers appear."""
    res, _ = tiny.run(folder, cell, monkeypatch, trace=1)
    assert res["correct"]
    assert "busy_s" not in res["device"]
    for name, m in res["metrics"].items():
        assert not any(k in name for k in ("roofline", "mfu", "idle",
                                           "device_ms", "launches")), name
        assert m["value"] > 0


def test_new_workload_file_is_picked_up_by_name(folder, monkeypatch):
    """A cell defined only by a new file in a folder runs with no edit."""
    with open(f"{folder}/tiny-eval.json") as f:
        cell = json.load(f)
    cell["pipeline_depth"] = 1
    with open(f"{folder}/tiny-depth1.json", "w") as f:
        json.dump(cell, f)
    res, _ = tiny.run(folder, "tiny-depth1", monkeypatch)
    assert res["correct"] and res["metrics"]["images_per_s"]["value"] > 0
