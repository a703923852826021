"""The cell of ``drivers/eval_retinaface.py`` end to end on the CPU at a
tiny size, as ``test_portbench_cells.py`` runs the others: RetinaFace at
its published widths on 64×96 images at short edges 50 and 90; the last
line's keys, ``correct`` against the reference, and the host numbers of
a traced run."""

import copy
import json
import os

import pytest

import tiny

ROOT = tiny.os.path.dirname(tiny.os.path.dirname(tiny.os.path.dirname(
    tiny.os.path.abspath(tiny.__file__))))
SMALL = ["TEST.SCALES", "[50, 90]", "TEST.PYRAMID_BASE_SIZE", "[64, 4000]"]
CELLS = {
    "tiny-retina": dict(config="tiny-retina-fp32", driver="eval_retinaface",
                        **tiny.POOL, pipeline_depth=3, thresh=0.02,
                        check_images=3, trace_images=3),
}


@pytest.fixture
def folder(tmp_path):
    """The tiny cells' folder with this cell, and the port's
    configuration restored after (a RetinaFace cell sets MODEL.ARCH)."""
    from smallhardface_tpu_torch.config import cfg
    saved = copy.deepcopy(cfg)
    folder = tiny.write(str(tmp_path))
    with open(os.path.join(ROOT, "portbench", "configs",
                           "retinaface-r50-fp32.json")) as f:
        conf = json.load(f)
    conf["amend"] = conf["amend"] + SMALL
    with open(os.path.join(folder, "tiny-retina-fp32.json"), "w") as f:
        json.dump(conf, f)
    for name, cell in CELLS.items():
        with open(os.path.join(folder, f"{name}.json"), "w") as f:
            json.dump(dict(cell, traffic="tiny", chips=1, why="test"), f)
    yield folder
    cfg.clear()
    cfg.update(saved)


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_new_cell_runs_correct(folder, cell, trace, monkeypatch):
    res, rows = tiny.run(folder, cell, monkeypatch, trace=trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert rows and all(v <= lim for _, v, lim in rows)
    if trace:
        assert "busy_s" not in res["device"]
        for name, m in res["metrics"].items():
            assert m["value"] > 0, name
    else:
        assert set(res["metrics"]) == {"images_per_s", "peak_mem_gib",
                                       "setup_s"}
    json.loads(json.dumps(res))
