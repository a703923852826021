"""The fp32 tiny cells on the card (the int8 kernel needs wider channels
than the skeletal backbone has): the harness's device path, its trace
reduction and ``correct``. Skips without a card; on the chip:
``python -m pytest portbench/tests/test_portbench_card.py -q``."""

import pytest

import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny-eval", "tiny-train"])
def test_tiny_cell_on_the_card(card, tmp_path, cell, monkeypatch):
    from portbench import run as prun
    from smallhardface_tpu_torch.models import detector as dm
    monkeypatch.setattr(dm, "VGG_STAGES", tiny.SKELETAL)
    folder = tiny.write(str(tmp_path))
    for trace in (0, 1):
        args = prun.parse(["--workload", cell, "--seed", "12345",
                           "--seconds", "2", "--trace", str(trace),
                           "--workloads", folder])
        res, _ = prun.run_cell(args, card, stages=tiny.SKELETAL)
        assert res["correct"], res["checks"]
        assert res["device"]["platform"] == "gpu"
        if trace:
            assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
            idle = [v["value"] for k, v in res["metrics"].items()
                    if "idle" in k]
            assert idle and 0 <= idle[0] < 100
