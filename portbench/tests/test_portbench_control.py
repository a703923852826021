"""The control at a size a test run holds: the reference one precision
lower (TF32 for fp32, a 4-bit grid for int8) put in the program's place
fails the cell's compared numbers, while the program passes them. On the
card, ``portbench/control.py`` reads the same at the cells' own sizes."""

import pytest

import tiny
from portbench import control as pcontrol
from portbench.reference import compare


@pytest.fixture
def folder(tmp_path):
    return tiny.write(str(tmp_path))


def _control(folder, cell, monkeypatch, seed):
    import torch
    from portbench import run as prun
    from smallhardface_tpu_torch.models import detector as dm
    monkeypatch.setattr(dm, "VGG_STAGES", tiny.SKELETAL)
    args = prun.parse(["--workload", cell, "--seed", str(seed),
                       "--seconds", "2", "--trace", "0", "--workloads",
                       folder])
    res, _ = prun.run_cell(args, torch.device("cpu"), stages=tiny.SKELETAL,
                           control=True)
    return res


@pytest.mark.parametrize("cell", ["tiny-eval", "tiny-b4", "tiny-train"])
def test_control_is_not_correct(folder, cell, monkeypatch):
    res = _control(folder, cell, monkeypatch, 2 ** 31 + 23)
    assert res["correct"], res["checks"]
    control = {k[len("control."):]: v for k, v in res["readings"].items()
               if k.startswith("control.")}
    judged = {k: v for k, v in control.items() if k in compare.LIMITS}
    assert judged
    assert any(v > compare.LIMITS[k] for k, v in judged.items()), judged
    sides = pcontrol.judged(res["readings"])
    assert sides[""] and not sides["control"], sides
    if cell == "tiny-train":
        assert not sides["fault_half"], sides
