"""The port's per-stage timing tools on the CPU (``--device cpu``), with
the skeletal backbone: each tool's ``main`` runs and its last line parses,
the stage names equal the JAX package's ``vgg_stage_list`` and
``chain_stage_list``, the per-layer table covers every scope of the
forward, the forward's scopes change no bit of it, an instrumented
``detect`` gives a plain one's rows, ``train_time``'s step gives the losses
and weights of a plain ``grad_step`` and solver step, and the profiler's
grouping (``tools/measure.Trace``) on a hand-made trace. Device times need
the card: here they are None."""

import contextlib
import copy
import io
import json

import numpy as np
import pytest
import torch

from smallhardface_tpu.models import detector as jdm
from smallhardface_tpu.tools import measure as jmeasure
from smallhardface_tpu_torch.config import cfg as tcfg
from smallhardface_tpu_torch.models import detector as tdm
from smallhardface_tpu_torch.tools import (benchmark, layer_time, measure,
                                           perf_probe, pyramid_time,
                                           train_time)
from smallhardface_tpu_torch.train import solver
from smallhardface_tpu_torch.train import train_loop as ttl

SKELETAL = (("conv1", 8, 1), ("conv2", 8, 1), ("conv3", 16, 1),
            ("conv4", 16, 1), ("conv5", 16, 1))


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny skeletal shapes run fastest on one CPU thread, also beside
    other test workers; the process's setting is put back after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def skeletal(monkeypatch):
    """The skeletal backbone in the port, its training buckets small, and
    the port's config restored after the tools load theirs."""
    monkeypatch.setattr(tdm, "VGG_STAGES", SKELETAL)
    monkeypatch.setattr(ttl, "BUCKET", 32)
    saved = copy.deepcopy(tcfg)
    yield
    tcfg.clear()
    tcfg.update(saved)


def _run(main, argv):
    """main(argv)'s result and its printed last line, parsed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    last = json.loads(buf.getvalue().strip().splitlines()[-1])
    return result, last


@pytest.mark.parametrize("stages", [SKELETAL, tdm.VGG_STAGES])
def test_stage_names_equal_jax(stages):
    assert measure.vgg_stage_list(stages) == jmeasure.vgg_stage_list(stages)
    assert (measure.chain_stage_list(stages)
            == jmeasure.chain_stage_list(stages))
    assert tdm.VGG_STAGES == jdm.VGG_STAGES


TOOL_RUNS = {
    "benchmark": (benchmark.main, ["--height", "64", "--width", "96",
                                   "--iters", "2"]),
    "benchmark_train": (benchmark.main, ["--height", "64", "--width", "96",
                                         "--iters", "2", "--train"]),
    "benchmark_bf16": (benchmark.main, ["--height", "64", "--width", "96",
                                        "--iters", "2", "--bf16"]),
    "layer_time": (layer_time.main, ["--size", "64", "96"]),
    "layer_time_train": (layer_time.main, ["--size", "64", "96", "--train"]),
    "layer_time_bisect": (layer_time.main, ["--size", "64", "96",
                                            "--bisect"]),
    "layer_time_int8": (layer_time.main, ["--size", "64", "96",
                                          "--int8-chain", "--reps", "1"]),
    "pyramid_time": (pyramid_time.main, ["--size", "96", "128", "--scales",
                                         "50", "90", "--reps", "2"]),
    "train_time": (train_time.main, ["--size", "96", "128", "--reps", "2"]),
    "perf_probe": (perf_probe.main, ["--size", "64", "96", "--scales", "50",
                                     "90", "--batch", "2", "--iters", "1"]),
}


@pytest.mark.parametrize("tool", sorted(TOOL_RUNS))
def test_tool_main_runs_on_cpu(tool, skeletal):
    main, argv = TOOL_RUNS[tool]
    result, last = _run(main, argv + ["--device", "cpu"])
    assert last["device"] == "cpu" and last["card"] is None
    if tool == "perf_probe":
        probes = [r["probe"] for r in result]
        assert probes == [f"fwd_{p}_{m}" for p in ("float32", "bfloat16",
                                                   "int8")
                          for m in ("where", "unmasked")] + [
                              "detect", "batching"]
        assert all(r["device_ms"] is None for r in result[:6])
        assert result[6]["rows_equal"]
        return
    assert last == json.loads(json.dumps(result, default=float))
    if tool.startswith("benchmark"):
        assert last["device_ms"] is None and last["min_ms"] > 0
        assert last["mode"] == ("fwd+bwd" if "train" in tool else "forward")
    elif tool == "layer_time_int8":
        assert [r["stage"] for r in last["rows"]] == \
            measure.chain_stage_list(SKELETAL)
        assert all(r["int8_ms"] is None and r["floor_ms"] > 0
                   for r in last["rows"])
    elif tool.startswith("layer_time"):
        spec = tdm.ModelSpec(different_dilation=True)
        assert list(last["layers"]) == tdm.scope_names(spec)
        assert all(r["calls"] >= 1 for r in last["layers"].values())
        if tool == "layer_time_bisect":
            assert [r["stage"] for r in last["bisect"]] == \
                measure.vgg_stage_list(SKELETAL)
    elif tool == "pyramid_time":
        assert last["rows_equal"]
        assert {"prep", "upload", "preproc", "forward", "decode", "vote",
                "readback", "forward.L0", "forward.L1"} <= set(last["stages"])
        assert last["stages"]["forward"]["device_ms"] is None
    else:
        assert set(last["stages"]) == {
            "upload", "preproc", "forward", "targets", "backward", "reduce",
            "update", "metrics"}
        assert len(last["metrics"]) == last["iterations"] == 4
        # every step starts from the initial weights: one loss throughout
        assert len({json.dumps(m) for m in last["metrics"]}) == 1


def test_tools_refuse_what_the_port_does_not_carry(skeletal):
    with pytest.raises(SystemExit, match="band"):
        layer_time.main(["--size", "64", "96", "--mask-mode", "band_margin",
                         "--device", "cpu"])
    with pytest.raises(SystemExit, match="float32 only"):
        benchmark.main(["--train", "--bf16", "--device", "cpu"])


@pytest.mark.parametrize("dd", [True, False])
def test_layer_table_covers_every_scope(dd, skeletal):
    """One row per scope of the forward, in the order it opens them, each
    opened (once per shard) by a forward and by a forward+backward."""
    spec = tdm.ModelSpec(different_dilation=dd)
    params = tdm.init_params(torch.Generator().manual_seed(0), spec)
    model = tdm.Detector(params, spec, "cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 64, 96, 3)
                         .astype(np.float32))
    names = tdm.scope_names(spec)
    assert "pallas_stem" not in names and names[:2] == ["conv1_1", "pool1"]
    assert names[-1] == ("head_4" if dd else "bbox_pred")
    for train in (False, True):
        res = layer_time.per_layer(model, x, (32, 64), train=train)
        assert list(res["rows"]) == names
        assert all(r["calls"] == 1 for r in res["rows"].values())
    costs = layer_time.layer_costs(spec, 64, 96)
    assert set(costs) == set(names)
    total = sum(c["gflop"] for c in costs.values())
    assert total == pytest.approx(tdm.forward_flops(spec, 64, 96) / 1e9)


def test_full_net_scopes_and_costs():
    """At full width the fused stem is one scope ("pallas_stem", JAX's
    name) and the costs sum to ``forward_flops``."""
    spec = tdm.ModelSpec()
    names = tdm.scope_names(spec)
    assert names[:2] == ["pallas_stem", "conv2_1"]
    assert "pool1" not in names and "pool4" in names
    costs = layer_time.layer_costs(spec, 128, 160)
    assert set(costs) == set(names)
    assert sum(c["gflop"] for c in costs.values()) == pytest.approx(
        tdm.forward_flops(spec, 128, 160) / 1e9)
    assert costs["pallas_stem"]["bound_by"] == "operations"


@pytest.mark.parametrize("precision", ["float32", "bfloat16", "int8"])
def test_scopes_change_no_bit(precision, skeletal):
    """The forward under a recording profiler (every scope open) equals
    the forward without one, to the bit."""
    spec = tdm.ModelSpec()
    params = tdm.init_params(torch.Generator().manual_seed(1), spec)
    model = tdm.Detector(params, spec, "cpu")
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 64, 96, 3)
                         .astype(np.float32) * 30)
    qstate = None
    if precision == "int8":
        qstate = tdm.make_qstate(model.tree(), spec, tdm.collect_int8_amax(
            model, [x[:1]]))
    with torch.inference_mode():
        plain = model(x, (48, 80), precision, qstate)
        tr, scoped = measure.trace(lambda: model(x, (48, 80), precision,
                                                 qstate), "cpu", warmup=0)
    assert set(tr.scope_calls(set(tdm.scope_names(spec)).__contains__)) \
        == set(tdm.scope_names(spec))
    for k in plain:
        assert torch.equal(plain[k], scoped[k])


def test_instrumented_detect_equals_plain(skeletal):
    from smallhardface_tpu_torch.config import CONFIG_DIR, cfg_from_file
    from smallhardface_tpu_torch.detect import TorchDetector
    from smallhardface_tpu_torch.utils.timer import no_stages
    import os
    cfg_from_file(os.path.join(CONFIG_DIR, "smallhardface.toml"))
    tcfg.TEST.SCALES = [50, 90]
    spec = tdm.build_spec(tcfg)
    params = tdm.init_params(torch.Generator().manual_seed(3), spec)
    for k in tdm.ANCHOR_SCALES:
        params[f"cls_score_{k}"]["b"] = torch.tensor([1.2, -1.2])
    det = TorchDetector(params, spec, "cpu")
    im = pyramid_time.synthetic_image(96, 128)
    plain = det.detect(im)[0][0]
    assert len(plain) > 1
    res = pyramid_time.split_detect(det, im, reps=2)
    assert res["rows_equal"] and res["dets"] == len(plain)
    assert det.stages is no_stages
    hook = measure.Stages()
    det.stages = hook
    assert np.array_equal(det.detect(im)[0][0], plain)
    assert hook.calls["forward.L0"] == hook.calls["forward.L1"] == 1
    assert hook.calls["decode"] == 1 and hook.calls["readback"] == 1


def test_train_time_step_equals_a_plain_step(skeletal):
    """``train_time.Step`` under a stage hook gives a plain iteration's
    metrics and weights, to the bit, at iter_size 2."""
    from smallhardface_tpu_torch.config import CONFIG_DIR, cfg_from_file
    from smallhardface_tpu_torch.train import targets
    import os
    cfg_from_file(os.path.join(CONFIG_DIR, "smallhardface.toml"))
    samples = train_time.make_samples(96, 128, 2)
    step = train_time.Step(tcfg, "cpu", samples, stages=measure.Stages())
    got = [step(it) for it in range(2)]

    spec = tdm.build_spec(tcfg)
    lr_mults, decay_mults = tdm.param_multipliers(spec)
    model = tdm.Detector(tdm.init_params(torch.Generator().manual_seed(3),
                                         spec), spec, "cpu", trainable=True)
    params = model.tree()
    state = solver.init_state({n: {k: v.detach() for k, v in leaf.items()}
                               for n, leaf in params.items()}, "SGD")
    arrays, _, bucket = ttl.assemble_batch(samples, 2, list(
        tcfg.TPU.MAX_GT_BUCKETS))
    batch = dict(arrays)
    for k in ("data", "gt", "gt_mask"):
        batch[k] = torch.from_numpy(arrays[k])
    loss_fn = ttl.LossFn(targets.from_cfg(tcfg), "cpu")
    for it in range(2):
        m = ttl.grad_step(model, loss_fn, batch, bucket[2:4], 2)
        solver.apply_update(
            params, {n: {k: v.grad for k, v in leaf.items()}
                     for n, leaf in params.items()}, state,
            solver_type="SGD", rate=solver.learning_rate(it, tcfg),
            lr_mults=lr_mults, decay_mults=decay_mults,
            weight_decay=float(tcfg.TRAIN.WEIGHT_DECAY),
            momentum=float(tcfg.TRAIN.MOMENTUM), iteration=it)
        np.testing.assert_array_equal(got[it], m.numpy())
    for name, leaf in params.items():
        for k, v in leaf.items():
            assert torch.equal(v, step.params[name][k]), (name, k)
    assert step.stages.calls["backward"] == 4


def _hand_trace():
    """A Trace as the profiler would give it: ranges a (0-10, holding b at
    2-5) and c (20-30) on the host, launches at 3 (in b), 7 (in a), 25 (in
    c) and 40 (outside), one device event per launch, and one event with
    no launch seen; autograd: a forward op of seq 5 in b, its node at
    50-60 launching at 55."""
    tr = measure.Trace.__new__(measure.Trace)
    tr.on_card, tr.lost = True, 0
    tr.ranges = [("a", 0.0, 10.0, 1), ("b", 2.0, 5.0, 1),
                 ("c", 20.0, 30.0, 1), ("stage:x", 0.0, 100.0, 1)]
    tr.ops = [("aten::conv2d", 3.0, 4.0, 1, 5),
              ("autograd::engine::evaluate_function: X", 50.0, 60.0, 2, 5)]
    tr.device = [("k1", 100.0, 110.0, 3.0, 1), ("k2", 105.0, 125.0, 7.0, 1),
                 ("k3", 200.0, 201.0, 25.0, 1), ("k4", 300.0, 302.0, 40.0, 1),
                 ("k5", 400.0, 404.0, None, None),
                 ("k6", 500.0, 508.0, 55.0, 2)]
    return tr


def test_trace_groups_by_the_innermost_open_range():
    tr = _hand_trace()
    g = tr.group(lambda n: n in ("a", "b", "c"))
    assert g["b"] == {"device_ms": 0.01, "launches": 1}
    assert g["a"] == {"device_ms": 0.02, "launches": 1}
    assert g["c"] == {"device_ms": 0.001, "launches": 1}
    assert g["(outside)"]["launches"] == 3          # k4, k5 and k6
    assert sum(v["launches"] for v in g.values()) == len(tr.device)
    s = tr.group(lambda n: n.startswith(measure.STAGE_PREFIX),
                 key=lambda n: n[len(measure.STAGE_PREFIX):])
    assert s["x"]["launches"] == 5 and s["(outside)"]["launches"] == 1
    assert tr.backward_by_scope(lambda n: n in ("a", "b", "c")) == {
        "b": {"device_ms": 0.008, "launches": 1}}
    assert tr.busy_ms() == pytest.approx((25 + 1 + 2 + 4 + 8) / 1e3)
    assert tr.device_ms() == pytest.approx((10 + 20 + 1 + 2 + 4 + 8) / 1e3)


def test_stage_table_sums_levels_into_stages():
    hook = measure.Stages()
    hook.host_s.update({"x.L0": 0.002, "x.L1": 0.004, "x": 0.001,
                        "y": 0.003})
    tr = measure.Trace.__new__(measure.Trace)
    tr.on_card, tr.lost = True, 0
    tr.ranges = [("stage:x.L0", 0.0, 1.0, 1), ("stage:x.L1", 2.0, 3.0, 1),
                 ("stage:y", 4.0, 5.0, 1)]
    tr.ops = []
    tr.device = [("k", 10.0, 12.0, 0.5, 1), ("k", 12.0, 16.0, 2.5, 1),
                 ("k", 16.0, 17.0, 2.6, 1), ("k", 20.0, 21.0, 4.5, 1)]
    out = measure.stage_table(hook, tr, wall_ms=0.01, n_host=2)
    x = out["stages"]["x"]
    assert x["host_ms"] == pytest.approx(3.5)
    assert x["launches"] == 3 and x["device_ms"] == pytest.approx(0.007)
    assert x["host_us_per_launch"] == pytest.approx(3500 / 3)
    assert out["stages"]["x.L1"]["launches"] == 2
    assert out["device_busy_ms"] == pytest.approx(0.008)
    assert out["idle_share"] == pytest.approx(0.2)
    cpu = measure.stage_table(hook, None, wall_ms=1.0)
    assert cpu["idle_share"] is None and cpu["stages"]["y"]["launches"] is None


def test_stage_table_folds_waits_into_their_stage():
    """A "wait_<stage>" span counts in its stage: its host ms as the
    stage's wait ms (self ms the rest), its copy's device ms and launch in
    the stage's; a wait span outside every stage is a row of its own,
    all wait."""
    hook = measure.Stages()
    hook.host_s.update({"x.L0": 0.004, "wait_x.L0": 0.003, "x": 0.002,
                        "wait_x": 0.001, "wait_top": 0.0005})
    tr = measure.Trace.__new__(measure.Trace)
    tr.on_card, tr.lost = True, 0
    tr.ranges = [("stage:x.L0", 0.0, 4.0, 1), ("stage:wait_x.L0", 1.0, 3.0,
                                                1),
                 ("stage:wait_top", 5.0, 6.0, 1)]
    tr.ops = []
    tr.device = [("k", 10.0, 12.0, 0.5, 1), ("memcpy", 12.0, 13.0, 2.0, 1),
                 ("memcpy", 13.0, 14.0, 5.5, 1)]
    rows = measure.stage_table(hook, tr, wall_ms=0.01)["stages"]
    assert set(rows) == {"x", "x.L0", "wait_top"}
    assert rows["x.L0"]["host_ms"] == pytest.approx(4.0)
    assert rows["x.L0"]["wait_ms"] == pytest.approx(3.0)
    assert rows["x.L0"]["self_ms"] == pytest.approx(1.0)
    assert rows["x.L0"]["launches"] == 2
    assert rows["x.L0"]["device_ms"] == pytest.approx(0.003)
    assert rows["x"]["host_ms"] == pytest.approx(6.0)
    assert rows["x"]["wait_ms"] == pytest.approx(4.0)
    assert rows["wait_top"]["host_ms"] == rows["wait_top"]["wait_ms"] == \
        pytest.approx(0.5)
    assert rows["wait_top"]["self_ms"] == 0.0


def _fake_prof():
    """A finished profiler run shaped like one the card gave (torch
    2.11+cu128: a record_function "conv3_1" around a matmul and an add,
    its GPU user annotation spanning both kernels and the gap between),
    with a forward operator's sequence number, and one launch whose
    device event is missing."""
    from types import SimpleNamespace as NS
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(dev, name, ident, a, b, ann=False, seq=-1, thread=1):
        return NS(device_type=dev, name=name, id=ident, is_user_annotation=ann,
                  time_range=NS(start=a, end=b), thread=thread,
                  sequence_nr=seq)
    events = [
        ev(cpu, "conv3_1", 1, 392.1, 14030.1, ann=True),
        ev(cpu, "aten::matmul", 2, 455.1, 2356.8, seq=7),
        ev(cpu, "cuLaunchKernel", 20, 2312.1, 2346.0),
        ev(cuda, "conv3_1", 1, 2342.5, 13866.9, ann=True),
        ev(cuda, "cutlass_80_simt_sgemm", 20, 2342.5, 2683.8),
        ev(cpu, "cudaLaunchKernel", 29, 2551.5, 13862.2),
        ev(cuda, "vectorized_elementwise_kernel", 29, 13858.4, 13866.9),
        ev(cpu, "cudaLaunchKernel", 31, 13863.0, 13864.0),
        ev(cpu, "cudaDeviceSynchronize", 35, 14116.8, 14129.3)]
    return NS(events=lambda: events)


def test_trace_and_busy_time_leave_user_annotations_out():
    from smallhardface_tpu_torch.utils.timer import device_busy_s
    prof = _fake_prof()
    tr = measure.Trace(prof)
    assert [d[0] for d in tr.device] == ["cutlass_80_simt_sgemm",
                                         "vectorized_elementwise_kernel"]
    assert [d[3] for d in tr.device] == [2312.1, 2551.5]
    assert tr.group(lambda n: n == "conv3_1") == {
        "conv3_1": {"device_ms": pytest.approx(0.3498), "launches": 2}}
    assert tr.busy_ms() == pytest.approx(0.3498)
    assert device_busy_s(prof) == pytest.approx(0.3498e-3)
    # a launch the profiler reported no device event for
    assert tr.lost == 1 and tr.on_card
