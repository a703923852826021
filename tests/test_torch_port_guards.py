"""Guards of the PyTorch port: it loads neither jax nor anything of the JAX
package, its entry points run on the card unless asked for the CPU, and
chip_smoke.py refuses to report a result without a CUDA card or without
the repository; and of its tests: under pytest-xdist each worker runs
torch on its share of the cores (``tests/torch_threads.py``)."""

import os
import pkgutil
import shutil
import subprocess
import sys

import pytest

import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, cwd=REPO):
    args = ([sys.executable, "-c", code_or_args]
            if isinstance(code_or_args, str) else code_or_args)
    return subprocess.run(args, cwd=cwd, capture_output=True, text=True,
                          timeout=240)


def test_port_imports_no_jax():
    """Importing every module of smallhardface_tpu_torch, then running
    chip_smoke.py's main (which stops here: no card), loads neither jax nor
    any module of the JAX package smallhardface_tpu."""
    code = (
        "import importlib, pkgutil, runpy, sys\n"
        "def foreign():\n"
        "    return sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'smallhardface_tpu'))\n"
        "import smallhardface_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not foreign(), foreign()\n"
        "smoke = runpy.run_path('chip_smoke.py')\n"
        "assert smoke['main']() != 0\n"
        "assert not foreign(), foreign()\n"
        "print(' '.join(names))\n"
        "print(len(names))\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import smallhardface_tpu_torch as p
    n = len(list(pkgutil.walk_packages(p.__path__, p.__name__ + ".")))
    *_, names, count = proc.stdout.strip().splitlines()
    assert int(count) == n >= 25
    # the evaluation slice's modules are among those imported
    for mod in ("datasets.factory", "datasets.wider", "datasets.fddb",
                "datasets.afw", "datasets.pascalface", "datasets.general",
                "evals.wider_eval", "evals.face_eval", "ops.nms_device",
                "utils.tensorboard", "test_runner", "__main__", "serve",
                "parallel", "parallel.dist", "parallel.spatial"):
        assert f"smallhardface_tpu_torch.{mod}" in names.split(), mod


def test_device_query_runs_without_jax():
    """``python -m smallhardface_tpu_torch.tools.device_query`` is a query,
    not an entry point that needs the card: it exits 0 here, and loads no
    jax."""
    proc = _run([sys.executable, "-m",
                 "smallhardface_tpu_torch.tools.device_query"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    code = (
        "import runpy, sys\n"
        "try:\n"
        "    runpy.run_module('smallhardface_tpu_torch.tools.device_query',"
        " run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'smallhardface_tpu')))\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_chip_smoke_fails_without_a_card():
    proc = _run([sys.executable, "chip_smoke.py"])
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding only chip_smoke.py it cannot run either."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run([sys.executable, "chip_smoke.py"], cwd=str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")


def test_detector_defaults_to_the_card():
    _no_card()
    from smallhardface_tpu_torch.detect import TorchDetector
    from smallhardface_tpu_torch.models import detector as tdm
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchDetector(None, tdm.ModelSpec())


def test_train_net_defaults_to_the_card(tmp_path):
    _no_card()
    from smallhardface_tpu_torch.train.train_loop import train_net
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_net([], str(tmp_path), None, 1)


def test_init_distributed_defaults_to_the_card(monkeypatch):
    """The rank's device is a card unless asked for the CPU: without one,
    init_distributed raises before it joins any process group."""
    _no_card()
    from smallhardface_tpu_torch.parallel import dist
    for k, v in dict(RANK="0", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="29500").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dist.init_distributed()
    assert not dist.active()


def test_cli_without_device_cpu_fails_here():
    _no_card()
    proc = _run([sys.executable, "-m", "smallhardface_tpu_torch", "--train",
                 "false", "--test", "true", "--amend", "TEST.DEMO.ENABLE",
                 "True"])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_service_defaults_to_the_card():
    """DetectorService and ``python -m smallhardface_tpu_torch.serve`` run
    on the card unless asked for the CPU; without one they raise."""
    _no_card()
    from smallhardface_tpu_torch.models import detector as tdm
    from smallhardface_tpu_torch.serve import DetectorService
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DetectorService(None, tdm.ModelSpec())
    proc = _run([sys.executable, "-m", "smallhardface_tpu_torch.serve",
                 "--port", "0"])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


@pytest.mark.parametrize("workers", [None, 6, 16], ids=["alone", "xdist_6",
                                                        "xdist_16"])
def test_xdist_workers_share_the_cores(workers):
    """Importing ``tests/torch_threads`` in a worker of ``workers`` xdist
    workers sets torch's intra-op threads to the cores this process may
    run on divided by the workers, at least two; outside xdist it leaves
    the count alone. This process, when xdist runs it, holds at most its
    share."""
    import torch
    env = dict(os.environ)
    env.pop("PYTEST_XDIST_WORKER_COUNT", None)
    if workers:
        env["PYTEST_XDIST_WORKER_COUNT"] = str(workers)
    code = ("import os, torch\n"
            "before = torch.get_num_threads()\n"
            "import torch_threads\n"
            "print(before, torch.get_num_threads(), "
            "len(os.sched_getaffinity(0)))\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=os.path.join(REPO, "tests"), env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    before, after, cores = map(int, proc.stdout.split())
    assert after == (max(2, cores // workers) if workers else before)
    running = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if running:
        share = max(2, len(os.sched_getaffinity(0)) // int(running))
        assert torch.get_num_threads() <= share
