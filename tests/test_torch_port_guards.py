"""Guards of the PyTorch port: it never loads jax, and chip_smoke.py refuses
to report a result without a CUDA card or without the repository."""

import os
import pkgutil
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, cwd=REPO):
    args = ([sys.executable, "-c", code_or_args]
            if isinstance(code_or_args, str) else code_or_args)
    return subprocess.run(args, cwd=cwd, capture_output=True, text=True,
                          timeout=240)


def test_port_imports_no_jax():
    """Importing every module of smallhardface_tpu_torch loads no jax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import smallhardface_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print(len(names))\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import smallhardface_tpu_torch as p
    n = len(list(pkgutil.walk_packages(p.__path__, p.__name__ + ".")))
    assert int(proc.stdout.strip()) == n >= 12


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
