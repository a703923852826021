"""What a run refuses to do: print a result beside JAX or the JAX package,
without a card, or without the port in its checkout."""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _py(code, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_guard_compares_whole_top_level_names():
    """The port's name begins with the JAX package's: only a whole
    top-level name counts."""
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "from portbench import common\n"
        "import smallhardface_tpu_torch.detect\n"
        "assert common.forbidden_modules() == [], common.forbidden_modules()\n"
        "sys.modules['smallhardface_tpu.fake'] = object()\n"
        "assert common.forbidden_modules() == ['smallhardface_tpu']\n"
        "sys.modules['jax'] = object()\n"
        "assert common.forbidden_modules() == ['jax', 'smallhardface_tpu']\n")
    r = _py(code)
    assert r.returncode == 0, r.stderr


def test_portbench_and_port_load_no_jax():
    """Everything the harness and its drivers load leaves JAX out."""
    code = (
        "import sys, glob, os; sys.path.insert(0, '.')\n"
        "from portbench import common, run, evalcore, control\n"
        "from portbench.reference import net, detect, train, compare\n"
        "from portbench.yardstick import trace, counts\n"
        "for p in glob.glob('portbench/drivers/*.py') + "
        "glob.glob('portbench/metrics/*.py'):\n"
        "    common.load_module(p, 'm_' + os.path.basename(p)[:-3]"
        ".replace('.', '_'))\n"
        "import smallhardface_tpu_torch.detect, "
        "smallhardface_tpu_torch.train.train_loop\n"
        "assert common.forbidden_modules() == [], common.forbidden_modules()\n"
        "print('ok')\n")
    r = _py(code)
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr


def test_reference_imports_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "from portbench.reference import net, detect, train, compare, arch\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('smallhardface_tpu_torch', 'smallhardface_tpu', 'jax'))\n"
        "assert not bad, bad\n")
    r = _py(code)
    assert r.returncode == 0, r.stderr


def test_no_card_no_result(tmp_path):
    """Without a card the run exits with 2 and prints nothing."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "fp32-wider-eval", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 2 and r.stdout == ""


def test_bare_checkout_no_result(tmp_path):
    """A folder with only BENCHMARK.json and portbench/ gives no result."""
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    if os.path.exists(os.path.join(ROOT, "BENCHMARK.json")):
        shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "fp32-wider-eval", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""
