"""Command line of the PyTorch port, with the argument schema of the repo's
``train_test.py`` (:34-46), the JAX package's command line:

  python -m smallhardface_tpu_torch --train {true,false} --test {true,false}
      --conf <toml> [--device {cuda,cpu}] --amend KEY VALUE [KEY VALUE ...]

``--train true`` trains on ``TRAIN.DB`` (``get_imdb``, the flipped and
filtered roidb, ``train_net``) and points ``TEST.MODEL`` at the run's
``final.npz``; ``--test true`` then evaluates on ``TEST.DB`` (``test_net``:
``detections.pkl`` unless ``TEST.NO_CACHE``, the dataset's evaluator, and
for WIDER ``result.tar.gz``), or runs the demo under ``TEST.DEMO.ENABLE``.
Each phase writes into output/<EXP_DIR>/<imdb>/<NAME>_<time>/ its
``cfgs.txt`` and ``stderr.log`` (the run's log; it also goes to the
console). ``--device cuda`` (the default) runs on the CUDA card and fails
without one; ``--device cpu`` runs on the CPU.

Under ``torchrun`` (``python -m torch.distributed.run --nproc_per_node N
-m smallhardface_tpu_torch ...``) each of the N processes is a rank of a
process group (``parallel.dist.init_distributed``, joined before anything
touches the card): NCCL between cards, gloo on the CPU or with
``SHF_DIST_BACKEND=gloo`` for ranks that share a card. Training is data
parallel and evaluation splits the images; every rank writes under the one
run directory rank 0 names (its ``LOG.TIME`` is broadcast), rank 0 alone
writes the snapshots, ``final.npz``, ``cfgs.txt``, ``detections.pkl`` and
the evaluation, and ``stderr.log`` is rank 0's log while rank r > 0 keeps
``stderr.rank{r}.log``. With ``--amend TPU.SPATIAL_DEVICES k`` each rank
trains and evaluates over a unit of k cards, [LOCAL_RANK·k, LOCAL_RANK·k +
k), its first card current; one process trains over the first k.

``TRAIN.AUTO_RESUME = N > 0`` survives up to N sticky CUDA faults
(``utils.faults.device_fault``: an illegal address, a device-side assert,
an ECC error; not running out of memory): the dead CUDA context cannot be
revived in-process, so the command line re-executes itself
(``os.execve``) with ``TRAIN.RESUME`` set to the newest snapshot of the
faulted run, or with ``--train false`` and ``TEST.MODEL`` after a fault
in the evaluation. The relaunch opens a run directory of its own; the
relaunches left ride ``SHF_AUTO_RESUME_LEFT`` through the exec. It is
built from ``sys.orig_argv``, so ``python -m smallhardface_tpu_torch`` and
a wrapper script both come back as they started; ``main(argv)`` called
with an explicit ``argv`` from inside another program has no command
line of its own and re-raises. One process only: under
``torch.distributed`` with more than one rank the fault re-raises.
During training SIGINT writes a snapshot and stops, and SIGHUP writes a
snapshot at the next iteration (``train.train_loop.train_net``).
"""

import argparse
import datetime
import glob
import logging
import os
import os.path as osp
import re
import sys

import numpy as np
import torch

from smallhardface_tpu_torch.config import (
    cfg, cfg_dump, cfg_from_file, cfg_from_list, cfg_print, cfg_table,
    get_output_dir)
from smallhardface_tpu_torch.parallel import dist as pdist
from smallhardface_tpu_torch.utils.faults import device_fault as _device_fault
from smallhardface_tpu_torch.utils.tensorboard import Tensorboard, tb

# the milliseconds zero-padded, so that ",005" reads as 5 ms (parse_log
# reads the JAX command line's unpadded ",5" as 500 ms)
LOG_FORMAT = ("%(asctime)s,%(msecs)03d %(levelname)-8s "
              "[%(filename)s:%(lineno)d] %(message)s")
LOG_DATEFMT = "%m-%d-%Y:%H:%M:%S"

logger = logging.getLogger(__name__)


def parser(argv=None):
    p = argparse.ArgumentParser(
        "Train and test", description="Give settings")
    p.add_argument("--train", dest="train", help="do training",
                   default="true")
    p.add_argument("--test", dest="test", help="do testing", default="true")
    p.add_argument("--conf", dest="conf_file",
                   help="provide configure file", default="")
    p.add_argument("--device", dest="device", choices=("cuda", "cpu"),
                   default="cuda", help="where the network runs")
    p.add_argument("--amend", dest="set_cfgs", help="provide amend cfgs",
                   default=None, nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _log_to(output_dir, handlers):
    """Send the run's log into ``<output_dir>/stderr.log`` as well (rank
    r > 0 of a process group: ``stderr.rank{r}.log``)."""
    rank = pdist.rank()
    name = "stderr.log" if rank == 0 else f"stderr.rank{rank}.log"
    handler = logging.FileHandler(osp.join(output_dir, name))
    handler.setFormatter(logging.Formatter(LOG_FORMAT, LOG_DATEFMT))
    logging.getLogger().addHandler(handler)
    handlers.append(handler)


def _auto_resume_budget(exc):
    """Relaunches left for this fault, or None when none applies: the
    budget is spent, the error is not a device fault, or the process has
    peers (one process re-executing alone would leave them waiting in
    their next collective)."""
    left_env = os.environ.get("SHF_AUTO_RESUME_LEFT")
    left = (int(left_env) if left_env is not None
            else int(cfg.TRAIN.AUTO_RESUME))
    if left <= 0 or not _device_fault(exc):
        return None
    if (torch.distributed.is_available()
            and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        return None
    return left


def _own_command_line():
    """This process's command line, the interpreter first, and the index of
    its first argument of the program. ``sys.orig_argv`` keeps ``-m
    smallhardface_tpu_torch`` (``sys.argv[0]`` is then the path of this
    file, which run as a script would miss the package's imports) and the
    interpreter's own options."""
    cmd = [sys.executable] + list(sys.orig_argv[1:])
    return cmd, len(cmd) - (len(sys.argv) - 1)


def _exec_relaunch(argv, left):
    env = dict(os.environ)
    env["SHF_AUTO_RESUME_LEFT"] = str(left)
    # execve runs no finally block and no atexit hook: flush and close the
    # log handlers (the run's stderr.log) and flush the standard streams
    logging.shutdown()
    sys.stdout.flush()
    sys.stderr.flush()
    os.execve(sys.executable, argv, env)


def _no_command_line(exc):
    """A relaunch was due but main() was given its argv by another program:
    re-raise ``exc`` with a note that says so."""
    note = ("TRAIN.AUTO_RESUME: no relaunch, since main() was called with an "
            "explicit argv from inside another program and this process has "
            "no command line of its own to run again")
    logger.error(note)
    exc.add_note(note)
    raise exc


def _maybe_auto_resume_train(exc, output_dir, own_command_line=True):
    """On a device fault during training, re-execute this command line with
    TRAIN.RESUME pointing at the newest snapshot of the faulted run.
    Re-raises ``exc`` when no relaunch applies."""
    left = _auto_resume_budget(exc)
    if left is None:
        raise exc
    if not own_command_line:
        _no_command_line(exc)
    snaps = []
    for p in glob.glob(osp.join(output_dir, "*_iter_*.npz")):
        m = re.search(r"_iter_(\d+)\.npz$", p)
        if m:
            snaps.append((int(m.group(1)), p))
    latest = max(snaps)[1] if snaps else ""
    logger.exception(
        "Device fault during training (%d auto-resume relaunch(es) left); "
        "relaunching from %s", left - 1, latest or "scratch")
    argv, start = _own_command_line()
    if "--amend" not in argv[start:]:
        argv.append("--amend")
    if latest:
        # cfg_from_list applies pairs in order, so this pair overrides any
        # TRAIN.RESUME of the command line or of an earlier relaunch
        argv += ["TRAIN.RESUME", latest]
    _exec_relaunch(argv, left - 1)


def _argv_train_false(argv, start=2):
    """``argv`` (the interpreter first, the program's arguments from
    ``start``) with training off, whether it spelled ``--train true`` or
    ``--train=true`` (the =-form would otherwise win in argparse over an
    inserted pair and train again from scratch). Everything from --amend
    on is argparse REMAINDER and is never touched."""
    argv = list(argv)
    limit = (argv.index("--amend", start) if "--amend" in argv[start:]
             else len(argv))
    eq_forms = [i for i in range(start, limit)
                if argv[i].startswith("--train=")]
    for i in eq_forms:
        argv[i] = "--train=false"
    if "--train" in argv[start:limit]:
        argv[argv.index("--train", start) + 1] = "false"
    elif not eq_forms:
        # before any --amend: argparse's REMAINDER would swallow it
        argv[start:start] = ["--train", "false"]
    return argv


def _maybe_auto_resume_test(exc, own_command_line=True):
    """On a device fault during evaluation, re-execute with --train false
    (the trained weights are on disk; TEST.MODEL points there) and redo
    only the evaluation. Re-raises ``exc`` when no relaunch applies."""
    left = _auto_resume_budget(exc)
    if left is None:
        raise exc
    if not own_command_line:
        _no_command_line(exc)
    cmd, start = _own_command_line()
    argv = _argv_train_false(cmd, start)
    if "--amend" not in argv[start:]:
        argv.append("--amend")
    if cfg.TEST.MODEL:
        argv += ["TEST.MODEL", str(cfg.TEST.MODEL)]
    logger.exception(
        "Device fault during evaluation (%d auto-resume relaunch(es) left); "
        "relaunching eval with model %s", left - 1,
        cfg.TEST.MODEL or "<config default>")
    _exec_relaunch(argv, left - 1)


def main(argv=None):
    """Run the command line; ``argv`` as sys.argv[1:] when None. A caller
    that passes ``argv`` gets no relaunch after a device fault."""
    logging.basicConfig(
        format=LOG_FORMAT, datefmt=LOG_DATEFMT,
        level=(logging.DEBUG if os.environ.get("DEBUG") == "1"
               else logging.INFO))
    args = parser(argv)
    if args.conf_file:
        cfg_from_file(args.conf_file)
    # train/test runs normally don't want stale caches; --amend can override
    cfg.TEST.NO_CACHE = True
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)
    cfg.LOG.CMD = " ".join(sys.argv)
    np.random.seed(int(cfg.RNG_SEED))
    # the process group (under a launcher) before anything touches the
    # card; left on the way out, whether the run ends or raises
    owns_group = not pdist.active()
    device = pdist.init_distributed(args.device,
                                    spatial=int(cfg.TPU.SPATIAL_DEVICES))
    handlers = []
    own_command_line = argv is None
    try:
        # rank 0's clock names the run directory of every rank
        cfg.LOG.TIME = pdist.broadcast_object(
            datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S"))
        if cfg.TENSORBOARD.ENABLE:
            tb.client = Tensorboard(hostname=cfg.TENSORBOARD.HOSTNAME,
                                    port=cfg.TENSORBOARD.PORT)
            tb.sess = tb.client.create_experiment(
                cfg.NAME + "_" + cfg.LOG.TIME)
        if args.train in ("true", "True"):
            _train(device, handlers, own_command_line)
        if args.test in ("true", "True"):
            return _test(device, handlers, own_command_line)
        return None
    finally:
        for handler in handlers:
            logging.getLogger().removeHandler(handler)
            handler.close()
        if owns_group:
            pdist.shutdown()


def _train(device, handlers, own_command_line):
    from smallhardface_tpu_torch.datasets.factory import get_imdb
    from smallhardface_tpu_torch.train.train_loop import (
        get_training_roidb, train_net)

    imdb = get_imdb(cfg.TRAIN.DB)
    roidb = get_training_roidb(imdb)
    output_dir = get_output_dir(imdb.name, cfg.NAME + "_" + cfg.LOG.TIME)
    _log_to(output_dir, handlers)
    cfg_print(cfg)
    if pdist.rank() == 0:
        with open(osp.join(output_dir, "cfgs.txt"), "w") as f:
            cfg_dump({i: cfg[i] for i in cfg if i != "TEST"}, f)
    tb.sess.add_text(
        "train_cfg", cfg_table({i: cfg[i] for i in cfg if i != "TEST"}))
    try:
        train_net(roidb, output_dir=output_dir,
                  pretrained_model=cfg.TRAIN.PRETRAINED,
                  max_iter=cfg.TRAIN.ITERS, device=device)
    except Exception as e:       # filtered inside: execs away or re-raises
        _maybe_auto_resume_train(e, output_dir, own_command_line)
    # the trained weights go into the following test (train_net's last
    # barrier: every rank sees the file rank 0 wrote)
    cfg.TEST.MODEL = osp.join(output_dir, "final.npz")


def _test(device, handlers, own_command_line):
    from smallhardface_tpu_torch.datasets.factory import get_imdb
    from smallhardface_tpu_torch.models import retinaface
    from smallhardface_tpu_torch.test_runner import test_net

    if cfg.TEST.DEMO.ENABLE:
        imdb = None
        output_dir = get_output_dir("demo", cfg.NAME + "_" + cfg.LOG.TIME)
    else:
        imdb = get_imdb(cfg.TEST.DB)
        output_dir = get_output_dir(imdb.name, cfg.NAME + "_" + cfg.LOG.TIME)
    _log_to(output_dir, handlers)
    if pdist.rank() == 0:
        with open(osp.join(output_dir, "cfgs.txt"), "w") as f:
            cfg_dump({i: cfg[i] for i in cfg if i != "TRAIN"}, f)
    tb.sess.add_text(
        "test_cfg", cfg_table({i: cfg[i] for i in cfg if i != "TRAIN"}))
    # the detection cut: lib/test.py's 0.05, or RetinaFace's
    # test_widerface.py's 0.02
    thresh = (retinaface.CONFIDENCE_THRESHOLD
              if str(cfg.MODEL.ARCH) == retinaface.ARCH else 0.05)
    try:
        return test_net(imdb, output_dir, thresh=thresh,
                        no_cache=cfg.TEST.NO_CACHE, device=device)
    except Exception as e:       # filtered inside: execs away or re-raises
        _maybe_auto_resume_test(e, own_command_line)


if __name__ == "__main__":
    main()
