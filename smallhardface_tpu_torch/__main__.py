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

A fault during training with ``TRAIN.AUTO_RESUME > 0`` raises
NotImplementedError: the relaunch is not ported yet (ROADMAP queue 1,
'SIGINT/SIGHUP and TRAIN.AUTO_RESUME').
"""

import argparse
import datetime
import logging
import os
import os.path as osp
import sys

import numpy as np

from smallhardface_tpu_torch.config import (
    cfg, cfg_dump, cfg_from_file, cfg_from_list, cfg_print, cfg_table,
    get_output_dir)
from smallhardface_tpu_torch.utils.device import resolve_device
from smallhardface_tpu_torch.utils.tensorboard import Tensorboard, tb

LOG_FORMAT = ("%(asctime)s,%(msecs)d %(levelname)-8s "
              "[%(filename)s:%(lineno)d] %(message)s")
LOG_DATEFMT = "%m-%d-%Y:%H:%M:%S"


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
    """Send the run's log into ``<output_dir>/stderr.log`` as well."""
    handler = logging.FileHandler(osp.join(output_dir, "stderr.log"))
    handler.setFormatter(logging.Formatter(LOG_FORMAT, LOG_DATEFMT))
    logging.getLogger().addHandler(handler)
    handlers.append(handler)


def main(argv=None):
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
    cfg.LOG.TIME = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    np.random.seed(int(cfg.RNG_SEED))
    device = resolve_device(args.device)
    if cfg.TENSORBOARD.ENABLE:
        tb.client = Tensorboard(hostname=cfg.TENSORBOARD.HOSTNAME,
                                port=cfg.TENSORBOARD.PORT)
        tb.sess = tb.client.create_experiment(cfg.NAME + "_" + cfg.LOG.TIME)
    handlers = []
    try:
        if args.train in ("true", "True"):
            _train(device, handlers)
        if args.test in ("true", "True"):
            return _test(device, handlers)
        return None
    finally:
        for handler in handlers:
            logging.getLogger().removeHandler(handler)
            handler.close()


def _train(device, handlers):
    from smallhardface_tpu_torch.datasets.factory import get_imdb
    from smallhardface_tpu_torch.train.train_loop import (
        get_training_roidb, train_net)

    imdb = get_imdb(cfg.TRAIN.DB)
    roidb = get_training_roidb(imdb)
    output_dir = get_output_dir(imdb.name, cfg.NAME + "_" + cfg.LOG.TIME)
    _log_to(output_dir, handlers)
    cfg_print(cfg)
    with open(osp.join(output_dir, "cfgs.txt"), "w") as f:
        cfg_dump({i: cfg[i] for i in cfg if i != "TEST"}, f)
    tb.sess.add_text(
        "train_cfg", cfg_table({i: cfg[i] for i in cfg if i != "TEST"}))
    try:
        train_net(roidb, output_dir=output_dir,
                  pretrained_model=cfg.TRAIN.PRETRAINED,
                  max_iter=cfg.TRAIN.ITERS, device=device)
    except Exception as e:
        if int(cfg.TRAIN.AUTO_RESUME) > 0:
            raise NotImplementedError(
                "TRAIN.AUTO_RESUME > 0: relaunching after a fault is not "
                "ported yet (ROADMAP queue 1, 'SIGINT/SIGHUP and "
                "TRAIN.AUTO_RESUME')") from e
        raise
    # the trained weights go into the following test
    cfg.TEST.MODEL = osp.join(output_dir, "final.npz")


def _test(device, handlers):
    from smallhardface_tpu_torch.datasets.factory import get_imdb
    from smallhardface_tpu_torch.test_runner import test_net

    if cfg.TEST.DEMO.ENABLE:
        imdb = None
        output_dir = get_output_dir("demo", cfg.NAME + "_" + cfg.LOG.TIME)
    else:
        imdb = get_imdb(cfg.TEST.DB)
        output_dir = get_output_dir(imdb.name, cfg.NAME + "_" + cfg.LOG.TIME)
    _log_to(output_dir, handlers)
    with open(osp.join(output_dir, "cfgs.txt"), "w") as f:
        cfg_dump({i: cfg[i] for i in cfg if i != "TRAIN"}, f)
    tb.sess.add_text(
        "test_cfg", cfg_table({i: cfg[i] for i in cfg if i != "TRAIN"}))
    return test_net(imdb, output_dir, no_cache=cfg.TEST.NO_CACHE,
                    device=device)


if __name__ == "__main__":
    main()
