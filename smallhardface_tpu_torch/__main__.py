"""Command line of the PyTorch port, with the argument schema of the repo's
``train_test.py`` (:34-46):

  python -m smallhardface_tpu_torch --train false --test true
      --conf <toml> --amend KEY VALUE [KEY VALUE ...]

Runs the ``--test`` branch in demo mode (``TEST.DEMO.ENABLE True``): one
image through the full pyramid, boxes drawn into
output/<EXP_DIR>/demo/<NAME>_<time>/demo_res.jpg. The network runs on the
first CUDA card when there is one, else on the CPU. Training and dataset
evaluation are not ported yet and raise.
"""

import argparse
import datetime
import logging
import os
import os.path as osp
import sys

import numpy as np
import torch

from smallhardface_tpu.config import (
    cfg, cfg_dump, cfg_from_file, cfg_from_list, get_output_dir)


def parser(argv=None):
    p = argparse.ArgumentParser(
        "Train and test", description="Give settings")
    p.add_argument("--train", dest="train", help="do training",
                   default="true")
    p.add_argument("--test", dest="test", help="do testing", default="true")
    p.add_argument("--conf", dest="conf_file",
                   help="provide configure file", default="")
    p.add_argument("--amend", dest="set_cfgs", help="provide amend cfgs",
                   default=None, nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def main(argv=None):
    logging.basicConfig(
        format=("%(asctime)s,%(msecs)d %(levelname)-8s "
                "[%(filename)s:%(lineno)d] %(message)s"),
        datefmt="%m-%d-%Y:%H:%M:%S",
        level=(logging.DEBUG if os.environ.get("DEBUG") == "1"
               else logging.INFO))
    args = parser(argv)
    if args.conf_file:
        cfg_from_file(args.conf_file)
    cfg.TEST.NO_CACHE = True
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs)
    cfg.LOG.CMD = " ".join(sys.argv)
    cfg.LOG.TIME = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    np.random.seed(int(cfg.RNG_SEED))

    if args.train in ("true", "True"):
        raise NotImplementedError(
            "training is not ported yet (ROADMAP queue 1, 'Training on "
            "one GPU'); pass --train false")
    if args.test not in ("true", "True"):
        return None
    if not cfg.TEST.DEMO.ENABLE:
        raise NotImplementedError(
            "dataset evaluation is not ported yet (ROADMAP queue 1, "
            "'test_net and eval on every dataset config'); "
            "use --amend TEST.DEMO.ENABLE True")

    from smallhardface_tpu_torch.models import detector as detector_mod
    from smallhardface_tpu_torch.test_runner import _load_params, demo

    output_dir = get_output_dir("demo", cfg.NAME + "_" + cfg.LOG.TIME)
    with open(osp.join(output_dir, "cfgs.txt"), "w") as f:
        cfg_dump({i: cfg[i] for i in cfg if i != "TRAIN"}, f)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    spec = detector_mod.build_spec(cfg)
    return demo(_load_params(spec), spec, 0.05, output_dir, device)


if __name__ == "__main__":
    main()
