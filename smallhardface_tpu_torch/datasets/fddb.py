"""FDDB dataset (reference lib/datasets/fddb.py).
The port's copy of ``smallhardface_tpu/datasets/fddb.py``.

Test-only: image list from FDDB-folds/val.txt; evaluation writes the
rectangle detection file and shells out to the official `evaluate` binary
when present, parsing DiscROC/ContROC for TPR at 1000 false positives.
"""

from __future__ import annotations

import logging
import os
import subprocess

import numpy as np

from smallhardface_tpu_torch.config import cfg
from smallhardface_tpu_torch.datasets.imdb import imdb
from smallhardface_tpu_torch.utils.tensorboard import tb

logger = logging.getLogger(__name__)

_FDDB_RECT = 0

_FDDB_EVAL_COMMAND = (
    "/{root}/evaluation/evaluate -a /{root}/FDDB-folds/val_gt.txt "
    "-i /{root}/ -l /{root}/FDDB-folds/val.txt -d {detect} -f {format} "
    "-r {output_dir}")


class fddb(imdb):
    def __init__(self, split):
        super().__init__("fddb_" + split)
        self._split = split
        self._dataset_path = cfg.DATA_DIR
        self._imgs_path = cfg.DATA_DIR
        list_file = os.path.join(self._dataset_path,
                                 f"FDDB-folds/{split}.txt")
        with open(list_file) as f:
            file_list = f.readlines()
        self._image_paths = [x.strip() + ".jpg" for x in file_list]
        self._image_index = list(range(len(self._image_paths)))
        self._classes = ["bg", "face"]

    def image_path_at(self, i):
        path = os.path.join(self._imgs_path,
                            self._image_paths[self._image_index[i]])
        assert os.path.exists(path), f"Path does not exist: {path}"
        return path

    def gt_roidb(self):
        raise NotImplementedError("Not supported yet!")

    def write_detections_rect(self, all_boxes, output_dir="./output/"):
        logger.info("Writing the detections to text files: %s...", output_dir)
        with open(os.path.join(output_dir, "detection_rect.txt"), "w") as f:
            for i, img_path in enumerate(self._image_paths):
                img_name = os.path.splitext(img_path)[0]
                f.write(f"{img_name}\n")
                dets = all_boxes[1][i]
                f.write(f"{dets.shape[0]}\n")
                for j in range(dets.shape[0]):
                    f.write("{:.3f} {:.3f} {:.3f} {:.3f} {:.10f}\n".format(
                        dets[j][0], dets[j][1],
                        dets[j][2] - dets[j][0] + 1,
                        dets[j][3] - dets[j][1] + 1, dets[j][4]))
        logger.info("Done!")

    def evaluate_detections(self, all_boxes, output_dir="./output/",
                            method_name="smallhard", step=0):
        self.write_detections_rect(all_boxes, output_dir)
        eval_bin = os.path.join(cfg.DATA_DIR, "evaluation", "evaluate")
        if not os.path.exists(eval_bin):
            return ("FDDB detections written to {} (official `evaluate` "
                    "binary not found; skipping ROC)".format(output_dir))
        proc = subprocess.Popen(
            _FDDB_EVAL_COMMAND.format(
                root=cfg.DATA_DIR,
                detect=os.path.join(output_dir, "detection_rect.txt"),
                format=_FDDB_RECT,
                output_dir=output_dir + "/rect_"),
            shell=True, stdout=subprocess.PIPE)
        proc.wait()

        def tpr_at_1000(path):
            with open(path) as f:
                res = np.array([ln.split() for ln in f], dtype=np.float64)
            return res[np.where(res[:, 1] < 1000)[0][0], 0]

        rect_disc = tpr_at_1000(os.path.join(output_dir, "rect_DiscROC.txt"))
        rect_cont = tpr_at_1000(os.path.join(output_dir, "rect_ContROC.txt"))
        tb.sess.add_scalar_value("rect_disc_at_1000", rect_disc, step=step)
        tb.sess.add_scalar_value("rect_cont_at_1000", rect_cont, step=step)
        return ("rect_disc_at_1000: {:.4f}, rect_cont_at_1000: {:.4f}"
                .format(rect_disc, rect_cont))
