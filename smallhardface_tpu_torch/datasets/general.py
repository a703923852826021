"""Directory-walking detection-only dataset
(reference lib/datasets/general.py): every *.png / *.jpg
under DATA_DIR, detections written per image, no labels.
The port's copy of ``smallhardface_tpu/datasets/general.py``.
"""

from __future__ import annotations

import logging
import os

from smallhardface_tpu_torch.config import cfg
from smallhardface_tpu_torch.datasets.imdb import imdb

logger = logging.getLogger(__name__)


class general(imdb):
    def __init__(self, split):
        super().__init__("general_" + split)
        self._extension = split
        self._imgs_path = cfg.DATA_DIR
        self._image_paths = []
        for root, _dirs, files in os.walk(cfg.DATA_DIR):
            for fname in files:
                if fname.endswith(f".{split}"):
                    self._image_paths.append(os.path.join(root, fname))
        self._image_index = list(range(len(self._image_paths)))
        self._classes = ["bg", "face"]

    def image_path_at(self, i):
        path = os.path.join(self._imgs_path,
                            self._image_paths[self._image_index[i]])
        assert os.path.exists(path), f"Path does not exist: {path}"
        return path

    def gt_roidb(self):
        raise NotImplementedError("Not supported yet!")

    def write_detections(self, all_boxes, output_dir="./output/"):
        logger.info("Writing the detections to text files: %s...", output_dir)
        for i, img_path in enumerate(self._image_paths):
            img_name = os.path.basename(img_path)
            img_dir = img_path[:img_path.find(img_name) - 1]
            if img_dir.startswith("/"):
                img_dir = img_dir[1:]
            res_dir = os.path.join(output_dir, img_dir)
            os.makedirs(res_dir, exist_ok=True)
            txt_fname = os.path.join(
                res_dir, img_name.replace(self._extension, "txt"))
            with open(txt_fname, "w") as f:
                f.write(img_path + "\n")
                f.write(str(len(all_boxes[1][i])) + "\n")
                for det in all_boxes[1][i]:
                    f.write("%d %d %d %d %g \n" % (
                        int(det[0]), int(det[1]),
                        int(det[2]) - int(det[0]),
                        int(det[3]) - int(det[1]), det[4]))
        logger.info("Done!")

    def evaluate_detections(self, all_boxes, output_dir="./output/",
                            method_name="smallhard", step=0):
        self.write_detections(all_boxes, output_dir)
        return f"Detection results wrote to {output_dir}"
