"""Pascal Faces dataset, test-only
(reference lib/datasets/pascalface.py).
The port's copy of ``smallhardface_tpu/datasets/pascalface.py``.
"""

from __future__ import annotations

import logging
import os

from smallhardface_tpu_torch.config import cfg
from smallhardface_tpu_torch.datasets.imdb import imdb

logger = logging.getLogger(__name__)


class pascalface(imdb):
    def __init__(self, split):
        super().__init__("pascalface_" + split)
        self._dataset_path = cfg.DATA_DIR
        self._imgs_path = os.path.join(cfg.DATA_DIR, "images")
        list_file = os.path.join(self._dataset_path, "pascal_img_list.txt")
        with open(list_file) as f:
            self._image_paths = [x.strip() for x in f.readlines()]
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
        txt_fname = os.path.join(output_dir, "pascal_res.txt")
        with open(txt_fname, "w") as f:
            for i, img_path in enumerate(self._image_paths):
                img_name = os.path.splitext(os.path.basename(img_path))[0]
                for res in all_boxes[1][i]:
                    xmin, ymin, xmax, ymax = res[:4]
                    # AFW/Pascal annotation convention (pascalface.py:57)
                    ymin += 0.2 * (ymax - ymin + 1)
                    f.write("{:s} {:.3f} {:.1f} {:.1f} {:.1f} {:.1f}\n"
                            .format(img_name, res[-1], xmin, ymin,
                                    xmax, ymax))
        logger.info("Done!")

    def evaluate_detections(self, all_boxes, output_dir="./output/",
                            method_name="smallhard", step=0):
        self.write_detections(all_boxes, output_dir)
        return f"Detection results wrote to {output_dir}"
