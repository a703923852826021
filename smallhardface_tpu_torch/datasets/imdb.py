"""Image-database base class.
The port's copy of ``smallhardface_tpu/datasets/imdb.py``.

Same contract as the reference imdb (lib/datasets/imdb.py):
`roidb` lazy load + cache, `append_flipped_images`, `prepare_roidb`
(max_overlaps/max_classes), and the `evaluate_detections` interface
(all_boxes[class][image] = Nx5 array).
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

from smallhardface_tpu_torch.config import cfg


class imdb:
    def __init__(self, name):
        self._name = name
        self._classes = []
        self._image_index = []
        self._roidb = None
        self._roidb_handler = self.gt_roidb
        self.config = {}

    def __len__(self):
        return len(self._image_index)

    @property
    def name(self):
        return self._name

    @property
    def num_classes(self):
        return len(self._classes)

    @property
    def classes(self):
        return self._classes

    @property
    def image_index(self):
        return self._image_index

    @property
    def num_images(self):
        return len(self._image_index)

    @property
    def roidb(self):
        if self._roidb is None:
            self._roidb = self._roidb_handler()
        return self._roidb

    @property
    def cache_path(self):
        path = osp.abspath(osp.join(cfg.DATA_DIR, "cache"))
        os.makedirs(path, exist_ok=True)
        return path

    def image_path_at(self, i):
        raise NotImplementedError

    def gt_roidb(self):
        raise NotImplementedError

    def evaluate_detections(self, all_boxes, output_dir=None,
                            method_name="smallhard", step=0):
        raise NotImplementedError

    def _get_widths(self):
        return [self.roidb[i]["image_size"][0]
                for i in range(self.num_images)]

    def append_flipped_images(self):
        """Append a horizontally-flipped copy of every entry
        (reference imdb.py:97-118)."""
        num_images = self.num_images
        widths = self._get_widths()
        for i in range(num_images):
            boxes = self.roidb[i]["boxes"].copy()
            oldx1 = boxes[:, 0].copy()
            oldx2 = boxes[:, 2].copy()
            boxes[:, 0] = widths[i] - oldx2 - 1
            boxes[:, 2] = widths[i] - oldx1 - 1
            assert (boxes[:, 2] >= boxes[:, 0]).all()
            entry = dict(self.roidb[i])
            entry["flipped"] = True
            entry["boxes"] = boxes
            self.roidb.append(entry)
        self._image_index = self._image_index * 2

    def prepare_roidb(self):
        """Add image path/size and per-box max overlap/class
        (reference imdb.py:120-147)."""
        roidb = self.roidb
        for i in range(len(self._image_index)):
            roidb[i]["image"] = self.image_path_at(i)
            roidb[i]["width"] = roidb[i]["image_size"][0]
            roidb[i]["height"] = roidb[i]["image_size"][1]
            gt_overlaps = np.asarray(roidb[i]["gt_overlaps"])
            max_overlaps = gt_overlaps.max(axis=1) if gt_overlaps.size \
                else np.zeros((0,))
            max_classes = gt_overlaps.argmax(axis=1) if gt_overlaps.size \
                else np.zeros((0,), np.int64)
            roidb[i]["max_classes"] = max_classes
            roidb[i]["max_overlaps"] = max_overlaps
            zero_inds = np.where(max_overlaps == 0)[0]
            assert all(max_classes[zero_inds] == 0)
            nonzero_inds = np.where(max_overlaps > 0)[0]
            assert all(max_classes[nonzero_inds] != 0)
