"""WIDER FACE dataset (reference lib/datasets/wider.py).
The port's copy of ``smallhardface_tpu/datasets/wider.py``.

Annotation format: `wider_face_{split}_bbx_gt.txt` groups of
  <relative image path>
  <n boxes>
  <x y w h ...> × n
Boxes are converted to [x1, y1, x2, y2] with x1,y1 clamped at 0 and x2,y2
clamped to the image extent; degenerate boxes (<1 px) are dropped but leave
zero-filled rows, matching the reference's quirk (wider.py:102-125 keeps the
pre-allocated array length and only fills `ix` rows... the reference keeps
the full-length arrays — we reproduce that).
"""

from __future__ import annotations

import logging
import os
import pickle
import shutil
import tarfile

import numpy as np
from PIL import Image

from smallhardface_tpu_torch.config import cfg
from smallhardface_tpu_torch.datasets.imdb import imdb
from smallhardface_tpu_torch.utils.tensorboard import tb

logger = logging.getLogger(__name__)


class wider(imdb):
    def __init__(self, split):
        super().__init__("wider_" + split)
        self._test_flag = split == "test"
        self._split = split
        self._annotation_file_name = (
            "wider_face_test_filelist.txt" if self._test_flag else
            f"wider_face_{split}_bbx_gt.txt")
        self._dataset_path = cfg.DATA_DIR
        self._imgs_path = os.path.join(self._dataset_path,
                                       f"WIDER_{split}", "images")
        anno_path = os.path.join(self._dataset_path, "wider_face_split",
                                 self._annotation_file_name)
        assert os.path.isfile(anno_path), \
            f"Annotation file not found {anno_path}"
        with open(anno_path) as f:
            annos = f.readlines()

        self._fp_bbox_map = {}
        if not self._test_flag:
            count = 0
            while count < len(annos):
                name = annos[count].rstrip()
                self._fp_bbox_map[name] = []
                count += 1
                n_anno = int(annos[count])
                for _ in range(n_anno):
                    count += 1
                    b = annos[count].split(" ")[0:4]
                    b = [int(round(float(x))) for x in b]
                    x1 = max(0, b[0])
                    y1 = max(0, b[1])
                    self._fp_bbox_map[name].append(
                        [x1, y1, x1 + b[2], y1 + b[3]])
                count += 1
            self._image_paths = list(self._fp_bbox_map.keys())
        else:
            self._image_paths = [p.rstrip() for p in annos]

        self._image_index = list(range(len(self._image_paths)))
        self._classes = ["bg", "face"]

    def image_path_at(self, i):
        path = os.path.join(self._imgs_path,
                            self._image_paths[self._image_index[i]])
        assert os.path.exists(path), f"Path does not exist: {path}"
        return path

    def gt_roidb(self):
        cache_file = os.path.join(
            self.cache_path, f"{self.name}_{self._split}_gt_roidb.pkl")
        if os.path.exists(cache_file):
            with open(cache_file, "rb") as fid:
                roidb = pickle.load(fid)
            logger.info("%s gt roidb loaded from %s", self.name, cache_file)
            return roidb

        roidb = []
        for fp in self._image_paths:
            img_path = os.path.join(self._imgs_path, fp)
            imsize = Image.open(img_path).size
            if self._test_flag:
                roidb.append({"image_size": imsize, "file_path": img_path})
                continue
            raw = self._fp_bbox_map[fp]
            boxes = np.zeros((len(raw), 4), np.float64)
            gt_classes = np.ones((len(raw),), np.int32)
            overlaps = np.zeros((len(raw), 2), np.float64)
            ix = 0
            for b in raw:
                x1, y1 = b[0], b[1]
                x2 = min(imsize[0], b[2])
                y2 = min(imsize[1], b[3])
                if (x2 - x1) < 1 or (y2 - y1) < 1:
                    continue
                boxes[ix] = [x1, y1, x2, y2]
                gt_classes[ix] = 1
                overlaps[ix, 1] = 1.0
                ix += 1
            roidb.append({
                "boxes": boxes,
                "gt_classes": gt_classes,
                "gt_overlaps": overlaps,
                "flipped": False,
                "image_size": imsize,
                "file_path": img_path,
            })
        with open(cache_file, "wb") as fid:
            pickle.dump(roidb, fid, pickle.HIGHEST_PROTOCOL)
        logger.info("wrote gt roidb to %s", cache_file)
        return roidb

    def write_detections(self, all_boxes, output_dir="./output/"):
        """Per-image txt files: path, count, then `x y w h score` rows
        (reference wider.py:143-168)."""
        logger.info("Writing the detections to text files: %s...", output_dir)
        for i, img_path in enumerate(self._image_paths):
            img_name = os.path.basename(img_path)
            img_dir = img_path[:img_path.find(img_name) - 1]
            res_dir = os.path.join(output_dir, img_dir)
            os.makedirs(res_dir, exist_ok=True)
            txt_fname = os.path.join(res_dir, img_name.replace("jpg", "txt"))
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
        from smallhardface_tpu_torch.evals.wider_eval import wider_eval
        detections_txt_path = os.path.join(output_dir, "detections")
        self.write_detections(all_boxes, detections_txt_path)
        logger.info("Evaluating detections using the WIDER protocol...")
        ap, pr = wider_eval(
            detections_txt_path,
            os.path.join(cfg.DATA_DIR, "ground_truth"),
            mimic_eval_bug=cfg.MISC.MIMIC_EVAL_BUG,
            iou_thresh=cfg.TEST.IOU_THRESH)
        with tarfile.open(os.path.join(output_dir, "result.tar.gz"),
                          "w:gz") as tar:
            tar.add(detections_txt_path,
                    arcname=os.path.basename(detections_txt_path))
        shutil.rmtree(detections_txt_path)
        tb.sess.add_scalar_value("easy", ap[0], step=step)
        tb.sess.add_scalar_value("medium", ap[1], step=step)
        tb.sess.add_scalar_value("hard", ap[2], step=step)
        return "Easy: {:.4f}, Medium: {:.4f}, Hard: {:.4f}".format(*ap)
