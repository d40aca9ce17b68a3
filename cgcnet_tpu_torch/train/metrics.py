"""Image-level majority-vote metric (reference ``ImgLevelResult``,
common/metric.py:20-51).

Patches are named ``<image-stem>_grade_<g>_<i>``; all patches of one image
vote with their argmax class, the image's prediction is the plurality class,
and accuracy is reported 3-class and binary (normal vs tumour). Unlike the
reference — which looks image labels up in a hardcoded (redacted) list,
common/metric.py:6-19 — ground truth is taken from the patch labels
themselves.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def image_stem(patch_name: str) -> str:
    return patch_name.rsplit("/", 1)[-1].split("_grade")[0]


class ImageLevelMetric:
    def __init__(self):
        self.pred: dict[str, list[int]] = defaultdict(list)
        self.truth: dict[str, int] = {}

    def add_batch(self, names, pred_classes, labels) -> None:
        for name, pred, label in zip(names, pred_classes, labels):
            stem = image_stem(name)
            self.pred[stem].append(int(pred))
            self.truth[stem] = int(label)

    def result(self) -> dict[str, float]:
        if not self.pred:
            return {"img_acc": 0.0, "binary_acc": 0.0}
        correct = bin_correct = 0
        for stem, votes in self.pred.items():
            counts = np.bincount(votes, minlength=3)
            img_pred = int(np.argmax(counts))  # first-max ties like np.argmax
            gt = self.truth[stem]
            correct += img_pred == gt
            bin_correct += (img_pred > 0) == (gt > 0)
        n = len(self.pred)
        return {"img_acc": correct / n, "binary_acc": bin_correct / n}
