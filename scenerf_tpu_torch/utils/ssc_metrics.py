"""Scene-completion / semantic-scene-completion metrics in numpy: the port's
own copy of `scenerf_tpu/utils/ssc_metrics.py` (the port imports nothing of
the JAX package). Binary occupancy IoU/precision/recall plus per-class
semantic IoU, both from bincount confusion matrices.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _masked_flat(pred: np.ndarray, target: np.ndarray, mask: Optional[np.ndarray]):
    pred = pred.reshape(-1).astype(np.int64)
    target = target.reshape(-1).astype(np.int64)
    keep = target != 255
    if mask is not None:
        keep &= mask.reshape(-1).astype(bool)
    # 255-labelled voxels (unknown) are dropped from both passes
    return pred[keep], target[keep]


def completion_counts(pred: np.ndarray, target: np.ndarray,
                      mask: Optional[np.ndarray] = None):
    """Binary (occupied = label > 0) tp/fp/fn."""
    p, t = _masked_flat(pred, target, mask)
    bp = p > 0
    bt = t > 0
    tp = int(np.sum(bt & bp))
    fp = int(np.sum(~bt & bp))
    fn = int(np.sum(bt & ~bp))
    return tp, fp, fn


def semantic_counts(pred: np.ndarray, target: np.ndarray, n_classes: int,
                    mask: Optional[np.ndarray] = None):
    """Per-class tp/fp/fn via one confusion matrix."""
    p, t = _masked_flat(pred, target, mask)
    p = np.clip(p, 0, n_classes - 1)
    t = np.clip(t, 0, n_classes - 1)
    conf = np.bincount(t * n_classes + p, minlength=n_classes * n_classes)
    conf = conf.reshape(n_classes, n_classes)
    tp = np.diag(conf).astype(np.int64)
    fp = conf.sum(axis=0) - tp
    fn = conf.sum(axis=1) - tp
    return tp, fp, fn


class SSCMetrics:
    """Accumulator: add_batch / get_stats / reset."""

    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.reset()

    def reset(self):
        self.completion_tp = 0
        self.completion_fp = 0
        self.completion_fn = 0
        self.tps = np.zeros(self.n_classes, dtype=np.int64)
        self.fps = np.zeros(self.n_classes, dtype=np.int64)
        self.fns = np.zeros(self.n_classes, dtype=np.int64)

    def add_batch(self, y_pred: np.ndarray, y_true: np.ndarray,
                  nonempty: Optional[np.ndarray] = None,
                  nonsurface: Optional[np.ndarray] = None):
        mask = np.ones(y_true.shape, dtype=bool)
        if nonempty is not None:
            mask &= nonempty.astype(bool)
        cmask = mask.copy()
        if nonsurface is not None:
            cmask &= nonsurface.astype(bool)
        tp, fp, fn = completion_counts(y_pred, y_true, cmask)
        self.completion_tp += tp
        self.completion_fp += fp
        self.completion_fn += fn

        tps, fps, fns = semantic_counts(y_pred, y_true, self.n_classes, mask)
        self.tps += tps
        self.fps += fps
        self.fns += fns

    def get_stats(self) -> Dict[str, np.ndarray]:
        if self.completion_tp != 0:
            precision = self.completion_tp / (self.completion_tp + self.completion_fp)
            recall = self.completion_tp / (self.completion_tp + self.completion_fn)
            iou = self.completion_tp / (
                self.completion_tp + self.completion_fp + self.completion_fn
            )
        else:
            precision, recall, iou = 0.0, 0.0, 0.0
        iou_ssc = self.tps / (self.tps + self.fps + self.fns + 1e-5)
        return {
            "precision": precision,
            "recall": recall,
            "iou": iou,
            "iou_ssc": iou_ssc,
            "iou_ssc_mean": float(np.mean(iou_ssc[1:])) if self.n_classes > 1 else 0.0,
        }
