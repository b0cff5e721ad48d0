"""Confusion-matrix metrics (mIoU).

Counterpart of ``openpcseg_tpu/utils/metrics.py``: the histogram is built on
the device with ``torch.bincount``; the IoU arithmetic is host-side numpy.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor,
                     valid: torch.Tensor, num_class: int) -> torch.Tensor:
    """hist[i, j] = #(label == i, pred == j) over valid, in-range lanes."""
    ok = (valid & (label >= 0) & (label < num_class) & (pred >= 0)
          & (pred < num_class))
    nn2 = num_class * num_class
    flat = torch.where(ok, label.long() * num_class + pred.long(),
                       torch.full_like(label, nn2, dtype=torch.long))
    return torch.bincount(flat, minlength=nn2 + 1)[:nn2].reshape(
        num_class, num_class)


def per_class_iou(hist: np.ndarray) -> np.ndarray:
    hist = np.asarray(hist, np.float64)
    denom = hist.sum(1) + hist.sum(0) - np.diag(hist)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.diag(hist) / denom


def crop_hist(hist: np.ndarray, unique_label: Sequence[int]) -> np.ndarray:
    """The confusion matrix cropped to the evaluated classes: rows and
    cols ``unique_label + 1`` (class 0, the ignored one, drops out)."""
    ul = np.asarray(unique_label) + 1
    return np.asarray(hist)[np.ix_(ul, ul)]


def miou_from_hist(hist: np.ndarray,
                   unique_label: Optional[Sequence[int]] = None):
    """Mean IoU (%) + per-class IoU over the evaluated class set (rows /
    cols ``unique_label + 1`` when given)."""
    h = (crop_hist(hist, unique_label) if unique_label is not None
         else np.asarray(hist))
    iou = per_class_iou(h)
    return float(np.nanmean(iou) * 100.0), iou * 100.0


def gt_present_miou(hist: np.ndarray, num_class: int):
    """(mIoU over the classes present in the ground truth, mIoU over the
    classes with a nonzero union, per-class IoU of classes 1..num_class-1),
    all in %. On a small fixed val set the union denominator lets a class
    absent from the ground truth flip between excluded and 0 as the model
    predicts a few stray points of it; the ground truth's class set does
    not move."""
    unique_label = np.arange(num_class - 1)
    miou_union, per = miou_from_hist(hist, unique_label)
    present = crop_hist(hist, unique_label).sum(1) > 0
    return float(np.nanmean(per[present])), miou_union, per
