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


def miou_from_hist(hist: np.ndarray,
                   unique_label: Optional[Sequence[int]] = None):
    """Mean IoU (%) + per-class IoU over the evaluated class set (rows /
    cols ``unique_label + 1`` when given)."""
    h = np.asarray(hist)
    if unique_label is not None:
        ul = np.asarray(unique_label) + 1
        h = h[np.ix_(ul, ul)]
    iou = per_class_iou(h)
    return float(np.nanmean(iou) * 100.0), iou * 100.0
