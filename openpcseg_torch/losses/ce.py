"""Cross-entropy family over padded buffers.

Counterpart of ``openpcseg_tpu/losses/ce.py`` (``cross_entropy``,
``weighted_cross_entropy``, ``focal_loss``). ``cross_entropy``:
torch.nn.CrossEntropyLoss semantics (ignore_index masks samples,
label_smoothing spreads eps / C over every class, the mean is over the
kept samples, optionally weighted per class) plus the lane validity mask
of the fixed-capacity buffers.
"""
from __future__ import annotations

from typing import Optional

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  valid: torch.Tensor, *, ignore_index: int = 0,
                  label_smoothing: float = 0.0,
                  class_weight: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """logits [N, C], labels [N] int, valid [N] bool -> scalar float32."""
    n_cls = logits.shape[-1]
    mask = valid & (labels != ignore_index) & (labels >= 0) & (labels < n_cls)
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, safe[:, None])[:, 0]
    if label_smoothing > 0.0:
        loss = ((1.0 - label_smoothing) * nll
                - label_smoothing * logp.mean(dim=-1))
    else:
        loss = nll
    w = (class_weight.float()[safe] if class_weight is not None
         else torch.ones_like(loss))
    w = w * mask.float()
    return (loss * w).sum() / w.sum().clamp(min=1e-12)


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           valid: torch.Tensor, *, cls_num_pts: torch.Tensor,
                           ignore_index: int = 0,
                           label_smoothing: float = 0.0) -> torch.Tensor:
    """Cross-entropy weighted by inverse sqrt class frequency (JAX
    ``weighted_cross_entropy``): w_c = 1 / sqrt(n_c / sum n), scaled to sum
    to the class count."""
    n = cls_num_pts.float()
    freq = n / n.sum().clamp(min=1.0)
    weight = 1.0 / torch.sqrt(freq.clamp(min=1e-12))
    weight = weight / weight.sum() * n.shape[0]
    return cross_entropy(logits, labels, valid, ignore_index=ignore_index,
                         label_smoothing=label_smoothing,
                         class_weight=weight)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               valid: torch.Tensor, *, gamma: float = 0.5,
               ignore_index: int = 0) -> torch.Tensor:
    """Multi-class focal loss -(1 - p_t)^gamma log p_t, the mean over the
    kept samples (JAX ``focal_loss``, gamma 0.5 as its dispatcher
    builds it). 1 - p_t is clamped at 1e-30 before the power: where p_t
    rounds to 1, d(1 - p_t)^gamma is infinite and JAX's gradient is
    0 x inf = NaN, whose limit is 0; elsewhere the two are one formula."""
    n_cls = logits.shape[-1]
    mask = valid & (labels != ignore_index) & (labels >= 0) & (labels < n_cls)
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    logpt = logp.gather(1, safe[:, None])[:, 0]
    loss = -((1.0 - torch.exp(logpt)).clamp(min=1e-30) ** gamma) * logpt
    m = mask.float()
    return (loss * m).sum() / m.sum().clamp(min=1.0)
