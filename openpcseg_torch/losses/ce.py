"""Cross-entropy over padded buffers.

Counterpart of ``openpcseg_tpu/losses/ce.py cross_entropy``:
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
