"""Loss dispatcher: the weighted sum of named losses.

Counterpart of ``openpcseg_tpu/losses/__init__.py Losses`` for the two
losses of the config zoo's default, ['CELoss', 'LovLoss'] with weights
[1, 1]. Every other loss of the JAX package is still to be ported.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .ce import cross_entropy
from .lovasz import lovasz_softmax

PORTED = ("CELoss", "LovLoss")


class Losses:
    """sum_i w_i * loss_i(logits [N, C], labels [N], valid [N])."""

    def __init__(self, loss_types: Sequence[str],
                 loss_weights: Sequence[float], *, ignore_index: int = 0,
                 label_smoothing: float = 0.0):
        if len(loss_types) != len(loss_weights):
            raise ValueError(f"{len(loss_types)} loss types, "
                             f"{len(loss_weights)} weights")
        missing = [t for t in loss_types if t not in PORTED]
        if missing:
            raise NotImplementedError(
                f"loss types {missing} are not ported yet (the port has "
                f"{list(PORTED)}; see ROADMAP.md)")
        self.loss_types = list(loss_types)
        self.loss_weights = list(loss_weights)
        self.ignore_index = ignore_index
        self.label_smoothing = label_smoothing

    def __call__(self, logits: torch.Tensor, labels: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
        total = logits.new_zeros((), dtype=torch.float32)
        for name, w in zip(self.loss_types, self.loss_weights):
            if name == "CELoss":
                v = cross_entropy(logits, labels, valid,
                                  ignore_index=self.ignore_index,
                                  label_smoothing=self.label_smoothing)
            else:
                v = lovasz_softmax(torch.softmax(logits.float(), dim=-1),
                                   labels, valid,
                                   ignore_index=self.ignore_index)
            total = total + w * v
        return total
