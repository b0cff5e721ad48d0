"""Loss dispatcher: the weighted sum of named losses.

Counterpart of ``openpcseg_tpu/losses/__init__.py Losses``, with every
name of JAX's set: CELoss, LovLoss (the config zoo's default, weights
[1, 1]), WCELoss, FocalLoss, DiceLossV0, DiceLossV1, ELLLoss, EQLv2,
GroupSoftmax and GroupSoftmax_fgbg_2 (the last two one loss, the
extended-head form where ``extended_group_head``).

EQLv2 carries buffers across steps (``stateful``, ``init_state``): the
caller passes them as ``state`` and gets ``(loss, new state)`` back.
DiceLossV1's negative sampling and the extended GroupSoftmax's 'others'
sampling draw from the ``generator`` passed; without one DiceLossV1 is
the one-hot dice and the GroupSoftmax weights its others rows (JAX's
no-rng fallbacks).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .ce import cross_entropy, focal_loss, weighted_cross_entropy
from .dice import dice_loss, dice_loss_v1, exp_log_loss
from .longtail import (eqlv2_init_state, eqlv2_loss, group_softmax_loss,
                       group_softmax_loss_extended)
from .lovasz import lovasz_softmax

KNOWN = ("CELoss", "LovLoss", "WCELoss", "FocalLoss", "DiceLossV0",
         "DiceLossV1", "ELLLoss", "EQLv2", "GroupSoftmax",
         "GroupSoftmax_fgbg_2")


class Losses:
    """sum_i w_i * loss_i(logits [N, C], labels [N], valid [N]).
    `cls_num_pts` (WCELoss) and `class_names` (the GroupSoftmax groups)
    are the dataset's (``data.dataset_meta``); `group` is the process
    group EQLv2 sums its buffers over (JAX ``axis_name``)."""

    def __init__(self, loss_types: Sequence[str],
                 loss_weights: Sequence[float], *,
                 cls_num_pts: Optional[Sequence[float]] = None,
                 ignore_index: int = 0, label_smoothing: float = 0.0,
                 class_names: Optional[List[str]] = None,
                 num_class: Optional[int] = None,
                 extended_group_head: bool = False,
                 group_version: str = "bgfg", group=None):
        if len(loss_types) != len(loss_weights):
            raise ValueError(f"{len(loss_types)} loss types, "
                             f"{len(loss_weights)} weights")
        unknown = [t for t in loss_types if t not in KNOWN]
        if unknown:
            raise NotImplementedError(f"loss types not implemented: "
                                      f"{unknown} (the set is {KNOWN})")
        self.loss_types = list(loss_types)
        self.loss_weights = list(loss_weights)
        self.ignore_index = ignore_index
        self.label_smoothing = label_smoothing
        self.cls_num_pts = (None if cls_num_pts is None else
                            torch.as_tensor(cls_num_pts, dtype=torch.float32))
        self.class_names = class_names
        self.num_class = num_class
        self.extended_group_head = extended_group_head
        self.group_version = group_version
        self.group = group
        self._tables: dict = {}

    def _num_pts(self, device) -> torch.Tensor:
        """cls_num_pts on `device`, copied there once: a copy to the card
        would stop the host on every step."""
        key = str(device)
        if key not in self._tables:
            self._tables[key] = self.cls_num_pts.to(device)
        return self._tables[key]

    @property
    def stateful(self) -> bool:
        """True where a loss carries buffers across steps (EQLv2)."""
        return "EQLv2" in self.loss_types

    def init_state(self, num_class: Optional[int] = None, device=None):
        """The first step's loss state ({} where no loss is stateful)."""
        if not self.stateful:
            return {}
        return {"eqlv2": eqlv2_init_state(num_class or self.num_class,
                                          device)}

    def __call__(self, logits: torch.Tensor, labels: torch.Tensor,
                 valid: torch.Tensor, state: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None):
        """The weighted sum; with `state`, (sum, new state)."""
        new_state = dict(state) if state is not None else None
        total = logits.new_zeros((), dtype=torch.float32)
        kw = dict(ignore_index=self.ignore_index)
        for name, w in zip(self.loss_types, self.loss_weights):
            if name == "CELoss":
                v = cross_entropy(logits, labels, valid,
                                  label_smoothing=self.label_smoothing, **kw)
            elif name == "LovLoss":
                v = lovasz_softmax(torch.softmax(logits.float(), dim=-1),
                                   labels, valid, **kw)
            elif name == "WCELoss":
                if self.cls_num_pts is None:
                    raise ValueError("WCELoss needs the dataset's "
                                     "cls_num_pts")
                v = weighted_cross_entropy(
                    logits, labels, valid,
                    cls_num_pts=self._num_pts(logits.device),
                    label_smoothing=self.label_smoothing, **kw)
            elif name == "FocalLoss":
                v = focal_loss(logits, labels, valid, **kw)
            elif name == "DiceLossV0" or (name == "DiceLossV1"
                                          and generator is None):
                v = dice_loss(logits, labels, valid, **kw)
            elif name == "DiceLossV1":
                v = dice_loss_v1(logits, labels, valid, generator=generator,
                                 **kw)
            elif name == "ELLLoss":
                v = exp_log_loss(logits, labels, valid,
                                 label_smoothing=self.label_smoothing, **kw)
            elif name == "EQLv2":
                if state is not None and "eqlv2" in state:
                    v, new_state["eqlv2"] = eqlv2_loss(
                        logits, labels, valid, state=state["eqlv2"],
                        group=self.group, **kw)
                else:
                    v = eqlv2_loss(logits, labels, valid, **kw)
            elif self.extended_group_head:     # the GroupSoftmax names
                v = group_softmax_loss_extended(
                    logits, labels, valid,
                    num_class=self.num_class or logits.shape[-1],
                    class_names=self.class_names,
                    version=self.group_version, generator=generator, **kw)
            else:
                v = group_softmax_loss(logits, labels, valid,
                                       class_names=self.class_names, **kw)
            total = total + w * v
        return (total, new_state) if state is not None else total
