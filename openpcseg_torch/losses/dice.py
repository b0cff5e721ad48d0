"""Dice-family losses over padded buffers.

Counterpart of ``openpcseg_tpu/losses/dice.py``: the one-hot dice
(``dice_loss``, DiceLossV0), the per-point binary dice with 3:1 negative
sampling (``dice_loss_v1``, DiceLossV1) and the exponential-logarithmic
dice + CE (``exp_log_loss``, ELLLoss). Ignored and padding rows count in
neither the numerator nor the denominator.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .ce import cross_entropy


def dice_loss(logits: torch.Tensor, labels: torch.Tensor,
              valid: torch.Tensor, *, ignore_index: int = 0,
              eps: float = 1.0) -> torch.Tensor:
    """1 - (2 |p t| + eps) / (|p| + |t| + eps) per class, the mean over the
    classes present in the kept labels."""
    c = logits.shape[-1]
    mask = valid & (labels != ignore_index) & (labels >= 0) & (labels < c)
    maskf = mask.float()[:, None]
    probs = torch.softmax(logits.float(), dim=-1) * maskf
    onehot = F.one_hot(torch.where(mask, labels, torch.zeros_like(labels))
                       .long(), c).float() * maskf
    inter = (probs * onehot).sum(0)
    denom = probs.sum(0) + onehot.sum(0)
    present = (onehot.sum(0) > 0).float()
    dice = (2.0 * inter + eps) / (denom + eps)
    return ((1.0 - dice) * present).sum() / present.sum().clamp(min=1.0)


def dice_loss_v1(logits: torch.Tensor, labels: torch.Tensor,
                 valid: torch.Tensor, *,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[torch.Tensor] = None,
                 ignore_index: int = 0, smooth: float = 1.0,
                 exponent: float = 2.0) -> torch.Tensor:
    """Per-point binary dice 1 - (2 p t + s) / (p^e + t^e + s) for each class,
    averaged over its positives and a uniform subset of min(3 x positives,
    negatives) of its negatives, summed over the classes but the ignored
    one and divided by the class count (JAX ``dice_loss_v1``).

    The subset keeps the negatives whose uniform draw ranks below that
    count (the ranks of a sort, no host sync). `draws` [C, N] are those
    uniforms, one row per class (JAX draws row c from the c-th key of its
    split); without them they come from `generator`."""
    n, c = logits.shape
    ok = valid & (labels != ignore_index) & (labels >= 0) & (labels < c)
    probs = torch.softmax(logits.float(), dim=-1).t()            # [C, N]
    cls = torch.arange(c, device=logits.device)[:, None]
    pos = ok[None] & (labels[None] == cls)
    neg = ok[None] & (labels[None] != cls)
    tot = torch.minimum(3 * pos.sum(1), neg.sum(1))[:, None]
    if draws is None:
        draws = torch.rand((c, n), generator=generator,
                           device=logits.device)
    r = torch.where(neg, draws.float(), float("inf"))
    order = torch.argsort(r, dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(n, device=logits.device).expand(c, n))
    sel = (pos | (neg & (rank < tot))).float()
    t = pos.float()
    loss = 1.0 - (2.0 * probs * t + smooth) / (
        probs ** exponent + t ** exponent + smooth)
    per_class = (loss * sel).sum(1) / (sel.sum(1) + 1e-10)
    live = (torch.arange(c, device=logits.device) != ignore_index).float()
    return (per_class * live).sum() / c


def exp_log_loss(logits: torch.Tensor, labels: torch.Tensor,
                 valid: torch.Tensor, *, ignore_index: int = 0,
                 gamma: float = 0.3, w_dice: float = 0.8, w_ce: float = 0.2,
                 label_smoothing: float = 0.0) -> torch.Tensor:
    """w_dice dice^gamma + w_ce CE^gamma (JAX ``exp_log_loss``)."""
    d = dice_loss(logits, labels, valid, ignore_index=ignore_index)
    ce = cross_entropy(logits, labels, valid, ignore_index=ignore_index,
                       label_smoothing=label_smoothing)
    return (w_dice * d.clamp(min=1e-8) ** gamma
            + w_ce * ce.clamp(min=1e-8) ** gamma)
