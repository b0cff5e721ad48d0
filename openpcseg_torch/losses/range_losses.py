"""Range-view (dense image) losses over NCHW logits.

Counterpart of ``openpcseg_tpu/losses/range_losses.py`` (logits [B, C, H,
W] here, [B, H, W, C] there; labels [B, H, W], class 0 ignored):

- ``wce_image``: CE weighted by ``CLASS_FREQ_WEIGHTS`` (class 0 weighs
  0), the mean over ALL pixels (torch ``CrossEntropyLoss(weight,
  reduction='none').mean()``), or over the hardest ``top_k_percent``;
- ``ce_dice_image``: CE over the labelled pixels plus the dice loss of the
  classes present (MODEL.LOSS 'dice');
- ``lovasz_image``: Lovász-softmax over every pixel (``losses/lovasz.py``);
- ``boundary_loss``: the boundary F1 loss, boundaries from a 3x3 max pool
  of 1 - x that pads with -inf;
- ``range_seg_loss``: 1 CE + 3 Lovász + 1 boundary, the main head weighed
  1.25 when aux heads exist.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from .lovasz import lovasz_softmax

# (reference range/utils.py:344-367)
CLASS_FREQ_WEIGHTS = [
    0.0,
    1.0 / (0.040818519255974316 + 0.001789309418528068 + 0.001),
    1.0 / (0.00016609538710764618 + 0.001),
    1.0 / (0.00039838616015114444 + 0.001),
    1.0 / (0.0020633612104619787 + 0.00010157861367183268 + 0.001),
    1.0 / (2.7879693665067774e-05 + 0.0016218197275284021
           + 0.00011351574470342043 + 4.3840131989471124e-05 + 0.001),
    1.0 / (0.00017698551338515307 + 0.00016059776092534436 + 0.001),
    1.0 / (1.1065903904919655e-08 + 0.00012709999297008662 + 0.001),
    1.0 / (5.532951952459828e-09 + 3.745553104802113e-05 + 0.001),
    1.0 / (0.1987493871255525 + 4.7084144280367186e-05 + 0.001),
    1.0 / (0.014717169549888214 + 0.001),
    1.0 / (0.14392298360372 + 0.001),
    1.0 / (0.0039048553037472045 + 0.001),
    1.0 / (0.1326861944777486 + 0.001),
    1.0 / (0.0723592229456223 + 0.001),
    1.0 / (0.26681502148037506 + 0.001),
    1.0 / (0.006035012012626033 + 0.001),
    1.0 / (0.07814222006271769 + 0.001),
    1.0 / (0.002855498193863172 + 0.001),
    1.0 / (0.0006155958086189918 + 0.001),
]


def _nll(logits: torch.Tensor, labels: torch.Tensor):
    """(-log p of each pixel's label [B, H, W], the clamped labels)."""
    c = logits.shape[1]
    safe = labels.clamp(0, c - 1).long()
    logp = torch.log_softmax(logits.float(), dim=1)
    return -logp.gather(1, safe[:, None])[:, 0], safe


def _top_mean(flat: torch.Tensor, top_k_percent: float) -> torch.Tensor:
    k = max(1, int(top_k_percent * flat.shape[0]))
    return flat.topk(k).values.mean()


def wce_image(logits: torch.Tensor, labels: torch.Tensor,
              top_k_percent: float = 1.0) -> torch.Tensor:
    nll, safe = _nll(logits, labels)
    w = torch.tensor(CLASS_FREQ_WEIGHTS[:logits.shape[1]],
                     dtype=torch.float32, device=logits.device)
    flat = (nll * w[safe]).reshape(-1)
    if top_k_percent < 1.0:
        return _top_mean(flat, top_k_percent)
    return flat.mean()


def ce_dice_image(logits: torch.Tensor, labels: torch.Tensor,
                  top_k_percent: float = 1.0,
                  ignore_index: int = 0) -> torch.Tensor:
    c = logits.shape[1]
    nll, safe = _nll(logits, labels)
    valid = (labels != ignore_index).float()
    flat = (nll * valid).reshape(-1)
    if top_k_percent < 1.0:
        ce = _top_mean(flat, top_k_percent)
    else:
        ce = flat.sum() / valid.sum().clamp(min=1.0)

    vmask = valid[:, None]
    probs = torch.softmax(logits.float(), dim=1) * vmask
    onehot = F.one_hot(safe, c).permute(0, 3, 1, 2).float() * vmask
    inter = (probs * onehot).sum((0, 2, 3))
    count = onehot.sum((0, 2, 3))
    denom = probs.sum((0, 2, 3)) + count
    pf = (count > 0).float()
    dice = (2 * inter + 1.0) / (denom + 1.0)
    return ce + ((1.0 - dice) * pf).sum() / pf.sum().clamp(min=1.0)


def lovasz_image(logits: torch.Tensor, labels: torch.Tensor,
                 ignore_index: int = 0) -> torch.Tensor:
    c = logits.shape[1]
    probas = torch.softmax(logits.float(), dim=1).permute(0, 2, 3, 1)
    flat_labels = labels.reshape(-1)
    return lovasz_softmax(probas.reshape(-1, c), flat_labels,
                          torch.ones_like(flat_labels, dtype=torch.bool),
                          ignore_index=ignore_index)


def _maxpool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 max pool, padded with -inf."""
    return F.max_pool2d(x, 3, 1, 1)


def boundary_loss(probs: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """probs: softmax probabilities [B, C, H, W]; labels [B, H, W]."""
    b, c = probs.shape[:2]
    onehot = F.one_hot(labels.clamp(0, c - 1).long(), c).permute(
        0, 3, 1, 2).float()
    gt_b = (_maxpool3(1.0 - onehot) - (1.0 - onehot)).reshape(b, c, -1)
    pred_b = (_maxpool3(1.0 - probs) - (1.0 - probs)).reshape(b, c, -1)
    inter = (pred_b * gt_b).sum(2)
    p = inter / (pred_b.sum(2) + 1e-7)
    r = inter / (gt_b.sum(2) + 1e-7)
    bf1 = 2 * p * r / (p + r + 1e-7)
    return (1.0 - bf1).mean()


def range_seg_loss(logits: torch.Tensor, aux_logits: Sequence[torch.Tensor],
                   labels: torch.Tensor, *, loss_kind: str = "wce",
                   top_k_percent: float = 1.0, if_ls: bool = True,
                   if_bd: bool = True, ignore_index: int = 0) -> torch.Tensor:
    """The range recipe: 1.0 CE (MODEL.LOSS 'wce' or 'dice') + 3.0 Lovász
    + 1.0 boundary, summed over the heads, the main one at 1.25 when aux
    heads exist; top-k applies to the main head's CE only."""
    def ce(lg, topk):
        if loss_kind == "dice":
            return ce_dice_image(lg, labels, topk, ignore_index)
        return wce_image(lg, labels, topk)

    heads = [logits] + list(aux_logits)
    wts = [1.25] + [1.0] * len(aux_logits) if aux_logits else [1.0]
    loss = sum(w * ce(lg, top_k_percent if i == 0 else 1.0)
               for i, (w, lg) in enumerate(zip(wts, heads)))
    if if_ls:
        loss = loss + 3.0 * sum(w * lovasz_image(lg, labels, ignore_index)
                                for w, lg in zip(wts, heads))
    if if_bd:
        loss = loss + sum(
            w * boundary_loss(torch.softmax(lg.float(), dim=1), labels)
            for w, lg in zip(wts, heads))
    return loss
