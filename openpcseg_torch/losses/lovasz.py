"""Lovász-Softmax loss over padded buffers.

Counterpart of ``openpcseg_tpu/losses/lovasz.py lovasz_softmax`` (Berman
2018, classes='present', per_image=False). Padding and ignored rows stay in
the buffer with error 0 and fg 0, so they sort to the tail where they add
nothing. The sort is a stable descending sort: ties keep their row order,
which is the order ``jax.lax.sort`` of the negated errors gives them. The
gradient reaches each error through the sort's gather, so d loss /
d errors[i] = lovasz_grad[rank(i)], as the JAX custom VJP states it.
"""
from __future__ import annotations

import torch


def _lovasz_grad(fg_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension w.r.t. sorted errors, per row of
    fg_sorted [C, N]."""
    gts = fg_sorted.sum(dim=-1, keepdim=True)
    intersection = gts - fg_sorted.cumsum(-1)
    union = gts + (1.0 - fg_sorted).cumsum(-1)
    jaccard = 1.0 - intersection / union.clamp(min=1e-12)
    return torch.cat([jaccard[:, :1], jaccard[:, 1:] - jaccard[:, :-1]], -1)


def lovasz_softmax(probas: torch.Tensor, labels: torch.Tensor,
                   valid: torch.Tensor, *, ignore_index: int = 0
                   ) -> torch.Tensor:
    """probas [N, C] softmax probabilities -> mean over the classes present
    in the batch of the per-class Lovász terms (scalar float32)."""
    n, c = probas.shape
    mask = valid & (labels != ignore_index) & (labels >= 0) & (labels < c)
    maskf = mask.float()
    classes = torch.arange(c, dtype=labels.dtype, device=labels.device)
    fg = (labels[None, :] == classes[:, None]).float() * maskf     # [C, N]
    errors = (fg - probas.float().t()).abs() * maskf              # [C, N]
    errors_sorted, perm = torch.sort(errors, dim=-1, descending=True,
                                     stable=True)
    grad = _lovasz_grad(fg.gather(1, perm))
    losses = (errors_sorted * grad).sum(-1)
    present = (fg.sum(dim=1) > 0).float()
    return (losses * present).sum() / present.sum().clamp(min=1.0)
