"""Range-view KNN post-processing: per-pixel predictions refined per point.

Counterpart of ``openpcseg_tpu/ops/range_knn.py knn_postprocess``, over a
batch: for every point, the search x search pixel window around its
projected pixel, the k neighbours whose stored range lies closest to the
point's own (a pixel outside the image or empty is never a neighbour),
those farther than ``cutoff`` dropped (cutoff > 0), a majority vote of
their predicted labels, and the point's own pixel's label where no
neighbour is left. ``jax.lax.top_k`` keeps the lower window index among
equal distances, and so does the stable ascending sort taken here (a
plain ``torch.topk`` promises no order among ties); the vote's argmax
takes the lowest class among equal counts, as ``jnp.argmax`` does.
"""
from __future__ import annotations

import torch


def knn_postprocess(proj_range: torch.Tensor, pred_label: torch.Tensor,
                    point_range: torch.Tensor, px: torch.Tensor,
                    py: torch.Tensor, valid: torch.Tensor, *,
                    num_class: int, k: int = 5, search: int = 5,
                    cutoff: float = 1.0) -> torch.Tensor:
    """proj_range [B, H, W] (0 = empty), pred_label [B, H, W] int, and per
    point [B, N]: its range, pixel column px, row py and validity ->
    refined labels [B, N] int32 (0 where not valid)."""
    b, h, w = proj_range.shape
    off = search // 2
    d = torch.arange(-off, off + 1, device=px.device)
    dy = d.repeat_interleave(search)              # row-major window order
    dx = d.repeat(search)
    yy = py.long()[..., None] + dy                # [B, N, S^2]
    xx = px.long()[..., None] + dx
    inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    lin = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(b, -1)
    nb_range = proj_range.reshape(b, -1).gather(1, lin).reshape(yy.shape)
    nb_label = pred_label.reshape(b, -1).gather(1, lin).reshape(yy.shape)

    dist = (nb_range - point_range[..., None]).abs()
    dist = torch.where(inside & (nb_range > 0), dist,
                       torch.full_like(dist, float("inf")))
    kdist, idx = torch.sort(dist, dim=-1, stable=True)
    kdist, idx = kdist[..., :k], idx[..., :k]
    klabel = nb_label.gather(-1, idx)
    keep = torch.isfinite(kdist)
    if cutoff > 0:
        keep = keep & (kdist <= cutoff)

    counts = torch.zeros(*klabel.shape[:-1], num_class,
                         dtype=torch.float32, device=px.device)
    counts.scatter_add_(-1, klabel.long().clamp(0, num_class - 1),
                        keep.float())
    refined = counts.argmax(-1).to(torch.int32)
    own = pred_label.reshape(b, -1).gather(
        1, (py.long() * w + px.long())).to(torch.int32)
    out = torch.where(counts.sum(-1) > 0, refined, own)
    return torch.where(valid, out, torch.zeros_like(out))
