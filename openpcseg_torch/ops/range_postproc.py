"""RangeNet++ post-processing: the locally connected CRF and the border
mask.

Counterpart of ``openpcseg_tpu/ops/range_postproc.py`` (both off in every
shipped config; ``MODEL.POST_CRF`` turns the CRF on in the range eval).
Each window offset is a shift with zero fill (``F.pad`` then a slice): a
window element outside the image adds nothing, as the reference's
zero-padded unfold and JAX's roll with the wrapped rows zeroed. Images are
NHWC, as JAX's.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _window_offsets(h: int, w: int):
    if h % 2 != 1 or w % 2 != 1:
        raise ValueError(f"the window {h} x {w} must be odd")
    return [(dy, dx) for dy in range(-(h // 2), h // 2 + 1)
            for dx in range(-(w // 2), w // 2 + 1)]


def shifted(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[:, i, j] = a[:, i - dy, j - dx], 0 where that lies outside the
    image ([B, H, W, ...] with at least one trailing dimension)."""
    h, w = a.shape[1], a.shape[2]
    pad = [0, 0] * (a.dim() - 3) + [max(dx, 0), max(-dx, 0),
                                    max(dy, 0), max(-dy, 0)]
    p = F.pad(a, pad)
    y0, x0 = max(-dy, 0), max(-dx, 0)
    return p[:, y0:y0 + h, x0:x0 + w]


def crf_refine(xyz: torch.Tensor, softmax: torch.Tensor, mask: torch.Tensor,
               *, iters: int = 3, lcn_h: int = 3, lcn_w: int = 5,
               xyz_coef: float = 0.1, xyz_sigma: float = 0.7
               ) -> torch.Tensor:
    """xyz [B, H, W, 3] (0 where invalid), softmax [B, H, W, C], mask
    [B, H, W] bool -> the refined softmax [B, H, W, C]: `iters` rounds of
    a message (each window neighbour's probabilities weighted by
    exp(-|dxyz|^2 / (2 sigma^2))), a compatibility mix ((1 - I) x
    xyz_coef) added to the probabilities, and a softmax (JAX
    ``crf_refine``). The window weights depend on xyz alone, so they are
    made once."""
    c = softmax.shape[-1]
    den = 2.0 * xyz_sigma * xyz_sigma
    mf = mask[..., None].to(softmax.dtype)
    compat = (torch.ones(c, c, device=softmax.device)
              - torch.eye(c, device=softmax.device)) * xyz_coef
    offsets = _window_offsets(lcn_h, lcn_w)
    weights = [torch.exp(-((shifted(xyz, dy, dx) - xyz) ** 2).sum(
        -1, keepdim=True) / den) for dy, dx in offsets]
    sm = softmax
    for _ in range(iters):
        sm = sm * mf
        msg = torch.zeros_like(sm)
        for wk, (dy, dx) in zip(weights, offsets):
            msg = msg + wk * shifted(sm, dy, dx)
        sm = torch.softmax(msg @ compat + sm, dim=-1)
    return sm


def border_mask(labels: torch.Tensor, num_class: int, border_size: int = 1,
                kern_conn: int = 4,
                background_class: Optional[int] = 0) -> torch.Tensor:
    """[B, H, W] bool: True where classes meet within `border_size`
    erosions of the one-hot labels by a 4- or 8-connected kernel (JAX
    ``border_mask``; the background class added to every other
    channel)."""
    if kern_conn not in (4, 8):
        raise ValueError(f"kern_conn {kern_conn}: 4 or 8")
    oh = F.one_hot(labels.long(), num_class).float()
    if background_class is not None:
        bg = oh[..., background_class:background_class + 1]
        oh = oh + bg
        oh[..., background_class] -= bg[..., 0]
    offs = ([(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)] if kern_conn == 4
            else _window_offsets(3, 3))
    ero = oh
    for _ in range(border_size):
        acc = torch.zeros_like(ero)
        for dy, dx in offs:
            acc = acc + shifted(ero, dy, dx)
        ero = (acc == float(len(offs))).float()
    bodies = ero.sum(-1) == 1
    if background_class is not None:
        bodies = bodies | (ero[..., background_class] == 1)
    return ~bodies
