"""Long-tail losses: EQLv2 and GroupSoftmax.

Counterpart of ``openpcseg_tpu/losses/longtail.py``:

- ``eqlv2_loss``: sigmoid BCE whose negatives are down-weighted per class
  by the ratio of the positive to the negative gradient the class has
  collected. With ``state`` ({pos_grad, neg_grad} [C-1] each, class 0 left
  out: JAX's ``[1:]`` slicing) the ratio is the buffers' and the step adds
  its own |p - t| x weight sums to them (summed over the ranks of `group`,
  JAX's ``psum``); all-zero buffers mark the first step, whose weights are
  all ones. Without ``state`` the batch's own sums set the weights.
- ``group_softmax_loss_extended`` over a head widened to
  ``group_softmax_channel_num(C)`` channels (layout [unused, g0_others,
  g0_cls..., g1_others, g1_cls..., fg, bg]): a softmax CE per group with
  the out-of-group rows as its 'others' class, subsampled to ~beta x the
  group's rows (Bernoulli keeps, from `generator` or the `draws` given;
  without either, the same expectation as a weight), plus the fg / bg
  pair over every kept row; ``group_softmax_activation`` maps the head
  back to C class scores for argmax and softmax.
- ``group_softmax_loss``: the head-preserving form over C logits, each
  group's 'others' the logsumexp of the logits outside it.

Everything stays on the device: no value is read back to the host.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..parallel.ddp import all_reduce_sum

# Waymo class groups (JAX longtail.py WAYMO_GROUPS)
WAYMO_GROUPS = [
    ["CAR", "TRUCK", "BUS", "OTHER_VEHICLE"],
    ["MOTORCYCLIST", "BICYCLIST", "PEDESTRIAN", "BICYCLE", "MOTORCYCLE"],
    ["SIGN", "TRAFFIC_LIGHT", "POLE", "CONSTRUCTION_CONE"],
    ["BUILDING", "VEGETATION", "TREE_TRUNK"],
    ["CURB", "ROAD", "LANE_MARKER", "OTHER_GROUND", "WALKABLE", "SIDEWALK"],
]


def _default_names(class_names, num_class):
    if class_names is None:
        from ..data.waymo import WAYMO_CLASS_NAMES
        return WAYMO_CLASS_NAMES[:num_class]
    return class_names


def group_structure(class_names: Sequence[str], version: str = "bgfg"):
    """(group_ids per non-bg group, fgbg_ids [2]): version 'bgfg' takes
    class_names[1:14] and class_names[14:], 'fine' the five WAYMO_GROUPS
    (the fg side their first three)."""
    if version == "bgfg":
        group_ids = [list(range(1, min(14, len(class_names)))),
                     list(range(min(14, len(class_names)),
                                len(class_names)))]
        fgbg_ids = [group_ids[0], group_ids[1]]
    else:
        name_to_id = {nm: i for i, nm in enumerate(class_names)}
        group_ids = [[name_to_id[nm] for nm in g if nm in name_to_id]
                     for g in WAYMO_GROUPS]
        group_ids = [g for g in group_ids if g]
        fgbg_ids = [sum(group_ids[:3], []), sum(group_ids[3:], [])]
    return group_ids, fgbg_ids


def group_softmax_channel_num(num_class: int, version: str = "bgfg") -> int:
    """The extended head's width: num_class + 1 + the group count + 1."""
    num_group = (2 if version == "bgfg" else 5) + 1
    return num_class + 1 + num_group


def _group_slices(group_ids: List[List[int]]):
    """(start, n_logits) per group in the extended layout, from 1; then the
    fg / bg pair's."""
    slices, start = [], 1
    for ids in group_ids:
        slices.append((start, len(ids) + 1))
        start += len(ids) + 1
    return slices, (start, 2)


_IDS: dict = {}


def _ids(ids, device) -> torch.Tensor:
    """The class ids `ids` as an int64 tensor on `device`, made once (a
    copy to the card would stop the host on every step)."""
    key = (tuple(ids), str(device))
    if key not in _IDS:
        _IDS[key] = torch.as_tensor(list(ids), dtype=torch.int64,
                                    device=device)
    return _IDS[key]


def _isin(x: torch.Tensor, ids) -> torch.Tensor:
    return (x[:, None] == _ids(ids, x.device)[None, :]).any(1)


def group_softmax_loss_extended(
        ext_logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
        *, num_class: int, class_names: Optional[Sequence[str]] = None,
        version: str = "bgfg", ignore_index: int = 0, beta: float = 8.0,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """JAX ``group_softmax_loss_extended``. `draws`, one [N] uniform tensor
    per non-empty group, are its Bernoulli draws (kept where draw < keep
    probability, as ``jax.random.bernoulli``); without them they come from
    `generator`, and without a generator the 'others' rows are weighted by
    the keep probability instead."""
    class_names = _default_names(class_names, num_class)
    group_ids, fgbg_ids = group_structure(class_names, version)
    slices, (fg_start, _) = _group_slices(group_ids)
    if ext_logits.shape[1] != fg_start + 2:
        raise ValueError(
            f"extended head width {ext_logits.shape[1]} != "
            f"{group_softmax_channel_num(num_class, version)}")
    lf = ext_logits.float()
    mask = valid & (labels != ignore_index) & (labels >= 0) & (
        labels < num_class)
    mf = mask.float()
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    total = lf[:0].sum()     # 0, and on the graph where no group adds
    g = 0
    for ids, (start, n_log) in zip(group_ids, slices):
        if not ids:      # an empty group keeps its 'others' channel only
            continue
        ids_t = _ids(ids, lf.device)
        in_group = _isin(safe, ids) & mask
        pos = (safe[:, None] == ids_t[None, :]).int().argmax(1)
        tgt = torch.where(in_group, pos + 1, torch.zeros_like(pos))
        logp = torch.log_softmax(lf[:, start:start + n_log], dim=1)
        nll = -logp.gather(1, tgt[:, None])[:, 0]
        fg_num = in_group.float().sum()
        others = mask & ~in_group
        keep_p = (beta * fg_num / others.float().sum().clamp(min=1.0)
                  ).clamp(0.0, 1.0)
        if draws is not None or generator is not None:
            u = (draws[g] if draws is not None else
                 torch.rand(labels.shape, generator=generator,
                            device=lf.device))
            w = (in_group | (others & (u < keep_p))).float()
        else:
            w = torch.where(in_group, 1.0, torch.where(others, keep_p, 0.0))
        w = torch.where(fg_num > 0, w, 0.0)
        total = total + (nll * w * mf).sum() / (w * mf).sum().clamp(min=1.0)
        g += 1
    is_bg = _isin(safe, fgbg_ids[1]).long()
    logp = torch.log_softmax(lf[:, fg_start:fg_start + 2], dim=1)
    nll = -logp.gather(1, is_bg[:, None])[:, 0]
    return total + (nll * mf).sum() / mf.sum().clamp(min=1.0)


def group_softmax_activation(ext_logits: torch.Tensor, *, num_class: int,
                             class_names: Optional[Sequence[str]] = None,
                             version: str = "bgfg",
                             bgfg_weight: bool = True) -> torch.Tensor:
    """Extended-head logits -> [N, num_class] class scores: each group's
    softmax probabilities of its class channels, times the fg / bg
    probability of the group's side (JAX ``group_softmax_activation``)."""
    class_names = _default_names(class_names, num_class)
    group_ids, fgbg_ids = group_structure(class_names, version)
    slices, (fg_start, _) = _group_slices(group_ids)
    lf = ext_logits.float()
    act = lf.new_zeros((lf.shape[0], num_class))
    bg_prob = torch.softmax(lf[:, fg_start:fg_start + 2], dim=1)
    for ids, (start, n_log) in zip(group_ids, slices):
        if ids:
            act[:, _ids(ids, lf.device)] = torch.softmax(
                lf[:, start:start + n_log], dim=1)[:, 1:]
    if bgfg_weight:
        for side, ids in enumerate(fgbg_ids):
            if ids:
                cols = _ids(ids, lf.device)
                act[:, cols] = act[:, cols] * bg_prob[:, side:side + 1]
    return act


def eqlv2_init_state(num_class: int, device=None) -> Dict[str, torch.Tensor]:
    """The zero buffers of the first step (JAX ``eqlv2_init_state``)."""
    z = torch.zeros(num_class - 1, dtype=torch.float32, device=device)
    return {"pos_grad": z, "neg_grad": z.clone()}


def eqlv2_loss(logits: torch.Tensor, labels: torch.Tensor,
               valid: torch.Tensor, *,
               state: Optional[Dict[str, torch.Tensor]] = None,
               ignore_index: int = 0, gamma: float = 12.0, mu: float = 0.8,
               alpha: float = 4.0, group=None):
    """JAX ``eqlv2_loss``: the loss, or (loss, new state) with `state`.
    The buffers collect over every valid row, ignored labels included (as
    JAX and the reference do); `group` sums a step's collection over its
    ranks."""
    n, c = logits.shape
    if ignore_index != 0:
        raise ValueError("EQLv2's layout leaves out class 0: ignore_index "
                         "must be 0")
    vf = valid.float()
    mask = valid & (labels != ignore_index) & (labels >= 0) & (labels < c)
    mf = mask.float()
    in_range = valid & (labels >= 0) & (labels < c)
    safe = torch.where(in_range, labels, torch.zeros_like(labels)).long()
    target = F.one_hot(safe, c).float() * vf[:, None]
    lf = logits.float()
    probs = torch.sigmoid(lf)

    def ramp(ratio):
        return 1.0 / (1.0 + torch.exp(-gamma * (ratio - mu)))

    if state is None:
        g = (probs - target).abs() * mf[:, None]
        pos_grad = (g * target).sum(0)
        neg_grad = (g * (1.0 - target)).sum(0)
        neg_w = ramp(pos_grad / neg_grad.clamp(min=1e-10))
    else:
        pos_g, neg_g = state["pos_grad"], state["neg_grad"]
        uninit = (pos_g.sum() + neg_g.sum()) == 0.0
        ramped = torch.cat([lf.new_ones(1), ramp(pos_g / (neg_g + 1e-10))])
        neg_w = torch.where(uninit, torch.ones_like(ramped), ramped)
    pos_w = 1.0 + alpha * (1.0 - neg_w)
    w = target * pos_w[None, :] + (1.0 - target) * neg_w[None, :]
    bce = -(target * F.logsigmoid(lf) + (1.0 - target) * F.logsigmoid(-lf))
    loss = (bce * w * mf[:, None]).sum() / (mf.sum() + 1e-10)
    if state is None:
        return loss
    with torch.no_grad():
        g = (probs - target).abs() * w * vf[:, None]
        d = torch.stack([(g * target).sum(0)[1:],
                         (g * (1.0 - target)).sum(0)[1:]])
        if group is not None:
            d = all_reduce_sum(d, group)
    return loss, {"pos_grad": state["pos_grad"] + d[0],
                  "neg_grad": state["neg_grad"] + d[1]}


def group_softmax_loss(logits: torch.Tensor, labels: torch.Tensor,
                       valid: torch.Tensor, *,
                       class_names: Optional[Sequence[str]] = None,
                       groups: Optional[List[List[str]]] = None,
                       ignore_index: int = 0,
                       beta: float = 8.0) -> torch.Tensor:
    """JAX ``group_softmax_loss``: per class group a softmax CE over its
    classes and an 'others' logit (the logsumexp outside the group), the
    others rows weighted by min(1, beta x the group's share), plus the
    fg / bg pair of logsumexps where there are at least three groups."""
    n, c = logits.shape
    class_names = _default_names(class_names, c)
    groups = groups if groups is not None else WAYMO_GROUPS
    name_to_id = {nm: i for i, nm in enumerate(class_names)}
    mask = valid & (labels != ignore_index) & (labels >= 0) & (labels < c)
    mf = mask.float()
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    lf = logits.float()
    total = lf[:0].sum()     # 0, and on the graph where no group adds
    group_ids = []
    for names in groups:
        ids = [name_to_id[nm] for nm in names if nm in name_to_id]
        if not ids:
            continue
        group_ids.append(ids)
        ids_t = _ids(ids, lf.device)
        in_group = _isin(safe, ids) & mask
        other = torch.ones(c, dtype=torch.bool, device=lf.device)
        other[ids_t] = False
        others_logit = torch.logsumexp(
            torch.where(other[None, :], lf, float("-inf")), dim=1,
            keepdim=True)
        logp = torch.log_softmax(torch.cat([lf[:, ids_t], others_logit], 1),
                                 dim=1)
        pos = (safe[:, None] == ids_t[None, :]).int().argmax(1)
        tgt = torch.where(in_group, pos, torch.full_like(pos, len(ids)))
        nll = -logp.gather(1, tgt[:, None])[:, 0]
        keep_p = (beta * (in_group.float() * mf).sum()
                  / mf.sum().clamp(min=1.0)).clamp(0.0, 1.0)
        w = torch.where(in_group, 1.0, keep_p)
        total = total + (nll * mf * w).sum() / (mf * w).sum().clamp(min=1.0)
    if len(group_ids) >= 3:
        fg_ids = sum(group_ids[:3], [])
        is_fg = _isin(safe, fg_ids).long()
        fg_t = _ids(fg_ids, lf.device)
        bg_cols = ~(torch.arange(c, device=lf.device)[:, None]
                    == fg_t[None, :]).any(1)
        pair = torch.stack([
            torch.logsumexp(torch.where(bg_cols[None, :], lf, float("-inf")),
                            dim=1),
            torch.logsumexp(lf[:, fg_t], dim=1)], dim=1)
        nll = -torch.log_softmax(pair, dim=1).gather(1, is_fg[:, None])[:, 0]
        total = total + (nll * mf).sum() / mf.sum().clamp(min=1.0)
    return total
