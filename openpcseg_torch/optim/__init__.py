"""Optimizer and LR schedule builders.

Counterpart of ``openpcseg_tpu/optim/__init__.py`` for the mk34 recipe
(OPTIMIZER sgd, SCHEDULER linear_warmup_with_cosdecay) and the range
recipe (adamw, onecycle):

- sgd: the JAX chain clip_by_global_norm -> add_decayed_weights ->
  trace(nesterov) -> lr is, step for step, ``torch.nn.utils.
  clip_grad_norm_(GRAD_NORM_CLIP)`` (which ``SegTask`` applies) followed
  by ``torch.optim.SGD(momentum, nesterov, weight_decay)`` at the
  scheduled lr: torch adds the L2 term to the gradient before the
  momentum trace, as optax does.
- adamw: clip -> scale_by_adam(BETA1, BETA2, EPS) -> add_decayed_weights
  -> lr is the clip and ``torch.optim.AdamW``: p - lr (m^ / (sqrt(v^) +
  eps) + wd p), with m^ and v^ the bias-corrected moments.
- onecycle: ``optax.cosine_onecycle_schedule(total steps, OPTIM.
  LEARNING_RATE, pct_start=0.2, div_factor=25, final_div_factor=100)``,
  an absolute lr (the linear scaling rule does not touch it).

The other optimizers (adam, sgd_fc, adam_onecycle) and schedulers of the
JAX package are still to be ported (ROADMAP.md Queue 1 item 15).
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Tuple

import torch


def _linear_warmup_cosdecay(warmup_steps: int, total_steps: int,
                            min_scale: float = 1e-5) -> Callable:
    """The reference formula, including its quirk: the cosine ratio is
    (step - warmup) / total, so the decay never quite reaches its floor."""
    def factor(step):
        if step < warmup_steps:
            return (1 - min_scale) * step / max(warmup_steps, 1) + min_scale
        ratio = (step - warmup_steps) / total_steps
        return ((1 - min_scale) * 0.5 * (1 + math.cos(math.pi * ratio))
                + min_scale)
    return factor


def cosine_onecycle(total_steps: int, peak: float, pct_start: float = 0.2,
                    div_factor: float = 25.0,
                    final_div_factor: float = 100.0) -> Callable:
    """optax.cosine_onecycle_schedule: from peak / div_factor up to peak
    over the first int(pct_start * total_steps) steps, then down to
    peak / (div_factor * final_div_factor) at total_steps, each a cosine
    interpolation end + (start - end) / 2 (cos(pi pct) + 1), and flat
    after. Where int(pct_start * total_steps) is 0 the climb has no step
    and the schedule starts at the peak (optax divides 0 by 0 there and
    returns NaN for every step)."""
    b1, b2 = int(pct_start * total_steps), int(total_steps)
    v0 = peak / div_factor
    v1 = v0 * div_factor
    v2 = v1 * (1.0 / (div_factor * final_div_factor))

    def cos(start, end, pct):
        return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)

    def lr(step):
        if step < b1:
            return cos(v0, v1, step / b1)
        if step < b2:
            return cos(v1, v2, (step - b1) / (b2 - b1))
        return v2
    return lr


def build_lr_schedule(optim_cfg, iters_per_epoch: int,
                      total_epochs: int) -> Callable:
    """lr(step) in absolute units: the schedule factor times OPTIM.LR, or
    onecycle's own absolute lr."""
    base_lr = optim_cfg["LR"]
    warmup_steps = optim_cfg.get("WARMUP_EPOCH", 1) * iters_per_epoch
    total_steps = total_epochs * iters_per_epoch
    name = optim_cfg.get("SCHEDULER", "linear_warmup_with_cosdecay")
    if name == "onecycle":
        return cosine_onecycle(
            total_steps, optim_cfg.get("LEARNING_RATE", base_lr))
    if name != "linear_warmup_with_cosdecay":
        raise NotImplementedError(f"SCHEDULER {name!r} is not ported yet "
                                  "(ROADMAP.md Queue 1 item 15)")
    factor = _linear_warmup_cosdecay(warmup_steps, total_steps)
    return lambda step: base_lr * factor(step)


def build_optimizer(optim_cfg, params: Iterable[torch.nn.Parameter],
                    iters_per_epoch: int, total_epochs: int
                    ) -> Tuple[torch.optim.Optimizer, Callable]:
    """(torch optimizer, lr(step)). OPTIM.LR must already hold the linear
    scaling rule LR = LR_PER_SAMPLE * batch * devices (SegTask applies
    it); the caller sets each step's lr and clips the gradients first."""
    name = optim_cfg["OPTIMIZER"]
    if name not in ("sgd", "adamw"):
        raise NotImplementedError(f"OPTIMIZER {name!r} is not ported yet "
                                  "(ROADMAP.md Queue 1 item 15)")
    lr_fn = build_lr_schedule(optim_cfg, iters_per_epoch, total_epochs)
    if name == "adamw":
        opt = torch.optim.AdamW(
            params, lr=lr_fn(0), betas=(optim_cfg.get("BETA1", 0.9),
                                        optim_cfg.get("BETA2", 0.999)),
            eps=optim_cfg.get("EPS", 1e-8),
            weight_decay=optim_cfg.get("WEIGHT_DECAY", 0.0))
        return opt, lr_fn
    opt = torch.optim.SGD(params, lr=lr_fn(0),
                          momentum=optim_cfg.get("MOMENTUM", 0.9),
                          nesterov=bool(optim_cfg.get("NESTEROV", False)),
                          weight_decay=optim_cfg.get("WEIGHT_DECAY", 0.0))
    return opt, lr_fn
