"""Optimizer and LR schedule builders.

Counterpart of ``openpcseg_tpu/optim/__init__.py`` for the mk34 recipe:
OPTIMIZER sgd and SCHEDULER linear_warmup_with_cosdecay. The JAX chain
clip_by_global_norm -> add_decayed_weights -> trace(nesterov) -> lr is,
step for step, ``torch.nn.utils.clip_grad_norm_(GRAD_NORM_CLIP)`` (which
``SegTask.train_step`` applies) followed by ``torch.optim.SGD(momentum,
nesterov, weight_decay)`` at the scheduled lr: torch adds the L2 term to
the gradient before the momentum trace, as optax does. Every other
optimizer and scheduler of the JAX package is still to be ported.
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


def build_lr_schedule(optim_cfg, iters_per_epoch: int,
                      total_epochs: int) -> Callable:
    """lr(step) in absolute units: the schedule factor times OPTIM.LR."""
    base_lr = optim_cfg["LR"]
    warmup_steps = optim_cfg.get("WARMUP_EPOCH", 1) * iters_per_epoch
    total_steps = total_epochs * iters_per_epoch
    name = optim_cfg.get("SCHEDULER", "linear_warmup_with_cosdecay")
    if name != "linear_warmup_with_cosdecay":
        raise NotImplementedError(f"SCHEDULER {name!r} is not ported yet "
                                  "(see ROADMAP.md)")
    factor = _linear_warmup_cosdecay(warmup_steps, total_steps)
    return lambda step: base_lr * factor(step)


def build_optimizer(optim_cfg, params: Iterable[torch.nn.Parameter],
                    iters_per_epoch: int, total_epochs: int
                    ) -> Tuple[torch.optim.Optimizer, Callable]:
    """(torch optimizer, lr(step)). OPTIM.LR must already hold the linear
    scaling rule LR = LR_PER_SAMPLE * batch * devices (SegTask applies
    it); the caller sets each step's lr and clips the gradients first."""
    name = optim_cfg["OPTIMIZER"]
    if name != "sgd":
        raise NotImplementedError(f"OPTIMIZER {name!r} is not ported yet "
                                  "(see ROADMAP.md)")
    lr_fn = build_lr_schedule(optim_cfg, iters_per_epoch, total_epochs)
    opt = torch.optim.SGD(params, lr=lr_fn(0),
                          momentum=optim_cfg.get("MOMENTUM", 0.9),
                          nesterov=bool(optim_cfg.get("NESTEROV", False)),
                          weight_decay=optim_cfg.get("WEIGHT_DECAY", 0.0))
    return opt, lr_fn
