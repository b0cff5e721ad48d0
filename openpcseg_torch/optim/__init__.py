"""Optimizer and LR schedule builders.

Counterpart of ``openpcseg_tpu/optim/__init__.py``: OPTIMIZER sgd,
sgd_fc, adam, adamw or adam_onecycle; SCHEDULER
linear_warmup_with_cosdecay, cos_warmup_with_cosdecay,
linear_warmup_with_stepdecay, coswarmup_with_stepdecay, onecycle, none
or constant. Each optax chain is a torch optimizer whose groups take the
scheduled lr each step (``set_step``); the clip by global norm
(GRAD_NORM_CLIP) is ``torch.nn.utils.clip_grad_norm_``, which ``SegTask``
applies first:

- sgd: add_decayed_weights -> trace(nesterov) -> lr is ``torch.optim.SGD
  (momentum, nesterov, weight_decay)``: torch adds the L2 term to the
  gradient before the momentum trace, as optax does.
- sgd_fc: sgd with a 10x lr on the parameters under a module named
  exactly ``classifier`` (JAX's per-leaf ``optax.scale(10)`` after the
  lr), as a param group whose ``lr_scale`` is 10.
- adam: add_decayed_weights -> scale_by_adam() -> lr is ``torch.optim.
  Adam(weight_decay)``: L2 into the gradient, optax's default betas and
  eps.
- adamw: scale_by_adam(BETA1, BETA2, EPS) -> add_decayed_weights -> lr is
  ``torch.optim.AdamW``: p - lr (m^ / (sqrt(v^) + eps) + wd p), with m^
  and v^ the bias-corrected moments.
- adam_onecycle: fastai's OneCycle (``_fastai_onecycle``): the lr and
  Adam's b1 annealed in antiphase, b2 = 0.99, decoupled weight decay:
  ``torch.optim.AdamW`` whose betas[0] ``set_step`` sets each step (both
  optax and torch correct the first moment's bias with the current b1).
- onecycle: ``optax.cosine_onecycle_schedule(total steps, OPTIM.
  LEARNING_RATE, pct_start=0.2, div_factor=25, final_div_factor=100)``,
  an absolute lr (the linear scaling rule does not touch it).
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


def _cos_warmup_cosdecay(warmup_steps: int, total_steps: int,
                         min_scale: float = 1e-5) -> Callable:
    """The cosine decay of _linear_warmup_cosdecay after a half-cosine
    warm-up from min_scale to 1."""
    decay = _linear_warmup_cosdecay(warmup_steps, total_steps, min_scale)

    def factor(step):
        if step < warmup_steps:
            return ((1 - min_scale) * (1 - math.cos(
                math.pi * step / max(warmup_steps, 1))) / 2 + min_scale)
        return decay(step)
    return factor


def _warmup_stepdecay(warmup_steps: int, decay_steps, decay_scales,
                      cos_warmup: bool = False) -> Callable:
    """A linear (or half-cosine) warm-up from 0 to 1, then the product of
    the scales of every decay step reached."""
    def factor(step):
        if step < warmup_steps:
            pct = step / max(warmup_steps, 1)
            return (1 - math.cos(math.pi * pct)) / 2 if cos_warmup else pct
        out = 1.0
        for s, sc in zip(decay_steps, decay_scales):
            if step >= s:
                out *= sc
        return out
    return factor


def _anneal(start: float, end: float, pct: float) -> float:
    return end + (start - end) / 2 * (math.cos(math.pi * pct) + 1)


class FastaiOneCycle:
    """fastai's OneCycle (JAX ``_fastai_onecycle``): the lr from lr_max /
    div_factor up to lr_max over the first int(total x pct_start) steps,
    then down to lr_max / div_factor / 1e4; Adam's b1 from moms[0] to
    moms[1] and back, each phase a cosine anneal. Called, it is the lr;
    ``b1(step)`` is the first moment's decay."""

    def __init__(self, lr_max: float, moms, div_factor: float,
                 pct_start: float, total_steps: int):
        self.a1 = int(total_steps * pct_start)
        self.total = total_steps
        self.lr_max, self.low = lr_max, lr_max / div_factor
        self.moms = tuple(moms)

    def _phase(self, step, first, second):
        if step < self.a1:
            return _anneal(*first, step / max(self.a1, 1))
        return _anneal(*second, (step - self.a1)
                       / max(self.total - self.a1, 1))

    def __call__(self, step: int) -> float:
        return self._phase(step, (self.low, self.lr_max),
                           (self.lr_max, self.low / 1e4))

    def b1(self, step: int) -> float:
        m0, m1 = self.moms
        return self._phase(step, (m0, m1), (m1, m0))


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
    if name == "linear_warmup_with_cosdecay":
        factor = _linear_warmup_cosdecay(warmup_steps, total_steps)
    elif name == "cos_warmup_with_cosdecay":
        factor = _cos_warmup_cosdecay(warmup_steps, total_steps)
    elif name in ("linear_warmup_with_stepdecay", "coswarmup_with_stepdecay"):
        factor = _warmup_stepdecay(
            warmup_steps,
            [e * iters_per_epoch for e in optim_cfg["DECAY_EPOCHS"]],
            optim_cfg["DECAY_SCALES"],
            cos_warmup=name == "coswarmup_with_stepdecay")
    elif name in ("none", "constant"):
        return lambda step: base_lr
    else:
        raise NotImplementedError(f"SCHEDULER {name!r}")
    return lambda step: base_lr * factor(step)


def build_optimizer(optim_cfg, params: Iterable, iters_per_epoch: int,
                    total_epochs: int
                    ) -> Tuple[torch.optim.Optimizer, Callable]:
    """(torch optimizer, lr(step)). `params` are parameters, or (name,
    parameter) pairs (``named_parameters()``), which sgd_fc needs to find
    the classifier. OPTIM.LR must already hold the linear scaling rule LR
    = LR_PER_SAMPLE * batch * devices (SegTask applies it); the caller
    clips the gradients, then sets each step's hyperparameters with
    ``set_step``."""
    name = optim_cfg["OPTIMIZER"]
    wd = optim_cfg.get("WEIGHT_DECAY", 0.0)
    params = list(params)
    named = bool(params) and isinstance(params[0], tuple)
    if name == "adam_onecycle":
        lr_fn = FastaiOneCycle(
            optim_cfg["LR"], optim_cfg.get("MOMS", (0.95, 0.85)),
            float(optim_cfg.get("DIV_FACTOR", 10.0)),
            float(optim_cfg.get("PCT_START", 0.4)),
            total_epochs * iters_per_epoch)
    else:
        lr_fn = build_lr_schedule(optim_cfg, iters_per_epoch, total_epochs)
    if name == "sgd_fc":
        if not named:
            raise ValueError("sgd_fc needs named parameters to find the "
                             "classifier")
        fc = [p for n, p in params if "classifier" in n.split(".")]
        base = [p for n, p in params if "classifier" not in n.split(".")]
        groups = [{"params": base}] + (
            [{"params": fc, "lr_scale": 10.0}] if fc else [])
    else:
        groups = [p for _, p in params] if named else params
    if name in ("sgd", "sgd_fc"):
        opt = torch.optim.SGD(groups, lr=lr_fn(0),
                              momentum=optim_cfg.get("MOMENTUM", 0.9),
                              nesterov=bool(optim_cfg.get("NESTEROV", False)),
                              weight_decay=wd)
    elif name == "adam":
        opt = torch.optim.Adam(groups, lr=lr_fn(0), weight_decay=wd)
    elif name == "adamw":
        opt = torch.optim.AdamW(
            groups, lr=lr_fn(0), betas=(optim_cfg.get("BETA1", 0.9),
                                        optim_cfg.get("BETA2", 0.999)),
            eps=optim_cfg.get("EPS", 1e-8), weight_decay=wd)
    elif name == "adam_onecycle":
        opt = torch.optim.AdamW(groups, lr=lr_fn(0),
                                betas=(lr_fn.b1(0), 0.99), weight_decay=wd)
    else:
        raise NotImplementedError(f"OPTIMIZER {name!r}")
    return opt, lr_fn


def set_step(optimizer: torch.optim.Optimizer, lr_fn: Callable,
             step: int) -> float:
    """Each param group's hyperparameters at `step`: the lr times the
    group's ``lr_scale`` (sgd_fc's classifier: 10), and where `lr_fn`
    anneals Adam's b1 (adam_onecycle) the group's betas[0]. Returns the
    lr."""
    lr = lr_fn(step)
    b1 = getattr(lr_fn, "b1", None)
    for group in optimizer.param_groups:
        group["lr"] = lr * group.get("lr_scale", 1.0)
        if b1 is not None:
            group["betas"] = (b1(step), group["betas"][1])
    return lr
