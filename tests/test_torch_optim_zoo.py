"""Port parity for every optimizer and LR scheduler of the JAX package
(``openpcseg_torch/optim``) against ``openpcseg_tpu/optim``'s optax
chains, on the CPU.

Each OPTIMIZER (sgd, sgd_fc, adam, adamw; adam_onecycle, which takes no
SCHEDULER) under each SCHEDULER (linear_warmup_with_cosdecay,
cos_warmup_with_cosdecay, linear_warmup_with_stepdecay,
coswarmup_with_stepdecay, onecycle, none, constant) takes 30 steps of the
same seeded gradients, some below and some above the clip norm, on two
parameters: one plain, one under a module named ``classifier`` (sgd_fc's
10x). The port clips with ``clip_grad_norm_``, sets the step's
hyperparameters with ``set_step`` and steps the torch optimizer, as
``SegTask`` does; JAX runs its chain (clip inside). After every step the
parameters agree at rtol 1e-4, atol 1e-6 (float32 updates of up to 0.5 a
step; optax evaluates the schedules in float32, the port in float64, so
the lrs differ by float32 rounding, held at rtol 1e-6 with an atol of
2e-7 x LR as tests/test_torch_train.py's schedule test does).
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from openpcseg_tpu.config import CfgDict
from openpcseg_tpu.optim import build_optimizer as jx_build_optimizer
from openpcseg_torch.optim import build_optimizer, set_step

ITERS, EPOCHS, STEPS = 5, 6, 30
SCHEDULERS = ("linear_warmup_with_cosdecay", "cos_warmup_with_cosdecay",
              "linear_warmup_with_stepdecay", "coswarmup_with_stepdecay",
              "onecycle", "none", "constant")
CASES = [(o, s) for o in ("sgd", "sgd_fc", "adam", "adamw")
         for s in SCHEDULERS] + [("adam_onecycle", None)]
SHAPES = {"w": (5, 3), "classifier": (3, 2)}


def _cfg(opt, sched):
    lr = 0.05 if opt.startswith("sgd") else 0.01
    cfg = {"OPTIMIZER": opt, "LR": lr, "WEIGHT_DECAY": 1e-3,
           "MOMENTUM": 0.9, "NESTEROV": True, "GRAD_NORM_CLIP": 10.0,
           "WARMUP_EPOCH": 1, "DECAY_EPOCHS": [2, 4],
           "DECAY_SCALES": [0.1, 0.1], "LEARNING_RATE": lr,
           "BETA1": 0.9, "BETA2": 0.99, "MOMS": [0.95, 0.85],
           "DIV_FACTOR": 10.0, "PCT_START": 0.4}
    if sched is not None:
        cfg["SCHEDULER"] = sched
    return cfg


@pytest.mark.parametrize("opt,sched", CASES,
                         ids=[f"{o}-{s}" for o, s in CASES])
def test_trajectory_matches_optax(opt, sched):
    rng = np.random.default_rng(0)
    cfg = _cfg(opt, sched)
    tx, jlr = jx_build_optimizer(CfgDict(cfg), ITERS, EPOCHS)
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}
    jp = {"w": jnp.asarray(init["w"]),
          "classifier": {"kernel": jnp.asarray(init["classifier"])}}
    jstate = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.as_tensor(v)) for k, v in init.items()}
    named = [("w", tp["w"]), ("classifier.weight", tp["classifier"])]
    topt, tlr = build_optimizer(cfg, named, ITERS, EPOCHS)
    if opt == "sgd_fc":
        assert [g.get("lr_scale", 1.0) for g in topt.param_groups] == [
            1.0, 10.0]
        assert topt.param_groups[1]["params"][0] is tp["classifier"]
    update = jax_update(tx)
    for step in range(STEPS):
        scale = (0.1, 3.0, 20.0, 1.0, 50.0)[step % 5]
        grads = {k: (scale * rng.normal(size=s)).astype(np.float32)
                 for k, s in SHAPES.items()}
        jg = {"w": jnp.asarray(grads["w"]),
              "classifier": {"kernel": jnp.asarray(grads["classifier"])}}
        jp, jstate = update(jg, jstate, jp)
        for k, p in tp.items():
            p.grad = torch.as_tensor(grads[k])
        torch.nn.utils.clip_grad_norm_(list(tp.values()),
                                       cfg["GRAD_NORM_CLIP"])
        lr = set_step(topt, tlr, step)
        np.testing.assert_allclose(lr, float(jlr(step)), rtol=1e-6,
                                   atol=2e-7 * cfg["LR"])
        topt.step()
        for k, want in (("w", jp["w"]), ("classifier",
                                         jp["classifier"]["kernel"])):
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(want), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{k} step {step}")


def jax_update(tx):
    def f(g, state, params):
        upd, state = tx.update(g, state, params)
        return optax.apply_updates(params, upd), state
    return f


def test_adam_onecycle_anneals_b1_against_the_lr():
    """fastai's schedule: the lr climbs from LR / DIV_FACTOR to LR over the
    first PCT_START of the steps while b1 falls from MOMS[0] to MOMS[1],
    then both return, the lr to LR / DIV_FACTOR / 1e4."""
    cfg = _cfg("adam_onecycle", None)
    p = torch.nn.Parameter(torch.zeros(2))
    opt, lr_fn = build_optimizer(cfg, [p], ITERS, EPOCHS)
    a1 = int(STEPS * cfg["PCT_START"])
    assert lr_fn(0) == pytest.approx(cfg["LR"] / 10)
    assert lr_fn(a1) == pytest.approx(cfg["LR"])
    assert lr_fn(STEPS) == pytest.approx(cfg["LR"] / 10 / 1e4)
    assert lr_fn.b1(0) == pytest.approx(0.95)
    assert lr_fn.b1(a1) == pytest.approx(0.85)
    set_step(opt, lr_fn, a1)
    assert opt.param_groups[0]["betas"] == (pytest.approx(0.85), 0.99)
    assert opt.param_groups[0]["weight_decay"] == cfg["WEIGHT_DECAY"]


def test_unknown_names_raise():
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(NotImplementedError, match="rmsprop"):
        build_optimizer(_cfg("rmsprop", "none"), p, ITERS, EPOCHS)
    with pytest.raises(NotImplementedError, match="poly"):
        build_optimizer(_cfg("sgd", "poly"), p, ITERS, EPOCHS)
    with pytest.raises(ValueError, match="named parameters"):
        build_optimizer(_cfg("sgd_fc", "none"), p, ITERS, EPOCHS)
