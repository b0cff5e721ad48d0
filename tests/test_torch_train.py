"""Port parity, part (d): the voxel training step of MinkUNet.

The tiny MinkUNet of tests/test_torch_minkunet.py (one stage of 3 blocks,
so JAX stacks blocks 2..3 in StackedBlocks) takes 3 SGD steps on the
8192-point ray-cast scan in float32 on both sides, from the same variables
(JAX's init_state with seeded perturbations of the BN leaves, loaded into
the port by jax_params_to_torch). JAX's own jitted ``SegTask.train_step``
runs, with an optax transform at the head of its chain that keeps the raw
gradients in the optimizer state; they are loaded into a twin model
through jax_params_to_torch and compared by parameter. Tolerances:

- loss of each step: rtol 1e-5 (one float32 sum over 8k voxels; measured
  1.2e-7);
- gradients of step 1, per tensor: max|port - JAX| <= 1e-4 * max|JAX|.
  Float32 through ~20 layers of batch-statistics BN (which divides by
  per-channel standard deviations) in another summation order; measured
  at most 1.8e-6 of a tensor's scale. A swap of two near-tied errors in the
  Lovász sort would move single entries by a few 1e-5 of the scale (the
  difference of neighbouring Lovász gradient values), still inside;
- BN running statistics after step 1: rtol = atol = 1e-5 (an EMA of
  per-channel float32 sums; measured 2.4e-7);
- parameters after 3 steps: max|diff| <= 1e-5 * max|param| per tensor
  (three updates of at most lr 0.02 times gradients that agree as above;
  measured 1.9e-7).

Also: the losses alone against openpcseg_tpu.losses (values and
gradients, including tied errors in the Lovász sort), the LR schedule and
the clip + SGD chain against optax, and dropout's keep rate.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_minkunet import MODEL, NUM_CLASS, TPU, _perturb
from torch_threads import one_torch_thread  # noqa: F401

from openpcseg_tpu.config import CfgDict
from openpcseg_tpu import losses as jx_losses
from openpcseg_tpu.engine import SegTask as JaxSegTask
from openpcseg_tpu.losses.ce import cross_entropy as jx_ce
from openpcseg_tpu.losses.lovasz import lovasz_softmax as jx_lovasz
from openpcseg_tpu.optim import build_lr_schedule as jx_lr_schedule
from openpcseg_tpu.optim import build_optimizer as jx_build_optimizer
from openpcseg_torch.data.raycast import raycast_batch
from openpcseg_torch.engine.task import SegTask, batch_to_device
from openpcseg_torch.losses import Losses, cross_entropy, lovasz_softmax
from openpcseg_torch.models.layers import dropout
from openpcseg_torch.optim import build_lr_schedule, build_optimizer
from openpcseg_torch.utils.convert import jax_params_to_torch

MODEL_T = dict(MODEL, LABEL_SMOOTHING=0.1)
OPTIM = {"BATCH_SIZE_PER_GPU": 1, "NUM_EPOCHS": 2, "OPTIMIZER": "sgd",
         "LR_PER_SAMPLE": 0.02, "WEIGHT_DECAY": 0.0001, "MOMENTUM": 0.9,
         "NESTEROV": True, "GRAD_NORM_CLIP": 10,
         "SCHEDULER": "linear_warmup_with_cosdecay", "WARMUP_EPOCH": 1}
ITERS_PER_EPOCH = 2      # warm-up ends at step 2: steps 0..2 see lr ramp up
STEPS = 3


def _cfgs():
    return {"DATA": {"DATASET": "semantickitti", "VOXEL_SIZE": 0.05},
            "MODEL": dict(MODEL_T), "OPTIM": dict(OPTIM), "TPU": dict(TPU)}


def _grad_stash():
    """optax transform that passes updates on and keeps them as its
    state: at the head of the chain its state is the step's raw grads."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _named(model, attr="data"):
    return {n: getattr(p, attr).detach().clone().numpy()
            for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    batch = raycast_batch(0, 1, cap=8192)
    jtask = JaxSegTask(CfgDict(_cfgs()), num_class=NUM_CLASS,
                       batch_per_device=1, iters_per_epoch=ITERS_PER_EPOCH)
    jtask.tx = optax.chain(_grad_stash(), jtask.tx)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jtask.init_state(jax.random.PRNGKey(0), jb)
    state = state.replace(params=_perturb(state.params, rng),
                          batch_stats=_perturb(state.batch_stats, rng))
    params0, stats0 = jax.device_get((state.params, state.batch_stats))
    step = jax.jit(jtask.train_step)
    j = []
    for _ in range(STEPS):
        state, m = step(state, jb, jax.random.PRNGKey(1))
        j.append(dict(jax.device_get(m), grads=jax.device_get(
            state.opt_state[0]), stats=jax.device_get(state.batch_stats),
            params=jax.device_get(state.params)))

    task = SegTask(_cfgs(), NUM_CLASS, device="cpu",
                   iters_per_epoch=ITERS_PER_EPOCH)
    assert task.caps == jtask.caps
    jax_params_to_torch(params0, stats0, task.model)
    tb = batch_to_device(batch, "cpu")
    t = []
    for _ in range(STEPS):
        m = task.train_step(tb)
        coef = min(1.0, OPTIM["GRAD_NORM_CLIP"] / (float(m["grad_norm"])
                                                    + 1e-6))
        t.append(dict(m, grads={n: g / coef for n, g in
                                _named(task.model, "grad").items()},
                      stats={n: b.clone().numpy() for n, b in
                             task.model.named_buffers()},
                      params=_named(task.model)))

    def as_torch(i, key):
        """JAX step i's tree `key`, laid out as the port's named tensors."""
        twin = SegTask(_cfgs(), NUM_CLASS, device="cpu").model
        tree = j[i][key] if key != "stats" else j[i]["params"]
        jax_params_to_torch(tree, j[i]["stats"], twin)
        if key == "stats":
            return {n: b.numpy() for n, b in twin.named_buffers()}
        return _named(twin)
    return dict(j=j, t=t, as_torch=as_torch)


def test_losses_and_metrics_match(runs):
    for jm, tm in zip(runs["j"], runs["t"]):
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert int(tm["voxel_overflow"]) == int(jm["voxel_overflow"]) == 0
        assert int(tm["num_voxels"]) == int(jm["num_voxels"])
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
    assert runs["t"][-1]["lr"] > runs["t"][0]["lr"] * 1e4


def test_every_gradient_matches(runs):
    want = runs["as_torch"](0, "grads")
    got = runs["t"][0]["grads"]
    assert set(got) == set(want)
    for n in want:
        scale = np.abs(want[n]).max()
        assert scale > 0, n
        err = np.abs(got[n] - want[n]).max()
        assert err <= 1e-4 * scale, (n, err, scale)


def test_running_statistics_match(runs):
    want = runs["as_torch"](0, "stats")
    got = runs["t"][0]["stats"]
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-5, atol=1e-5,
                                   err_msg=n)


def test_parameters_after_three_steps_match(runs):
    want = runs["as_torch"](STEPS - 1, "params")
    got = runs["t"][-1]["params"]
    first = runs["as_torch"](0, "params")
    moved = 0
    for n in want:
        scale = np.abs(want[n]).max()
        err = np.abs(got[n] - want[n]).max()
        assert err <= 1e-5 * scale, (n, err, scale)
        moved += not np.allclose(want[n], first[n])
    assert moved == len(want)


# ---------------------------------------------------------------- losses --

def _loss_inputs(rng, n=600, c=NUM_CLASS):
    logits = rng.normal(size=(n, c)).astype(np.float32)
    logits[100:140] = logits[99]            # tied rows: tied Lovász errors
    labels = rng.integers(0, c, size=n).astype(np.int32)
    labels[100:120] = labels[99]
    valid = rng.random(n) < 0.9
    return logits, labels, valid


@pytest.mark.parametrize("smoothing,weighted", [(0.0, False), (0.1, False),
                                                (0.1, True)])
def test_cross_entropy_matches_jax(rng, smoothing, weighted):
    logits, labels, valid = _loss_inputs(rng)
    cw = rng.random(NUM_CLASS).astype(np.float32) + 0.5 if weighted else None
    want, gwant = jax.value_and_grad(lambda x: jx_ce(
        x, jnp.asarray(labels), jnp.asarray(valid), ignore_index=0,
        label_smoothing=smoothing,
        class_weight=None if cw is None else jnp.asarray(cw)))(
        jnp.asarray(logits))
    x = torch.as_tensor(logits).requires_grad_()
    got = cross_entropy(x, torch.as_tensor(labels), torch.as_tensor(valid),
                        ignore_index=0, label_smoothing=smoothing,
                        class_weight=None if cw is None else
                        torch.as_tensor(cw))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gwant),
                               rtol=1e-5, atol=1e-7)


def test_lovasz_matches_jax_with_ties(rng):
    logits, labels, valid = _loss_inputs(rng)
    probas = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    want, gwant = jax.value_and_grad(lambda p: jx_lovasz(
        p, jnp.asarray(labels), jnp.asarray(valid), ignore_index=0))(probas)
    p = torch.as_tensor(np.array(probas)).requires_grad_()
    got = lovasz_softmax(p, torch.as_tensor(labels), torch.as_tensor(valid),
                         ignore_index=0)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    # the tied rows get the gradient of their rank in a stable sort
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gwant),
                               rtol=1e-5, atol=1e-7)


def test_losses_dispatch(rng):
    """Every name of JAX's set dispatches (each one's parity:
    tests/test_torch_loss_zoo.py); a sum of two equals JAX's sum."""
    assert Losses(["CELoss", "LovLoss"], [1.0, 1.0]).loss_types == [
        "CELoss", "LovLoss"]
    logits, labels, valid = _loss_inputs(rng)
    want = jx_losses.Losses(["CELoss", "FocalLoss"], [1.0, 0.5])(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(valid))
    got = Losses(["CELoss", "FocalLoss"], [1.0, 0.5])(
        torch.as_tensor(logits), torch.as_tensor(labels),
        torch.as_tensor(valid))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with pytest.raises(NotImplementedError, match="GeoLoss"):
        Losses(["CELoss", "GeoLoss"], [1.0, 1.0])


# ---------------------------------------------------------- optimization --

def test_lr_schedule_matches_jax():
    cfg = dict(OPTIM, LR=0.02)
    want = jx_lr_schedule(CfgDict(cfg), 7, 3)
    got = build_lr_schedule(cfg, 7, 3)
    # JAX evaluates the factor in float32: near the cosine's floor
    # 1 + cos(.) cancels, so the bound is float32 resolution of a factor
    # in [0, 1] (2e-7) times LR, not a relative one
    for s in range(0, 30):
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6,
                                   atol=2e-7 * cfg["LR"])
    # the other schedulers alike (tests/test_torch_optim_zoo.py steps
    # every one); a name the JAX package does not know raises
    cos = dict(cfg, SCHEDULER="cos_warmup_with_cosdecay")
    want, got = jx_lr_schedule(CfgDict(cos), 7, 3), build_lr_schedule(
        cos, 7, 3)
    for s in range(0, 30):
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6,
                                   atol=2e-7 * cfg["LR"])
    with pytest.raises(NotImplementedError, match="poly"):
        build_lr_schedule(dict(cfg, SCHEDULER="poly"), 7, 3)


def test_clip_and_sgd_match_optax(rng):
    """clip_grad_norm_ + torch SGD(momentum, nesterov, weight decay) at the
    scheduled lr against JAX's optax chain, over steps below and above the
    clip norm."""
    cfg = dict(OPTIM, LR=0.5)
    tx, lr_fn = jx_build_optimizer(CfgDict(cfg), 2, 4)
    shapes = {"a": (5, 3), "b": (7,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.as_tensor(v))
          for k, v in params.items()}
    opt, t_lr = build_optimizer(cfg, list(tp.values()), 2, 4)
    for step, scale in enumerate([0.1, 3.0, 20.0, 1.0, 50.0, 0.5]):
        grads = {k: (scale * rng.normal(size=s)).astype(np.float32)
                 for k, s in shapes.items()}
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in
                                 grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.as_tensor(grads[k])
        torch.nn.utils.clip_grad_norm_(list(tp.values()),
                                       cfg["GRAD_NORM_CLIP"])
        for g in opt.param_groups:
            g["lr"] = t_lr(step)
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-6)
    # Adam builds too (its trajectory: tests/test_torch_optim_zoo.py); a
    # name the JAX package does not know raises
    opt, _ = build_optimizer(dict(cfg, OPTIMIZER="adam"), list(tp.values()),
                             2, 4)
    assert isinstance(opt, torch.optim.Adam)
    with pytest.raises(NotImplementedError, match="rmsprop"):
        build_optimizer(dict(cfg, OPTIMIZER="rmsprop"), list(tp.values()),
                        2, 4)


def test_dropout_keep_rate():
    x = torch.ones(200_000, 4)
    y = dropout(x, 0.3, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.005
    np.testing.assert_allclose(y[kept].numpy(), 1 / 0.7, rtol=1e-6)
    assert dropout(x, 0.0, None) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.3, None)


def test_train_step_needs_an_optim_block():
    cfgs = _cfgs()
    del cfgs["OPTIM"]
    with pytest.raises(RuntimeError, match="OPTIM"):
        SegTask(cfgs, NUM_CLASS, device="cpu").train_step({})
    assert math.isclose(
        SegTask(_cfgs(), NUM_CLASS, device="cpu").optim_cfg["LR"], 0.02)
