"""Shared set-up of the port parity for ``MODEL.MULTI_SCALE`` of SPVCNN
and RPVNet (tests/test_torch_multiscale_<model>.py) against the
JAX package on the CPU: under any value but "concat" (JAX's default) the
classifier reads the last gate's point features z3 alone, cs[8] x
expansion wide (JAX spvcnn.py:142-145, rpvnet.py:232-235).

The tiny models and inputs of tests/test_torch_spvcnn.py (two 2500-point
synthetic scans) and tests/test_torch_rpvnet.py (two ray-cast scans as
16 x 256 fusion batches, dropout neutralised on both sides) with
``MULTI_SCALE: "none"``; seeded numpy draws in the shapes of JAX's
variables give them (tests/jax_ckpt_parity.py ``init_variables``: BN
leaves perturbed), ``jax_params_to_torch`` fills the port's narrower
classifier, and JAX's steps compile at XLA's backend optimisation level
0 (``FAST_COMPILE``). Compared, float32 both sides:

- the classifier's width: cs[8] inputs on both sides;
- the eval logits within the files' tolerances: SPVCNN's at rtol = atol =
  1e-3, RPVNet's within 1e-4 of their largest value;
- one train step's loss at rtol 1e-5 (both files), and the classifier's
  raw gradient at rtol = atol = 1e-4 (both files hold every gradient so).
  RPVNet's file holds its step against JAX's float64 one, since XLA's
  float32 step strays up to 0.11 of point_transforms.0.linear.weight's
  scale on these mostly empty images; the head's loss and gradient are
  held here against JAX's float32 step, within the same bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from range_parity import no_dropout
from jax_ckpt_parity import FAST_COMPILE, SCRIPT, init_variables
from test_torch_rpvnet import CFGS as RPV_CFGS
from test_torch_rpvnet import fusion_batch, no_flax_dropout
from test_torch_spvcnn import CFGS as SPV_CFGS
from test_torch_train import OPTIM, _grad_stash

from openpcseg_tpu.config import CfgDict
from openpcseg_tpu.engine import SegTask as JaxSegTask
from openpcseg_tpu.engine import TrainState
from openpcseg_torch.data.synthetic import synthetic_batch
from openpcseg_torch.engine.task import SegTask, batch_to_device
from openpcseg_torch.utils.convert import jax_params_to_torch

B, NUM_CLASS = 2, 20


def _cfgs(cfgs):
    return dict(cfgs, MODEL=dict(cfgs["MODEL"], MULTI_SCALE="none"))


CASES = {
    "SPVCNN": (_cfgs(SPV_CFGS), 1e-3,
               lambda: synthetic_batch(0, B, n_points=2500,
                                       num_class=NUM_CLASS)),
    "RPVNet": (_cfgs(RPV_CFGS), None, lambda: fusion_batch([0, 1])),
}


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def make_sides(name):
    """JAX's and the port's readings of `name` under MULTI_SCALE none."""
    cfgs, _, make_batch = CASES[name]
    batch = make_batch()
    rng = np.random.default_rng(0)
    jtask = JaxSegTask(CfgDict(cfgs), num_class=NUM_CLASS,
                       batch_per_device=B, iters_per_epoch=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params, stats = init_variables(jtask, jb, cfgs, SCRIPT.template(
        jtask, batch), rng)

    def jax_eval(params, stats, b):
        vb, pyr = jtask.preprocess(b)
        return jtask.model.apply({"params": params, "batch_stats": stats},
                                 jtask._model_inputs(vb, b), pyr,
                                 train=False)

    j = dict(logits=np.asarray(jax.jit(jax_eval).lower(
        params, stats, jb).compile(compiler_options=FAST_COMPILE)(
            params, stats, jb)),
             width=params["classifier"]["kernel"].shape[0])
    with pytest.MonkeyPatch.context() as mp:
        no_flax_dropout(mp)
        jtask.tx = optax.chain(_grad_stash(), jtask.tx)
        st = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=stats, opt_state=jtask.tx.init(params),
                        loss_state=jtask.losses.init_state(NUM_CLASS))
        key = jax.random.PRNGKey(1)
        new, m = jax.jit(jtask.train_step).lower(st, jb, key).compile(
            compiler_options=FAST_COMPILE)(st, jb, key)
        j["loss"] = float(m["loss"])
        j["grad"] = np.asarray(new.opt_state[0]["classifier"]["kernel"]).T

    task = SegTask(cfgs, NUM_CLASS, device="cpu", batch_per_device=B,
                   iters_per_epoch=2, seed=1)
    no_dropout(task.model)
    jax_params_to_torch(params, stats, task.model)
    tb = batch_to_device(batch, "cpu")
    t = dict(logits=task.forward(tb)[2].detach().numpy(),
             width=task.model.classifier.in_features)
    m = task.train_step(tb)
    coef = min(1.0, OPTIM["GRAD_NORM_CLIP"] / (float(m["grad_norm"]) + 1e-6))
    t["loss"] = float(m["loss"])
    t["grad"] = task.model.classifier.weight.grad.numpy() / coef
    return name, j, t


def check_classifier_reads_z3_alone(sides):
    name, j, t = sides
    cs8 = int(CASES[name][0]["MODEL"]["PLANES"][8]
              * CASES[name][0]["MODEL"]["cr"])
    assert t["width"] == j["width"] == cs8


def check_eval_logits_match(sides):
    name, j, t = sides
    assert t["logits"].shape == j["logits"].shape
    assert np.isfinite(t["logits"]).all()
    tol = CASES[name][1]
    if tol is None:
        assert _rel(t["logits"], j["logits"]) <= 1e-4
    else:
        np.testing.assert_allclose(t["logits"], j["logits"], rtol=tol,
                                   atol=tol)


def check_train_step_loss_and_head_gradient_match(sides):
    _, j, t = sides
    np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
    np.testing.assert_allclose(t["grad"], j["grad"], rtol=1e-4, atol=1e-4)
    assert np.abs(j["grad"]).max() > 1e-4
