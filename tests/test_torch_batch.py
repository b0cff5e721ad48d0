"""Port parity at batch 2: the whole voxel slice of MinkUNet with two scans.

``raycast_batch(0, 2, cap=8192)`` (two ray-cast scans of 8192 points) goes
through JAX's and the port's ``SegTask`` with ``batch_per_device=2``, in
float32 on the CPU, from the same variables (the port's seeded weights in
flax's layout, their BN leaves perturbed, loaded back into the port by
``jax_params_to_torch``); JAX's eval_step and predict_step read from one
forward, as those steps compute them; the
tiny MinkUNet and cap ratios of tests/test_torch_minkunet.py, at which
JAX's ``voxel_overflow`` is 0. Compared:

- the voxel table, the inverse map and every integer table of the pyramid:
  exactly (the batch index is part of every key);
- the eval logits: rtol = atol = 1e-3, as tests/test_torch_minkunet.py;
- the histogram and the per-point predictions [2, 8192]: at least 99.9% of
  points agree (a near-tied argmax is the only excuse);
- one train step: the loss at rtol 1e-5 (tests/test_torch_train.py); each
  gradient element at rtol = atol = 1e-4 (tests/test_torch_grads.py), and
  the whole gradient vector within 1e-4 of its norm. The per-tensor bound
  of tests/test_torch_train.py (1e-4 of each tensor's own max) does not
  hold here for a few bias and up-conv tensors of levels 2-3 (up to 3.2e-4
  of their scale, 7e-7 absolute; the same with CE alone, so not Lovász
  ties): their gradients are sums that cancel to a small scale, and
  float32 rounding flips ReLUs near 0 differently in the two frameworks.
  In the port alone a 1e-6 relative change of the input features moves
  such tensors by ~1e-3 of their scale, at batch 1 as at batch 2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_minkunet import MODEL, NUM_CLASS, TPU, _perturb
from test_torch_train import OPTIM, _grad_stash, _named
from test_torch_train_ref import torch_to_jax, variable_shapes
from torch_threads import one_torch_thread  # noqa: F401

from openpcseg_tpu.config import CfgDict
from openpcseg_tpu.engine import SegTask as JaxSegTask
from openpcseg_tpu.engine import TrainState
from openpcseg_tpu.utils.metrics import confusion_matrix
from openpcseg_torch.data.raycast import raycast_batch
from openpcseg_torch.engine.task import SegTask, batch_to_device
from openpcseg_torch.utils.convert import jax_params_to_torch

B = 2
CFGS = {"DATA": {"DATASET": "semantickitti", "VOXEL_SIZE": 0.05},
        "MODEL": dict(MODEL, LABEL_SMOOTHING=0.1), "OPTIM": dict(OPTIM),
        "TPU": dict(TPU)}


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


def _eq(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


@pytest.fixture(scope="module")
def sides():
    rng = np.random.default_rng(0)
    batch = raycast_batch(0, B, cap=8192)
    jtask = JaxSegTask(CfgDict(CFGS), num_class=NUM_CLASS,
                       batch_per_device=B, iters_per_epoch=2)
    jtask.tx = optax.chain(_grad_stash(), jtask.tx)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    task = SegTask(CFGS, NUM_CLASS, device="cpu", batch_per_device=B,
                   iters_per_epoch=2, seed=1)
    assert task.caps == jtask.caps
    params, stats = torch_to_jax(task.model, *variable_shapes(jtask, jb),
                                 cfgs=CFGS)
    params, stats = _perturb(params, rng), _perturb(stats, rng)
    jax_params_to_torch(params, stats, task.model)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=jtask.tx.init(params),
                       loss_state=jtask.losses.init_state(NUM_CLASS))

    @jax.jit
    def jax_eval(state, b):
        """JAX's eval_step and predict_step over one forward."""
        vb, pyr = jtask.preprocess(b)
        logits = jtask.model.apply(
            {"params": state.params, "batch_stats": state.batch_stats},
            jtask._model_inputs(vb, b), pyr, train=False)
        voxel_pred = jnp.argmax(jtask._class_scores(logits), axis=-1)
        inv = vb.inverse_map
        point_pred = jnp.where(inv >= 0, voxel_pred[jnp.maximum(inv, 0)],
                               0).astype(jnp.int32)
        hist = confusion_matrix(point_pred, vb.point_labels, vb.point_valid,
                                NUM_CLASS)
        return vb, pyr, logits, hist, point_pred.reshape(B, -1)

    jvb, jpyr, jlogits, jhist, jpred = jax.device_get(jax_eval(state, jb))
    jstate, jm = jax.jit(jtask.train_step)(state, jb, jax.random.PRNGKey(1))
    jm = jax.device_get(jm)
    jgrads = jax.device_get(jstate.opt_state[0])

    tb = batch_to_device(batch, "cpu")
    tvb, tpyr, tlogits = task.forward(tb)
    out = task.eval_step(tb)
    tpred = task.predict_step(tb)
    m = task.train_step(tb)
    coef = min(1.0, OPTIM["GRAD_NORM_CLIP"] / (float(m["grad_norm"]) + 1e-6))
    tgrads = {n: g / coef for n, g in _named(task.model, "grad").items()}
    twin = SegTask(CFGS, NUM_CLASS, device="cpu").model
    jax_params_to_torch(jgrads, stats, twin)
    return dict(batch=batch, task=task, jvb=jvb, jpyr=jpyr, jlogits=jlogits,
                jhist=jhist, jpred=jpred, jm=jm, jgrads=_named(twin),
                tvb=tvb, tpyr=tpyr, tlogits=tlogits, out=out, tpred=tpred,
                tm=m, tgrads=tgrads)


def test_no_overflow_and_both_scans_present(sides):
    assert int(sides["jm"]["voxel_overflow"]) == 0
    assert int(sides["tm"]["voxel_overflow"]) == 0
    assert int(sides["out"]["voxel_overflow"]) == 0
    coords = _np(sides["tvb"].voxel_coords)
    valid = _np(sides["tvb"].voxel_valid)
    assert set(np.unique(coords[valid, 0]).tolist()) == {0, 1}


def test_voxel_table_and_inverse_map_match(sides):
    tvb, jvb = sides["tvb"], sides["jvb"]
    for name in ("voxel_coords", "voxel_valid", "voxel_keys_hi",
                 "voxel_keys_lo", "voxel_labels", "inverse_map",
                 "point_labels", "point_valid", "point_batch", "num_voxels",
                 "voxel_rep"):
        _eq(getattr(tvb, name), getattr(jvb, name))
    np.testing.assert_allclose(_np(tvb.voxel_feats), _np(jvb.voxel_feats),
                               rtol=1e-6, atol=1e-6)


def test_pyramid_integer_tables_match(sides):
    tpyr, jpyr = sides["tpyr"], sides["jpyr"]
    _eq(tpyr.level_counts, jpyr.level_counts)
    n = len(tpyr.levels)
    for l, (tl, jl) in enumerate(zip(tpyr.levels, jpyr.levels)):
        for name in ("coords", "valid", "subm_kmap"):
            _eq(getattr(tl, name), getattr(jl, name))
        _eq(tl.keys.hi, jl.keys.hi)
        _eq(tl.keys.lo, jl.keys.lo)
        if l >= 1:
            _eq(tl.down_kmap, jl.down_kmap)
        if l + 1 < n:
            _eq(tl.up_kmap, jl.up_kmap)
    for level in (2, 4):
        _eq(tpyr.devox[level].idx, jpyr.devox[level].idx)
    _eq(tpyr.point_to_voxel0, jpyr.point_to_voxel0)


def test_logits_hist_and_predictions_match(sides):
    t, j = _np(sides["tlogits"]), sides["jlogits"]
    assert t.shape == j.shape and np.isfinite(t).all()
    np.testing.assert_allclose(t, j, rtol=1e-3, atol=1e-3)
    valid = sides["batch"]["valid"]
    tpred, jpred = _np(sides["tpred"]), _np(sides["jpred"])
    assert tpred.shape == jpred.shape == (B, 8192)
    agree = (tpred == jpred)[valid].mean()
    assert agree >= 0.999, agree
    t_hist, j_hist = _np(sides["out"]["hist"]), _np(sides["jhist"])
    assert t_hist.sum() == j_hist.sum() == valid.sum()
    assert np.abs(t_hist - j_hist).sum() / 2 <= 0.001 * valid.sum()


def test_train_step_loss_and_gradients_match(sides):
    np.testing.assert_allclose(float(sides["tm"]["loss"]),
                               float(sides["jm"]["loss"]), rtol=1e-5)
    assert int(sides["tm"]["num_voxels"]) == int(sides["jm"]["num_voxels"])
    np.testing.assert_allclose(sides["tm"]["lr"], float(sides["jm"]["lr"]),
                               rtol=1e-6)
    want, got = sides["jgrads"], sides["tgrads"]
    assert set(got) == set(want)
    for n in want:
        assert np.abs(want[n]).max() > 0, n
        np.testing.assert_allclose(got[n], want[n], rtol=1e-4, atol=1e-4,
                                   err_msg=n)
    w = np.concatenate([want[n].ravel() for n in want]).astype(np.float64)
    g = np.concatenate([got[n].ravel() for n in want]).astype(np.float64)
    assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w)
