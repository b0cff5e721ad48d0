"""Port parity, part (c): the whole voxel eval slice of MinkUNet.

A tiny MinkUNet (NUM_LAYER [1,3,1,1,1,1,1,1]: the 3-block stage makes JAX
stack blocks 2..3 in StackedBlocks; PLANES [16,16,32,32,32,32,32,16,16])
runs the 8192-point ray-cast scan with cap ratios [1, 1, .6, .3, .15], so
no level overflows on either side. JAX's init_state gives the variables
(BN statistics and affine terms perturbed from a seeded numpy generator so
the converter's BN mapping is exercised); jax_params_to_torch loads them
into the port. Both run in float32.

- logits agree within rtol = atol = 1e-3;
- hist agrees on at least 99.9% of points. The only allowed difference is
  a near-tie in the argmax, where the other summation order of the two
  frameworks may pick the other class.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpcseg_tpu.config import CfgDict
from openpcseg_tpu.engine import SegTask as JaxSegTask
from openpcseg_torch.data.raycast import raycast_batch
from openpcseg_torch.engine.task import SegTask, batch_to_device
from openpcseg_torch.ops.kmap import kernel_offsets
from openpcseg_torch.utils.convert import jax_params_to_torch
from openpcseg_torch.utils.metrics import confusion_matrix, miou_from_hist

MODEL = {"NAME": "MinkUNet", "IGNORE_LABEL": 0, "IN_FEATURE_DIM": 4,
         "BLOCK": "ResBlock", "NUM_LAYER": [1, 3, 1, 1, 1, 1, 1, 1],
         "PLANES": [16, 16, 32, 32, 32, 32, 32, 16, 16], "cr": 1.0,
         "DROPOUT_P": 0.0}
TPU = {"VOXEL_CAP_PER_SCAN": 8192, "VOXEL_CAP_RATIOS": [1.0, 1.0, 0.6, 0.3,
                                                        0.15]}
NUM_CLASS = 20


def _jax_cfgs():
    return CfgDict({
        "DATA": {"DATASET": "semantickitti", "VOXEL_SIZE": 0.05},
        "MODEL": dict(MODEL),
        "OPTIM": {"BATCH_SIZE_PER_GPU": 1, "NUM_EPOCHS": 1,
                  "OPTIMIZER": "sgd", "LR_PER_SAMPLE": 0.02,
                  "WEIGHT_DECAY": 0.0001, "MOMENTUM": 0.9, "NESTEROV": True,
                  "GRAD_NORM_CLIP": 10,
                  "SCHEDULER": "linear_warmup_with_cosdecay",
                  "WARMUP_EPOCH": 1},
        "TPU": dict(TPU),
    })


def _perturb(tree, rng):
    """Seeded numpy perturbation of BN leaves (mean/var/scale/bias)."""
    def f(path, x):
        name = jax.tree_util.keystr(path[-1:])
        x = np.asarray(x)
        if "mean" in name or "bias" in name:
            return x + rng.normal(0, 0.1, x.shape).astype(x.dtype)
        if "var" in name or "scale" in name:
            return x * rng.uniform(0.5, 1.5, x.shape).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(f, tree)


@pytest.fixture(scope="module")
def both_sides():
    rng = np.random.default_rng(0)
    batch = raycast_batch(0, 1, cap=8192)
    jtask = JaxSegTask(_jax_cfgs(), num_class=NUM_CLASS, batch_per_device=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jtask.init_state(jax.random.PRNGKey(0), jb)
    params = _perturb(state.params, rng)
    stats = _perturb(state.batch_stats, rng)
    state = state.replace(params=params, batch_stats=stats)

    @jax.jit
    def jax_eval(state, b):
        vb, pyr = jtask.preprocess(b)
        logits = jtask.model.apply(
            {"params": state.params, "batch_stats": state.batch_stats},
            vb.voxel_feats, pyr, train=False)
        caps = jnp.asarray(jtask.caps)
        over = (jnp.maximum(vb.num_voxels - jtask.caps[0], 0)
                + jnp.sum(jnp.maximum(pyr.level_counts - caps, 0)))
        return logits, jtask.eval_step(state, b)["hist"], over, vb.inverse_map

    j_logits, j_hist, j_over, j_inv = jax.device_get(jax_eval(state, jb))

    task = SegTask({"DATA": {"VOXEL_SIZE": 0.05}, "MODEL": dict(MODEL),
                    "TPU": dict(TPU)}, NUM_CLASS)
    assert task.caps == jtask.caps
    jax_params_to_torch(jax.device_get(params), jax.device_get(stats),
                        task.model)
    tb = batch_to_device(batch, "cpu")
    out = task.eval_step(tb)
    _, _, t_logits = task.forward(tb)
    t_pred = task.predict_step(tb)
    return dict(batch=batch, j_logits=j_logits, j_hist=j_hist, j_over=j_over,
                j_inv=j_inv, t_logits=t_logits.numpy(), out=out,
                t_pred=t_pred.numpy())


def test_no_overflow_on_either_side(both_sides):
    assert int(both_sides["j_over"]) == 0
    assert int(both_sides["out"]["voxel_overflow"]) == 0


def test_logits_match(both_sides):
    t, j = both_sides["t_logits"], both_sides["j_logits"]
    assert t.shape == j.shape == (8192, NUM_CLASS)
    assert np.isfinite(t).all() and np.abs(t).max() > 1e-3
    np.testing.assert_allclose(t, j, rtol=1e-3, atol=1e-3)


def test_hist_and_predictions_match(both_sides):
    valid = both_sides["batch"]["valid"].reshape(-1)
    n_valid = int(valid.sum())
    t_hist = both_sides["out"]["hist"].numpy()
    j_hist = np.asarray(both_sides["j_hist"])
    labels = both_sides["batch"]["labels"].reshape(-1)
    in_range = int((valid & (labels >= 0) & (labels < NUM_CLASS)).sum())
    assert t_hist.sum() == j_hist.sum() == in_range == n_valid
    # per-point agreement of the predictions (ties are the only excuse)
    j_vox = both_sides["j_logits"].argmax(-1)
    inv = both_sides["j_inv"]
    j_pred = np.where(inv >= 0, j_vox[np.maximum(inv, 0)], 0)
    t_pred = both_sides["t_pred"].reshape(-1)
    agree = (t_pred == j_pred)[valid].mean()
    assert agree >= 0.999, agree
    assert np.abs(t_hist - j_hist).sum() / 2 <= 0.001 * n_valid
    m_t, _ = miou_from_hist(t_hist)
    m_j, _ = miou_from_hist(j_hist)
    assert abs(m_t - m_j) < 0.5


def test_confusion_matrix_counts():
    pred = torch.tensor([0, 1, 1, 2, 5, -1], dtype=torch.int32)
    label = torch.tensor([0, 1, 2, 2, 1, 1], dtype=torch.int32)
    valid = torch.tensor([True, True, True, False, True, True])
    h = confusion_matrix(pred, label, valid, 3).numpy()
    want = np.zeros((3, 3), np.int64)
    want[0, 0] = want[1, 1] = want[2, 1] = 1
    np.testing.assert_array_equal(h, want)


def test_converter_rejects_a_mismatched_tree():
    """An unused flax leaf or a missing one raises; the weight layout is
    [K, Cin, Cout] in kernel_offsets order."""
    task = SegTask({"DATA": {"VOXEL_SIZE": 0.05}, "MODEL": dict(MODEL),
                    "TPU": dict(TPU)}, NUM_CLASS)
    assert task.model.stem[0].conv.weight.shape == (
        len(kernel_offsets(3)), 4, 16)
    params = {"classifier": {"kernel": np.zeros((80, NUM_CLASS)),
                             "bias": np.zeros(NUM_CLASS)}}
    with pytest.raises(KeyError):
        jax_params_to_torch(params, {}, task.model)
