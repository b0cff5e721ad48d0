"""Port parity for RangeNet++'s post-processing (``openpcseg_torch/ops/
range_postproc.py``) and MODEL.POST_CRF in the range eval, against
``openpcseg_tpu/ops/range_postproc.py`` and JAX's ``_range_eval_step`` on
the CPU, float32.

- ``crf_refine`` at [2, 16, 64, 20] on seeded xyz, softmax and a mask with
  a fifth of its pixels off, for two windows and iteration counts: the
  refined softmax at rtol 1e-5, atol 1e-7 (15 shifted window sums and a
  20 x 20 mix in float32 a round);
- ``border_mask`` at [2, 16, 64] over 20 labels, 4- and 8-connected, 1
  and 2 erosions, with and without the background class: equal;
- a RangeNet (DarkNet-21, the yaml's other widths) on the 16 x 128 images
  of tests/range_parity.py with POST_CRF {ITER 3, LCN_H 3, LCN_W 5}: the
  log of the refined softmax at rtol 1e-4, atol 1e-5 of JAX's (computed
  from JAX's logits by its crf_refine, as its eval step does), and the
  eval step's per-point KNN histogram equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from range_parity import projected_batch, range_cfgs
from test_torch_minkunet import _perturb
from torch_threads import one_torch_thread  # noqa: F401

from openpcseg_tpu.config import CfgDict as JaxCfgDict
from openpcseg_tpu.engine import SegTask as JaxSegTask
from openpcseg_tpu.ops import range_postproc as jpp
from openpcseg_torch.engine.task import SegTask, batch_to_device
from openpcseg_torch.ops import range_postproc as tpp
from openpcseg_torch.utils.convert import jax_params_to_torch

SHAPE = (2, 16, 64)
C = 20


def _crf_inputs(seed):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(scale=2.0, size=SHAPE + (3,)).astype(np.float32)
    logits = rng.normal(size=SHAPE + (C,)).astype(np.float32)
    sm = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    mask = rng.random(SHAPE) < 0.8
    xyz = np.where(mask[..., None], xyz, 0.0).astype(np.float32)
    return xyz, sm.astype(np.float32), mask


@pytest.mark.parametrize("iters,lcn_h,lcn_w", [(3, 3, 5), (2, 5, 3)])
def test_crf_refine_matches_jax(iters, lcn_h, lcn_w):
    xyz, sm, mask = _crf_inputs(iters)
    kw = dict(iters=iters, lcn_h=lcn_h, lcn_w=lcn_w, xyz_coef=0.1,
              xyz_sigma=0.7)
    want = np.asarray(jpp.crf_refine(jnp.asarray(xyz), jnp.asarray(sm),
                                     jnp.asarray(mask), **kw))
    got = tpp.crf_refine(torch.as_tensor(xyz), torch.as_tensor(sm),
                         torch.as_tensor(mask), **kw).numpy()
    assert got.shape == SHAPE + (C,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert np.abs(got - sm).max() > 1e-3     # the CRF moved something
    with pytest.raises(ValueError, match="odd"):
        tpp.crf_refine(torch.as_tensor(xyz), torch.as_tensor(sm),
                       torch.as_tensor(mask), lcn_w=4)


def test_shifts_fill_with_zeros():
    a = torch.arange(2 * 4 * 5 * 1, dtype=torch.float32).reshape(2, 4, 5, 1)
    for dy, dx in [(1, 2), (-2, 1), (0, -3), (-1, -1)]:
        want = np.roll(a.numpy(), (dy, dx), axis=(1, 2))
        if dy > 0:
            want[:, :dy] = 0
        elif dy < 0:
            want[:, dy:] = 0
        if dx > 0:
            want[:, :, :dx] = 0
        elif dx < 0:
            want[:, :, dx:] = 0
        np.testing.assert_array_equal(tpp.shifted(a, dy, dx).numpy(), want)


@pytest.mark.parametrize("kern_conn", [4, 8])
@pytest.mark.parametrize("border_size", [1, 2])
@pytest.mark.parametrize("background", [0, None])
def test_border_mask_matches_jax(kern_conn, border_size, background):
    rng = np.random.default_rng(kern_conn + border_size)
    # blocky labels, so there are bodies as well as borders
    labels = np.repeat(np.repeat(rng.integers(0, C, size=(2, 2, 8)), 8, 1),
                       8, 2).astype(np.int32)
    labels[:, 5:7, 10:20] = 3
    want = np.asarray(jpp.border_mask(jnp.asarray(labels), C, border_size,
                                      kern_conn, background))
    got = tpp.border_mask(torch.as_tensor(labels), C, border_size,
                          kern_conn, background).numpy()
    assert got.shape == SHAPE and got.dtype == bool
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


def test_rangenet_eval_with_post_crf_matches_jax():
    crf = {"ITER": 3, "LCN_H": 3, "LCN_W": 5}
    cfgs = range_cfgs("RangeNet", DARKNET_LAYERS=21, POST_CRF=crf)
    batch = projected_batch(0)
    jtask = JaxSegTask(JaxCfgDict(cfgs), num_class=C, batch_per_device=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jtask.init_state(jax.random.PRNGKey(0), jb)
    rng = np.random.default_rng(0)
    params, stats = jax.device_get((_perturb(state.params, rng),
                                    _perturb(state.batch_stats, rng)))
    state = state.replace(params=params, batch_stats=stats)

    @jax.jit
    def refined(s, b):
        logits = jtask.model.apply(
            {"params": s.params, "batch_stats": s.batch_stats}, b["scan"],
            train=False)[0]
        sm = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
        sm = jpp.crf_refine(b["scan"][..., :3] * jnp.asarray([50.0, 50.0,
                                                               3.0]),
                            sm, b["scan"][..., 5] > 0.5, iters=3, lcn_h=3,
                            lcn_w=5)
        return jnp.log(jnp.maximum(sm, 1e-12))
    want = np.asarray(refined(state, jb))
    jhist = np.asarray(jax.jit(jtask.eval_step)(state, jb)["hist"])

    task = SegTask(cfgs, C, device="cpu", batch_per_device=2)
    assert task.crf == dict(iters=3, lcn_h=3, lcn_w=5, xyz_coef=0.1,
                            xyz_sigma=0.7)
    jax_params_to_torch(params, stats, task.model)
    tb = batch_to_device(batch, "cpu")
    got = task.crf_logits(tb, task.range_logits(tb)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 16, 128, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    hist = task.eval_step(tb)["hist"].numpy()
    np.testing.assert_array_equal(hist, jhist)
    assert hist.sum() == batch["p_valid"].sum()
