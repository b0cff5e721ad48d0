"""Port parity for the Bottleneck block (JAX ``layers.py Bottleneck``, the
default BLOCK of MinkUNet and SPVCNN) and the 4x expansion it gives the
networks around it.

A tiny MinkUNet and SPVCNN with BLOCK Bottleneck (PLANES [8,8,8,16,16,16,
8,8,8], so the expanded widths run 32-64; NUM_LAYER [1,3,1,1,1,1,1,1],
so stage 2's blocks 2..3 sit in StackedBlocks in the scanned layout) on
the synthetic batch of two 2500-point scans (VOXEL_SIZE 0.2, 3072 voxels
a scan, cap ratios [1, 1, .9, .7, .5]: no overflow on either side). JAX's
own ``init_state`` gives the variables, in each ``scan_blocks`` layout
(OPENPCSEG_SCAN_BLOCKS 1 and 0), their BN leaves perturbed from a seeded
numpy generator; ``jax_params_to_torch`` loads them into the port, so the
converter's names are checked against a real flax tree. In float32:

- the eval logits: rtol = atol = 1e-3 (tests/test_torch_minkunet.py);
- one train step (SGD, label smoothing 0.1, no dropout) held to JAX's step
  in float64 (its features and parameters; flax still takes the BN
  statistics in float32): the loss at rtol 1e-5, the BN running
  statistics at rtol = atol = 1e-5, the whole gradient within 2e-3 of its
  norm and each gradient within 2e-2 of its own scale (+ 1e-6: the point
  MLPs' biases, which a BN follows, have a gradient of 0 but for
  rounding). The step is ill-conditioned on some draws of the weights:
  the port's float32 step lands 4.5e-4 of the norm from JAX's float64
  one on SPVCNN's scanned draw (1.2e-2 of down_blocks.1.2.bn3.bias's
  scale, a sum of terms of both signs), 8.8e-5 on its unrolled draw and
  9e-7 on MinkUNet's;
- the same step with the port in float64 (the model cast to double, its
  float32 casts made float64): each gradient within 1e-5 of its scale
  (+ 1e-7) on MinkUNet's two layouts and SPVCNN's unrolled one (they read
  1.6-2.1e-6), so the Bottleneck and the converter are held far tighter
  than float32 allows; SPVCNN's scanned draw stays at the float32 bound
  (test_train_step_gradients_match_in_float64 says why).

RPVNet with a Bottleneck is refused on both sides: JAX's gate 1 adds a
cs[4]-wide range feature to a 4 x cs[4]-wide voxel one and fails at init,
the port when it builds the model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_minkunet import _perturb
from test_torch_train import OPTIM, _grad_stash, _named
from torch_threads import one_torch_thread  # noqa: F401

from openpcseg_tpu.config import CfgDict
from openpcseg_tpu.engine import SegTask as JaxSegTask
from openpcseg_tpu.engine import TrainState
from openpcseg_torch.cli.golden_run import to_fusion
from openpcseg_torch.data.raycast import raycast_batch
from openpcseg_torch.data.synthetic import synthetic_batch
from openpcseg_torch.engine.task import SegTask, batch_to_device
from openpcseg_torch.models import build_segmentor
from openpcseg_torch.models.layers import Bottleneck, repeated_blocks
from openpcseg_torch.utils.convert import jax_params_to_torch

B, N_PTS, NUM_CLASS = 2, 2500, 20
PLANES = [8, 8, 8, 16, 16, 16, 8, 8, 8]
MODEL = {"NAME": "MinkUNet", "IGNORE_LABEL": 0, "IN_FEATURE_DIM": 4,
         "BLOCK": "Bottleneck", "NUM_LAYER": [1, 3, 1, 1, 1, 1, 1, 1],
         "PLANES": PLANES, "cr": 1.0, "DROPOUT_P": 0.0,
         "LABEL_SMOOTHING": 0.1}
TPU = {"VOXEL_CAP_PER_SCAN": 3072,
       "VOXEL_CAP_RATIOS": [1.0, 1.0, 0.9, 0.7, 0.5]}


def _cfgs(name):
    return {"MODALITY": "fusion" if name != "MinkUNet" else "voxel",
            "DATA": {"DATASET": "semantickitti", "VOXEL_SIZE": 0.2},
            "MODEL": dict(MODEL, NAME=name), "OPTIM": dict(OPTIM),
            "TPU": dict(TPU)}


def _jax_task(cfgs, dt=jnp.float32):
    return JaxSegTask(CfgDict(cfgs), num_class=NUM_CLASS, batch_per_device=B,
                      iters_per_epoch=2, compute_dtype=dt)


@pytest.fixture(scope="module")
def batch():
    return synthetic_batch(0, B, n_points=N_PTS, num_class=NUM_CLASS)


@pytest.fixture(scope="module", params=[("MinkUNet", True),
                                        ("MinkUNet", False),
                                        ("SPVCNN", True), ("SPVCNN", False)],
                ids=lambda p: f"{p[0]}-{'scanned' if p[1] else 'unrolled'}")
def sides(request, batch):
    """JAX's eval logits and first train step, and the port's on the same
    variables, for one (model, scan_blocks layout)."""
    name, scan = request.param
    cfgs = _cfgs(name)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENPCSEG_SCAN_BLOCKS", "1" if scan else "0")
        jtask = _jax_task(cfgs)
        state = jtask.init_state(jax.random.PRNGKey(0), jb)
        rng = np.random.default_rng(1)
        state = state.replace(params=_perturb(state.params, rng),
                              batch_stats=_perturb(state.batch_stats, rng))

        @jax.jit
        def logits(state, b):
            vb, pyr = jtask.preprocess(b)
            return jtask.model.apply(
                {"params": state.params, "batch_stats": state.batch_stats},
                vb.voxel_feats, pyr, train=False)
        jlogits = np.asarray(logits(state, jb))
        with jax.enable_x64(True):
            # the step in float64 (the features; coordinates stay float32,
            # so the geometry is the same)
            j64 = _jax_task(cfgs, jnp.float64)
            j64.tx = optax.chain(_grad_stash(), j64.tx)
            p64, s64 = (jax.tree_util.tree_map(
                lambda a: jnp.asarray(np.asarray(a, np.float64)), t)
                for t in (state.params, state.batch_stats))
            state64 = TrainState(step=jnp.zeros((), jnp.int32), params=p64,
                                 batch_stats=s64, opt_state=j64.tx.init(p64),
                                 loss_state=state.loss_state)
            b64 = dict(jb, feats=jnp.asarray(batch["feats"], jnp.float64))
            new, jm = jax.jit(j64.train_step)(state64, b64,
                                              jax.random.PRNGKey(1))
            new, jm = jax.device_get((new, jm))
    params, stats = jax.device_get((state.params, state.batch_stats))
    stacked = any(k.startswith("StackedBlocks") for k in params)
    assert stacked == scan

    def as_torch(tree, stat_tree):
        twin = SegTask(cfgs, NUM_CLASS, device="cpu",
                       batch_per_device=B).model
        jax_params_to_torch(tree, stat_tree, twin, scan_blocks=scan)
        return twin

    task = SegTask(cfgs, NUM_CLASS, device="cpu", batch_per_device=B,
                   iters_per_epoch=2)
    assert task.caps == jtask.caps
    jax_params_to_torch(params, stats, task.model, scan_blocks=scan)
    tb = batch_to_device(batch, "cpu")
    tlogits = task.forward(tb)[2].numpy()
    m = task.train_step(tb)
    coef = min(1.0, OPTIM["GRAD_NORM_CLIP"] / (float(m["grad_norm"]) + 1e-6))
    grads = {n: g / coef for n, g in _named(task.model, "grad").items()}
    # the same step with the port in float64: the model cast to double and
    # its float32 casts (Tensor.float) made float64
    t64 = SegTask(cfgs, NUM_CLASS, device="cpu", batch_per_device=B,
                  iters_per_epoch=2, compute_dtype=torch.float64)
    t64.model.double()
    jax_params_to_torch(params, stats, t64.model, scan_blocks=scan)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "float", torch.Tensor.double)
        m64 = t64.train_step(batch_to_device(
            dict(batch, feats=batch["feats"].astype(np.float64)), "cpu"))
    coef = min(1.0, OPTIM["GRAD_NORM_CLIP"] / (float(m64["grad_norm"]) + 1e-6))
    grads64 = {n: g / coef for n, g in _named(t64.model, "grad").items()}
    want_grads = _named(as_torch(new.opt_state[0], stats))
    want_stats = {n: b.numpy() for n, b in as_torch(
        params, new.batch_stats).named_buffers()}
    return dict(name=name, jlogits=jlogits, tlogits=tlogits,
                jloss=float(jm["loss"]), tloss=float(m["loss"]),
                jover=int(jm["voxel_overflow"]),
                tover=int(m["voxel_overflow"]), grads=grads,
                tloss64=float(m64["loss"]), grads64=grads64,
                ill_conditioned=(name, scan) == ("SPVCNN", True),
                want_grads=want_grads, want_stats=want_stats,
                stats={n: b.numpy() for n, b in
                       task.model.named_buffers()}, model=task.model)


def test_eval_logits_match(sides):
    t, j = sides["tlogits"], sides["jlogits"]
    assert t.shape == j.shape == (B * 3072, NUM_CLASS)
    assert np.isfinite(t).all() and np.abs(t).max() > 1e-3
    np.testing.assert_allclose(t, j, rtol=1e-3, atol=1e-3)


def test_train_step_gradients_match(sides):
    assert sides["jover"] == sides["tover"] == 0
    np.testing.assert_allclose(sides["tloss"], sides["jloss"], rtol=1e-5)
    want, got = sides["want_grads"], sides["grads"]
    assert set(got) == set(want)
    assert any(".conv3." in n for n in want)
    for n in want:
        scale = np.abs(want[n]).max()
        assert scale > 0, n
        assert np.abs(got[n] - want[n]).max() <= 2e-2 * scale + 1e-6, n
    w = np.concatenate([want[n].ravel() for n in want]).astype(np.float64)
    g = np.concatenate([got[n].ravel() for n in want]).astype(np.float64)
    assert np.linalg.norm(g - w) <= 2e-3 * np.linalg.norm(w)


def test_train_step_gradients_match_in_float64(sides):
    """The port's step in float64 (the model cast to double, its float32
    casts made float64) against JAX's float64 step, which keeps its BN
    statistics, classifier input and losses in float32 as JAX's code casts
    them: the loss at rtol 1e-6 (it reads 0.9-2.6e-7), each gradient within
    1e-5 of its own scale + 1e-7 (the point MLPs' biases: 0 but for JAX's
    float32 rounding, up to 1.5e-8), where the float32 case allows 2e-2.
    MinkUNet's two layouts and SPVCNN's unrolled one read 1.6-2.1e-6. On
    SPVCNN's scanned draw the step is ill-conditioned under JAX's float32
    BN statistics: the port's float64 step lands 1.2e-2 of
    down_blocks.2.0.bn3.bias's scale from JAX's there, as its float32 step
    does, so that case is held to the float32 bound; the Bottleneck and the
    converter's walk it runs are those of MinkUNet's scanned case and
    SPVCNN's unrolled one, held here at 1e-5."""
    np.testing.assert_allclose(sides["tloss64"], sides["jloss"], rtol=1e-6)
    want, got = sides["want_grads"], sides["grads64"]
    assert set(got) == set(want)
    rel = 2e-2 if sides["ill_conditioned"] else 1e-5
    for n in want:
        assert got[n].dtype == np.float64, n
        scale = np.abs(want[n]).max()
        assert np.abs(got[n] - want[n]).max() <= rel * scale + 1e-7, n


def test_running_statistics_match(sides):
    want, got = sides["want_stats"], sides["stats"]
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-5, atol=1e-5,
                                   err_msg=n)


def test_expanded_widths(sides):
    """Down convs keep the width they get, up convs read the stage below
    at 4 x its planes, the skips concatenate at their expanded widths and
    the classifier reads (cs[4] + cs[6] + cs[8]) x 4."""
    model, cs = sides["model"], PLANES
    assert [d.conv.weight.shape[1:] for d in model.downs] == [
        (cs[0], cs[0])] + [(4 * c, 4 * c) for c in cs[1:4]]
    assert [u.weight.shape[1:] for u in model.ups] == [
        (4 * cs[4 + i], cs[5 + i]) for i in range(4)]
    skips = [cs[0]] + [4 * c for c in cs[1:4]]
    assert [b[0].conv1.weight.shape[0] for b in model.up_blocks] == [
        cs[5 + i] + skips[3 - i] for i in range(4)]
    assert model.classifier.in_features == 4 * (cs[4] + cs[6] + cs[8])
    if sides["name"] == "SPVCNN":
        assert [p.linear.weight.shape for p in model.point_transforms] == [
            (4 * cs[4], cs[0]), (4 * cs[6], 4 * cs[4]),
            (4 * cs[8], 4 * cs[6])]


def test_bottleneck_block_and_repeated_widths():
    """A block whose input is already 4 x planes wide keeps an identity
    shortcut; repeated_blocks carries 4 x planes through blocks 2..n."""
    assert Bottleneck(32, 8).shortcut is None
    assert Bottleneck(16, 8).shortcut.weight.shape == (16, 32)
    blocks = repeated_blocks(Bottleneck, 12, 8, 3, torch.float32)
    assert [b.conv1.weight.shape for b in blocks] == [(12, 8), (32, 8),
                                                      (32, 8)]
    assert [b.shortcut is None for b in blocks] == [False, True, True]
    # JAX's default block, as the JAX model's
    cfg = {k: v for k, v in MODEL.items() if k != "BLOCK"}
    assert type(build_segmentor(cfg, NUM_CLASS).down_blocks[0][0]) \
        is Bottleneck
    with pytest.raises(ValueError, match="BLOCK 'Basic'"):
        build_segmentor(dict(MODEL, BLOCK="Basic"), NUM_CLASS)


def test_rpvnet_refuses_a_bottleneck_as_jax_does():
    cfgs = _cfgs("RPVNet")
    fb = to_fusion(raycast_batch(0, 1, cap=2048), 0, 16, 256)
    jtask = _jax_task(cfgs)
    jb = {k: jnp.asarray(v) for k, v in fb.items()}

    def init(b):
        vb, pyr = jtask.preprocess(b)
        key = jax.random.PRNGKey(0)
        return jtask.model.init({"params": key, "dropout": key},
                                jtask._model_inputs(vb, b), pyr, train=False)
    with pytest.raises(TypeError, match="broadcast"):
        jax.eval_shape(init, jb)
    with pytest.raises(ValueError, match="RPVNet takes ResBlock"):
        build_segmentor(cfgs["MODEL"], NUM_CLASS)
    # its default stays ResBlock
    cfg = {k: v for k, v in cfgs["MODEL"].items() if k != "BLOCK"}
    assert build_segmentor(cfg, NUM_CLASS).expansion == 1
