"""Port parity for the loss zoo (``openpcseg_torch/losses``) against
``openpcseg_tpu/losses`` on the CPU, float32.

- every loss of JAX's set, alone and through the ``Losses`` dispatcher:
  its value (rtol 1e-5) and its gradient with respect to the logits
  (rtol 1e-5, atol 1e-7: a handful of float32 reductions over 600 rows,
  as tests/test_torch_train.py's CE), on seeded logits with ignored and
  padding rows, for SemanticKITTI's 20 classes (WCELoss takes its class
  counts) and Waymo's 23 (the GroupSoftmax groups);
- DiceLossV1 on JAX's own draws (``jax.random.uniform`` under the class
  keys of its split), the extended GroupSoftmax on JAX's Bernoulli draws
  (the uniforms under each group's key): the same negatives and 'others'
  rows are kept on both sides, so the values agree as above;
- EQLv2 with its buffers over 3 steps: each step's loss and gradient as
  above, the buffers at rtol 1e-5; and under two gloo ranks
  (``openpcseg_torch.parallel.worker``) against JAX's 2-device step
  (``axis_name``: the buffers psummed), a tiny MinkUNet taking 3 steps:
  losses at rtol 1e-4, the buffers at rtol 1e-4 and equal on both ranks
  (tests/test_torch_parallel.py's tolerance);
- the extended head (MODEL.EXTEND_HEAD_FOR_GROUPS) through ``SegTask``: the
  eval histogram equal to JAX's, ``predict_probs_step`` at rtol 1e-4,
  atol 1e-7 (tests/test_torch_tta.py) and the 3-vote TTA histogram equal
  to the one JAX's vote probabilities give.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_minkunet import _perturb
from torch_threads import one_torch_thread  # noqa: F401

from openpcseg_tpu import losses as jl
from openpcseg_tpu.config import CfgDict as JaxCfgDict
from openpcseg_tpu.data import dataset_meta as jax_dataset_meta
from openpcseg_tpu.engine import SegTask as JaxSegTask
from openpcseg_tpu.losses import longtail as jlt
from openpcseg_tpu.parallel import make_data_mesh
from openpcseg_tpu.parallel import shard_train_step as jax_shard_train_step
from openpcseg_torch import losses as tl
from openpcseg_torch.data import dataset_meta
from openpcseg_torch.data.synthetic import synthetic_batch
from openpcseg_torch.data.waymo import WAYMO_CLASS_NAMES
from openpcseg_torch.engine.task import SegTask, batch_to_device
from openpcseg_torch.engine.trainer import tta_scan_hist
from openpcseg_torch.losses import longtail as tlt
from openpcseg_torch.parallel.worker import run_ranks
from openpcseg_torch.utils.convert import jax_params_to_torch
from openpcseg_torch.utils.metrics import confusion_matrix

N = 600
KITTI_NAMES, KITTI_PTS = dataset_meta("semantickitti")
WAYMO = list(WAYMO_CLASS_NAMES)


def _inputs(seed, c, n=N):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.normal(size=(n, c))).astype(np.float32)
    labels = rng.integers(0, c, size=n).astype(np.int32)
    valid = rng.random(n) < 0.9
    return logits, labels, valid


def _both(jfn, tfn, logits, labels, valid):
    """(JAX value, JAX grad, port value, port grad) of a loss of the
    logits."""
    want, gwant = jax.value_and_grad(lambda x: jfn(
        x, jnp.asarray(labels), jnp.asarray(valid)))(jnp.asarray(logits))
    x = torch.as_tensor(logits).requires_grad_()
    got = tfn(x, torch.as_tensor(labels), torch.as_tensor(valid))
    got.backward()
    return float(want), np.asarray(gwant), float(got.detach()), \
        x.grad.numpy()


def _check(jfn, tfn, logits, labels, valid, moves=True):
    want, gwant, got, ggot = _both(jfn, tfn, logits, labels, valid)
    assert np.isfinite(got) and (np.abs(gwant).max() > 0) == moves
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(ggot, gwant, rtol=1e-5, atol=1e-7)


def _dice_v1_draws(key, c, n):
    keys = jax.random.split(key, c)
    return np.array(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys))


def _group_draws(key, n_groups, n):
    """The uniforms under jax.random.bernoulli of each non-empty group."""
    out = []
    for _ in range(n_groups):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.uniform(sub, (n,))))
    return out


def test_dataset_tables_are_jax_s():
    names, pts = jax_dataset_meta("semantickitti")
    assert list(names) == list(KITTI_NAMES)
    np.testing.assert_array_equal(np.asarray(pts), np.asarray(KITTI_PTS))
    assert list(jax_dataset_meta("waymo")[0]) == WAYMO


CASES = {
    "weighted_ce": (20, lambda m: dict(cls_num_pts=m(KITTI_PTS),
                                       label_smoothing=0.1),
                    jl.weighted_cross_entropy, tl.weighted_cross_entropy),
    "focal": (20, lambda m: {}, jl.focal_loss, tl.focal_loss),
    "dice": (20, lambda m: {}, jl.dice_loss, tl.dice_loss),
    "exp_log": (20, lambda m: dict(label_smoothing=0.1), jl.exp_log_loss,
                tl.exp_log_loss),
    "eqlv2_batch": (20, lambda m: {}, jl.eqlv2_loss, tl.eqlv2_loss),
    "group_softmax": (23, lambda m: dict(class_names=WAYMO),
                      jl.group_softmax_loss, tl.group_softmax_loss),
    "group_softmax_kitti": (20, lambda m: dict(class_names=KITTI_NAMES),
                            jl.group_softmax_loss, tl.group_softmax_loss),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradient_match_jax(case):
    c, kw, jfn, tfn = CASES[case]
    logits, labels, valid = _inputs(1, c)
    jkw = kw(lambda a: jnp.asarray(np.asarray(a, np.float32)))
    tkw = kw(lambda a: torch.as_tensor(np.asarray(a, np.float32)))
    # no Waymo group name is a SemanticKITTI class: a loss of 0, whose
    # gradient is 0
    _check(lambda *a: jfn(*a, **jkw), lambda *a: tfn(*a, **tkw),
           logits, labels, valid, moves=case != "group_softmax_kitti")


def test_focal_gradient_stays_finite_where_p_t_rounds_to_one():
    """Where p_t rounds to 1 in float32, JAX's focal gradient is
    0 x inf = NaN; the port's is 0 there (the limit), and JAX's elsewhere."""
    logits = np.zeros((4, 20), np.float32)
    logits[0, 3] = 200.0                  # p_t == 1.0 exactly
    logits[1:, 3] = np.float32([1.0, 2.0, 3.0])
    labels = np.full(4, 3, np.int32)
    valid = np.ones(4, bool)
    want, gwant, got, ggot = _both(jl.focal_loss, tl.focal_loss, logits,
                                   labels, valid)
    assert np.isnan(gwant[0]).any() and not np.isnan(gwant[1:]).any()
    assert np.isfinite(ggot).all() and np.abs(ggot[0]).max() == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(ggot[1:], gwant[1:], rtol=1e-5, atol=1e-7)


def test_dice_v1_on_jax_draws():
    logits, labels, valid = _inputs(2, 20)
    key = jax.random.PRNGKey(5)
    draws = torch.as_tensor(_dice_v1_draws(key, 20, N))
    _check(lambda x, y, v: jl.dice_loss_v1(x, y, v, key),
           lambda x, y, v: tl.dice_loss_v1(x, y, v, draws=draws),
           logits, labels, valid)
    # drawn from a generator it samples the same number of negatives
    x = torch.as_tensor(logits)
    a = tl.dice_loss_v1(x, torch.as_tensor(labels), torch.as_tensor(valid),
                        generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(a))


@pytest.mark.parametrize("version", ["bgfg", "fine"])
@pytest.mark.parametrize("sampled", [False, True])
def test_extended_group_softmax_matches_jax(version, sampled):
    c = 23
    width = tlt.group_softmax_channel_num(c, version)
    assert width == jlt.group_softmax_channel_num(c, version)
    logits, labels, valid = _inputs(3, width)
    labels = labels % c
    groups, _ = tlt.group_structure(WAYMO, version)
    assert (groups, _) == jlt.group_structure(WAYMO, version)
    key = jax.random.PRNGKey(7) if sampled else None
    draws = ([torch.as_tensor(u) for u in _group_draws(
        key, sum(1 for g in groups if g), N)] if sampled else None)
    kw = dict(num_class=c, class_names=WAYMO, version=version)
    _check(lambda *a: jlt.group_softmax_loss_extended(*a, rng=key, **kw),
           lambda *a: tlt.group_softmax_loss_extended(*a, draws=draws, **kw),
           logits, labels, valid)
    want = jlt.group_softmax_activation(jnp.asarray(logits), **kw)
    got = tlt.group_softmax_activation(torch.as_tensor(logits), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


def _dispatch_kw(name=""):
    """SemanticKITTI's tables; Waymo's 23 names for the GroupSoftmax
    names, whose groups are Waymo's classes."""
    waymo = name.startswith("GroupSoftmax")
    return dict(cls_num_pts=KITTI_PTS,
                class_names=WAYMO if waymo else list(KITTI_NAMES),
                num_class=23 if waymo else 20, ignore_index=0,
                label_smoothing=0.1, extended_group_head=False)


@pytest.mark.parametrize("name", tl.KNOWN)
def test_losses_dispatch_each_name_as_jax(name):
    """Each name alone, weight 0.7, without state or draws (DiceLossV1 the
    one-hot dice, EQLv2 the batch's statistics), as JAX's dispatcher."""
    kw = _dispatch_kw(name)
    logits, labels, valid = _inputs(4, kw["num_class"])
    jloss = jl.Losses([name], [0.7], **kw)
    tloss = tl.Losses([name], [0.7], **kw)
    _check(jloss, tloss, logits, labels, valid)
    assert tloss.stateful == jloss.stateful == (name == "EQLv2")


def test_losses_dispatch_extended_head_and_rejects_unknown():
    c = 20
    width = tlt.group_softmax_channel_num(c)
    logits, labels, valid = _inputs(5, width)
    labels = labels % c
    kw = dict(_dispatch_kw(), extended_group_head=True)
    jloss = jl.Losses(["GroupSoftmax_fgbg_2", "CELoss"], [1.0, 0.5], **kw)
    tloss = tl.Losses(["GroupSoftmax_fgbg_2", "CELoss"], [1.0, 0.5], **kw)
    _check(jloss, tloss, logits, labels, valid)
    with pytest.raises(NotImplementedError, match="GeoLoss"):
        tl.Losses(["GeoLoss"], [1.0])


def test_eqlv2_state_over_three_steps():
    """JAX's first-step all-ones weights, then the collected ratio; the
    buffers leave class 0 out ([1:])."""
    jloss = jl.Losses(["EQLv2", "CELoss"], [1.0, 1.0], num_class=20)
    tloss = tl.Losses(["EQLv2", "CELoss"], [1.0, 1.0], num_class=20)
    jstate, tstate = jloss.init_state(), tloss.init_state()
    assert tstate["eqlv2"]["pos_grad"].shape == (19,)
    for step in range(3):
        logits, labels, valid = _inputs(10 + step, 20)
        (want, jnew), gwant = jax.value_and_grad(
            lambda x: jloss(x, jnp.asarray(labels), jnp.asarray(valid),
                            state=jstate), has_aux=True)(jnp.asarray(logits))
        x = torch.as_tensor(logits).requires_grad_()
        got, tnew = tloss(x, torch.as_tensor(labels), torch.as_tensor(valid),
                          state=tstate)
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(gwant),
                                   rtol=1e-5, atol=1e-7)
        for k in ("pos_grad", "neg_grad"):
            np.testing.assert_allclose(tnew["eqlv2"][k].numpy(),
                                       np.asarray(jnew["eqlv2"][k]),
                                       rtol=1e-5)
            assert float(tnew["eqlv2"][k].min()) > 0
        jstate, tstate = jnew, tnew


# a tiny MinkUNet for the SegTask-level cases (tests/test_torch_parallel.py)
MODEL = {"NAME": "MinkUNet", "IGNORE_LABEL": 0, "IN_FEATURE_DIM": 4,
         "BLOCK": "ResBlock", "NUM_LAYER": [1, 1, 1, 1, 1, 1, 1, 1],
         "PLANES": [8, 8, 16, 16, 16, 16, 16, 8, 8], "cr": 1.0,
         "DROPOUT_P": 0.0, "LABEL_SMOOTHING": 0.0}
OPTIM = {"BATCH_SIZE_PER_GPU": 1, "NUM_EPOCHS": 2, "OPTIMIZER": "sgd",
         "LR_PER_SAMPLE": 0.02, "WEIGHT_DECAY": 0.0001, "MOMENTUM": 0.9,
         "NESTEROV": True, "GRAD_NORM_CLIP": 10,
         "SCHEDULER": "linear_warmup_with_cosdecay", "WARMUP_EPOCH": 0}
TPU = {"VOXEL_CAP_PER_SCAN": 2048,
       "VOXEL_CAP_RATIOS": [1.0, 1.0, 0.9, 0.7, 0.5]}


def _cfgs(**model):
    return {"DATA": {"DATASET": "semantickitti", "VOXEL_SIZE": 0.25},
            "MODEL": dict(MODEL, **model), "OPTIM": dict(OPTIM),
            "TPU": dict(TPU)}


def test_eqlv2_under_two_ranks_matches_jax_psum(tmp_path):
    world, steps = 2, 3
    cfgs = _cfgs(LOSS_CONFIG={"LOSS_TYPES": ["CELoss", "EQLv2"],
                              "LOSS_WEIGHTS": [1.0, 1.0]})
    batch = synthetic_batch(0, world, n_points=1500, num_class=20)
    jtask = JaxSegTask(JaxCfgDict(cfgs), num_class=20, batch_per_device=1,
                       num_devices=world, axis_name="data",
                       iters_per_epoch=4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jtask.init_state(jax.random.PRNGKey(0),
                             {k: v[:1] for k, v in jb.items()})
    rng = np.random.default_rng(0)
    params0, stats0 = (_perturb(jax.device_get(state.params), rng),
                       _perturb(jax.device_get(state.batch_stats), rng))
    # eqlv2_init_state hands one zero array to both buffers, which the
    # sharded step's donation refuses: two arrays of the same zeros
    state = state.replace(params=params0, batch_stats=stats0, loss_state={
        "eqlv2": {k: jnp.zeros(19, jnp.float32)
                  for k in ("pos_grad", "neg_grad")}})
    step = jax_shard_train_step(jtask, make_data_mesh(world), jb)
    jlosses = []
    for _ in range(steps):
        state, jm = step(state, jb, jax.random.PRNGKey(1))
        jlosses.append(float(jm["loss"]))
    jstate = jax.device_get(state.loss_state["eqlv2"])

    model = SegTask(cfgs, 20, device="cpu").model
    jax_params_to_torch(params0, stats0, model)
    torch.save(model.state_dict(), tmp_path / "w.pt")
    paths = []
    for r in range(world):
        paths.append(str(tmp_path / f"batch{r}.npz"))
        np.savez(paths[-1], **{k: v[r:r + 1] for k, v in batch.items()})
    ranks = run_ranks(dict(cfgs=cfgs, num_class=20, device="cpu",
                           compute_dtype="float32", world=world,
                           weights=str(tmp_path / "w.pt"), batches=paths,
                           steps=steps, iters_per_epoch=4, seed=0,
                           threads=1, data=None), tmp_path / "ranks")
    got = [[s["loss"] for s in r["steps"]] for r in ranks]
    assert got[0] == got[1]
    np.testing.assert_allclose(got[0], jlosses, rtol=1e-4)
    s0, s1 = (r["loss_state"]["eqlv2"] for r in ranks)
    for k in ("pos_grad", "neg_grad"):
        assert torch.equal(s0[k], s1[k])
        np.testing.assert_allclose(s0[k].numpy(), np.asarray(jstate[k]),
                                   rtol=1e-4)


def test_extended_head_through_eval_and_tta():
    cfgs = _cfgs(EXTEND_HEAD_FOR_GROUPS=True,
                 LOSS_CONFIG={"LOSS_TYPES": ["GroupSoftmax"],
                              "LOSS_WEIGHTS": [1.0]})
    batch = synthetic_batch(1, 1, n_points=1500, num_class=20)
    # three votes: the scan turned by 0, 90 and 180 degrees
    votes = []
    for k in range(3):
        xyz = batch["xyz"][0].copy()
        c, s = np.cos(k * np.pi / 2), np.sin(k * np.pi / 2)
        xyz[:, :2] = batch["xyz"][0][:, :2] @ np.array([[c, s], [-s, c]],
                                                        np.float32)
        votes.append({key: (xyz if key == "xyz" else v[0])
                      for key, v in batch.items()})
    vb = {k: np.stack([v[k] for v in votes]) for k in votes[0]}
    jtask = JaxSegTask(JaxCfgDict(cfgs), num_class=20, batch_per_device=3)
    jb = {k: jnp.asarray(v) for k, v in vb.items()}
    state = jtask.init_state(jax.random.PRNGKey(0),
                             {k: v[:1] for k, v in jb.items()})
    rng = np.random.default_rng(1)
    state = state.replace(params=_perturb(state.params, rng),
                          batch_stats=_perturb(state.batch_stats, rng))
    jprobs = np.asarray(jax.jit(jtask.predict_probs_step)(state, jb))
    jhist = np.asarray(jax.jit(jtask.eval_step)(state, jb)["hist"])

    task = SegTask(cfgs, 20, device="cpu", batch_per_device=3)
    assert task.model.classifier.out_features == \
        tlt.group_softmax_channel_num(20) == 24
    jax_params_to_torch(jax.device_get(state.params),
                        jax.device_get(state.batch_stats), task.model)
    tb = batch_to_device(vb, "cpu")
    probs = task.predict_probs_step(tb).numpy()
    assert probs.shape == jprobs.shape == (3, 1500, 20)
    np.testing.assert_allclose(probs, jprobs, rtol=1e-4, atol=1e-7)
    hist = task.eval_step(tb)["hist"].numpy()
    assert hist.shape == (20, 20) and hist.sum() == vb["valid"].sum()
    np.testing.assert_array_equal(hist, jhist)
    tta = tta_scan_hist(task, votes).numpy()
    pred = torch.as_tensor(jprobs.mean(0).argmax(-1).astype(np.int32))
    want = confusion_matrix(pred, torch.as_tensor(vb["labels"][0]),
                            torch.as_tensor(vb["valid"][0]), 20).numpy()
    np.testing.assert_array_equal(tta, want)
    # EQLv2's buffers take the num_class-wide head: JAX fails at its first
    # step on the extended one, the port when the task is built
    with pytest.raises(ValueError, match="EXTEND_HEAD_FOR_GROUPS"):
        SegTask(_cfgs(EXTEND_HEAD_FOR_GROUPS=True, LOSS_CONFIG={
            "LOSS_TYPES": ["EQLv2"], "LOSS_WEIGHTS": [1.0]}), 20,
            device="cpu")
    with pytest.raises(ValueError, match="Incompatible shapes"):
        jlt.eqlv2_loss(jnp.zeros((4, 24)), jnp.ones(4, jnp.int32),
                       jnp.ones(4, bool), state=jlt.eqlv2_init_state(20))
