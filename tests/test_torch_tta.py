"""Test-time augmentation of the port on the CPU: ``SegTask.
predict_probs_step``, the batched votes and ``Trainer.evaluate_tta``
against the JAX package, float32.

- ``predict_probs_step`` of a narrow MinkUNet (widths 8-16), a tiny
  Cylinder3D and a tiny CENet (16 x 64) against JAX's from the same
  variables (``jax_params_to_torch``), on 3 votes of one scan: rtol 1e-4,
  atol 1e-7 (softmax probabilities in float32 after ~10 layers of
  running-statistics BN; 0 exactly where a point has no voxel or is not
  valid);
- the votes in one batched forward equal per-vote forwards of a task
  of batch 1 that shares the model (the port's tests/test_tta.py:41,
  :104): rtol 1e-4, atol 1e-5, as JAX's;
- ``Trainer.evaluate_tta``'s histogram equal to JAX's
  ``Trainer.evaluate_tta`` on the mini tree and narrow config of
  tests/test_torch_trainer_jax.py, from the same weights, exactly (its
  votes draw their scale from the view's generator in the same order);
- the range votes' column roll (tests/test_tta.py:262, :278);
- ``cli/infer.py --tta`` on a mini tree, ending in a logged mIoU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_trainer import _argv, tree  # noqa: F401
from test_torch_trainer_jax import jax_and_port  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

import openpcseg_tpu.engine.trainer as jtrainer
from openpcseg_tpu.config import CfgDict as JaxCfgDict
from openpcseg_tpu.engine import SegTask as JaxSegTask
from openpcseg_torch.config import CfgDict
from openpcseg_torch.data import collate
from openpcseg_torch.data.range_view import SemkittiRangeViewDataset
from openpcseg_torch.data.synthetic import synthetic_batch
from openpcseg_torch.engine.task import SegTask, batch_to_device
from openpcseg_torch.utils.convert import jax_params_to_torch

NUM_CLASS, VOTES = 20, 3
OPTIM = {"BATCH_SIZE_PER_GPU": 1, "NUM_EPOCHS": 1, "OPTIMIZER": "sgd",
         "LR_PER_SAMPLE": 0.02, "WEIGHT_DECAY": 0.0, "MOMENTUM": 0.9,
         "SCHEDULER": "linear_warmup_with_cosdecay", "WARMUP_EPOCH": 1}
MINK = {"DATA": {"DATASET": "semantickitti", "VOXEL_SIZE": 0.2},
        "MODEL": {"NAME": "MinkUNet", "IGNORE_LABEL": 0,
                  "IN_FEATURE_DIM": 4, "BLOCK": "ResBlock",
                  "NUM_LAYER": [1, 1, 1, 1, 1, 1, 1, 1],
                  "PLANES": [8, 8, 16, 16, 16, 16, 16, 8, 8], "cr": 1.0,
                  "DROPOUT_P": 0.0, "LABEL_SMOOTHING": 0.0},
        "OPTIM": OPTIM,
        "TPU": {"VOXEL_CAP_PER_SCAN": 4096,
                "VOXEL_CAP_RATIOS": [1.0, 1.0, 1.0, 1.0, 1.0]}}
CYL = {"MODALITY": "cylinder",
       "DATA": {"DATASET": "semantickitti", "CYLINDER_SPACE_MIN": [0, -180, -4],
                "CYLINDER_SPACE_MAX": [50, 180, 2],
                "CYLINDER_GRID_SIZE": [24, 24, 8]},
       "MODEL": {"NAME": "Cylinder_TS", "IGNORE_LABEL": 0,
                 "IN_FEATURE_DIM": 9, "DROPOUT_P": 0.0,
                 "LABEL_SMOOTHING": 0.0, "INIT_SIZE": 4,
                 "POINT_REFINEMENT": False},
       "OPTIM": OPTIM,
       "TPU": {"VOXEL_CAP_PER_SCAN": 2048,
               "VOXEL_CAP_RATIOS": [1.0, 1.0, 1.0, 1.0]}}
RANGE = {"MODALITY": "range",
         "DATA": {"DATASET": "semantickitti", "H": 16, "W": 64},
         "MODEL": {"NAME": "CENet", "IGNORE_LABEL": 0,
                   "NUM_CLASS": NUM_CLASS, "IF_BN": True,
                   "IF_INTENSITY": True, "IF_RANGE": True,
                   "WITH_NORM": False, "LOSS": "wce", "IF_LS_LOSS": False,
                   "IF_BD_LOSS": False, "TOP_K_PERCENT_PIXELS": 1.0,
                   "IF_AUX": False, "AUX_WEIGHT": 1.0, "KNN_POST": False},
         "OPTIM": OPTIM, "TPU": {}}


def rotated_votes(n_points, n_votes=VOTES, step=0.02):
    """n_votes copies of one synthetic scan, vote v rotated by v * step
    about z (features follow), stacked: the votes' batch."""
    base = synthetic_batch(0, 1, n_points=n_points, num_class=NUM_CLASS)
    votes = []
    for v in range(n_votes):
        b = {k: np.copy(x) for k, x in base.items()}
        c, s = np.cos(step * v), np.sin(step * v)
        xy = b["xyz"][0, :, :2] @ np.array([[c, -s], [s, c]], np.float32)
        b["xyz"][0, :, :2] = xy
        b["feats"][0, :, :2] = xy
        votes.append(b)
    return {k: np.concatenate([v[k] for v in votes]) for k in base}


class _FakeSource:
    """One in-memory raw scan standing in for SemantickittiDataset."""

    def __init__(self, n_pts=3000, seed=0):
        rng = np.random.default_rng(seed)
        r = rng.uniform(2.0, 40.0, n_pts)
        yaw = rng.uniform(-np.pi, np.pi, n_pts)
        pitch = rng.uniform(np.deg2rad(-24.0), np.deg2rad(2.0), n_pts)
        xyz = np.stack([r * np.cos(pitch) * np.cos(yaw),
                        r * np.cos(pitch) * np.sin(yaw),
                        r * np.sin(pitch)], 1).astype(np.float32)
        rem = rng.uniform(0, 1, n_pts).astype(np.float32)
        self._pc = {"xyzret": np.concatenate([xyz, rem[:, None]], 1),
                    "labels": rng.integers(1, NUM_CLASS, n_pts).astype(
                        np.int32),
                    "path": "fake/000000.bin"}

    def __len__(self):
        return 1

    def __getitem__(self, i):
        return self._pc

    def resample(self):
        pass


class _FakeRangeView(SemkittiRangeViewDataset):
    def _make_source(self, data_cfgs, training, root_path, seed):
        return _FakeSource()


def range_votes(voting=VOTES):
    ds = _FakeRangeView(CfgDict(RANGE["DATA"]), training=False,
                        point_cap=4096)
    return ds.get_tta_sample(0, voting=voting)


def _batch(name):
    if name == "cenet":
        return {k: v for k, v in collate(range_votes()).items()
                if k != "name"}
    return rotated_votes(1500 if name == "minkunet" else 800)


CASES = {"minkunet": MINK, "cylinder": CYL, "cenet": RANGE}


@pytest.mark.parametrize("name", sorted(CASES))
def test_predict_probs_step_matches_jax(name):
    cfgs = CASES[name]
    batch = _batch(name)
    jtask = JaxSegTask(JaxCfgDict(cfgs), num_class=NUM_CLASS,
                       batch_per_device=VOTES, iters_per_epoch=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jax.device_get(jtask.init_state(jax.random.PRNGKey(0), jb))
    want = np.asarray(jax.jit(jtask.predict_probs_step)(state, jb))
    task = SegTask(cfgs, NUM_CLASS, device="cpu", batch_per_device=VOTES)
    jax_params_to_torch(state.params, state.batch_stats, task.model)
    got = task.predict_probs_step(batch_to_device(batch, "cpu")).numpy()
    n = (batch["p_valid"] if name == "cenet" else batch["valid"]).shape[1]
    assert got.shape == want.shape == (VOTES, n, NUM_CLASS)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    mass = got.sum(-1)
    live = mass > 0
    np.testing.assert_allclose(mass[live], 1.0, rtol=1e-5)
    assert live.any() and (got[~live] == 0).all()


@pytest.mark.parametrize("name", ["minkunet", "cylinder"])
def test_batched_votes_match_per_vote_forwards(name):
    cfgs = {k: v for k, v in CASES[name].items() if k != "OPTIM"}
    batch = _batch(name)
    tb = SegTask(cfgs, NUM_CLASS, device="cpu", batch_per_device=VOTES,
                 seed=1)
    t1 = SegTask(cfgs, NUM_CLASS, device="cpu", model=tb.model)
    assert t1.model is tb.model and t1.caps[0] * VOTES == tb.caps[0]
    probs = tb.predict_probs_step(batch_to_device(batch, "cpu")).numpy()
    seq = [t1.predict_probs_step(batch_to_device(
        {k: v[i:i + 1] for k, v in batch.items()}, "cpu")).numpy()[0]
        for i in range(VOTES)]
    for v in range(VOTES):
        np.testing.assert_allclose(probs[v], seq[v], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(probs.mean(0), np.mean(seq, 0), rtol=1e-4,
                               atol=1e-5)


def test_evaluate_tta_matches_the_jax_trainer(jax_and_port, monkeypatch):
    """JAX's evaluate_tta keeps its histogram to itself; it is read where
    JAX hands it to miou_from_hist."""
    jt, tt = jax_and_port
    seen = []
    real = jtrainer.miou_from_hist

    def capture(hist, unique_label):
        seen.append(np.asarray(hist).copy())
        return real(hist, unique_label)

    monkeypatch.setattr(jtrainer, "miou_from_hist", capture)
    want_miou = jt.evaluate_tta(voting=VOTES)
    got_miou = tt.evaluate_tta(voting=VOTES)
    (want,) = seen
    np.testing.assert_array_equal(tt.tta_hist, want)
    assert want.sum() == 3 * 3000
    assert got_miou == pytest.approx(want_miou, abs=1e-9)
    assert tt.tta_task(VOTES) is tt.tta_task(VOTES)
    assert tt.tta_task(VOTES).model is tt.task.model


def test_range_votes_roll_consistently():
    """Each vote's (py, px_v) indexes the same physical pixel: the rolled
    scan gathered at the vote's shifted px equals vote 0's gather; the
    label image rolls with it."""
    votes = range_votes(voting=4)
    v0 = votes[0]
    ref = v0["scan"][v0["p_py"], v0["p_px"]]
    for v in votes[1:]:
        np.testing.assert_array_equal(v["scan"][v["p_py"], v["p_px"]], ref)
        np.testing.assert_array_equal(np.sort(v["label"].ravel()),
                                      np.sort(v0["label"].ravel()))


def test_range_predict_probs_step_gathers_per_vote():
    """The range branch: per-point probabilities are the softmax of the
    pixel logits gathered at each vote's own (py, px), 0 where p_valid is
    False, and their mean over the votes does not depend on their order."""
    db = batch_to_device(_batch("cenet"), "cpu")
    task = SegTask({k: v for k, v in RANGE.items() if k != "OPTIM"},
                   NUM_CLASS, device="cpu", batch_per_device=VOTES)
    probs = task.predict_probs_step(db).numpy()
    assert probs.shape == (VOTES, 4096, NUM_CLASS)
    sm = torch.softmax(task.range_logits(db), dim=1).numpy()
    for v in range(VOTES):
        py, px = db["p_py"][v].numpy(), db["p_px"][v].numpy()
        man = sm[v][:, py, px].T
        man[~db["p_valid"][v].numpy()] = 0.0
        np.testing.assert_allclose(probs[v], man, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(probs.mean(0), probs[::-1].mean(0),
                               rtol=1e-6, atol=1e-7)


def test_infer_cli_tta_on_a_mini_tree(tmp_path):
    """``cli/infer.py --tta`` (10 votes) evaluates the val split (one
    2000-point scan) with test-time augmentation and logs its mIoU and
    metrics record."""
    import json

    from mini_trees import make_mini_kitti

    from openpcseg_torch.cli import infer

    root = tmp_path / "kitti" / "sequences"
    make_mini_kitti(root, seqs=("00",), scans_per_seq=1, n_pts=2000, seed=5)
    make_mini_kitti(root, seqs=("08",), scans_per_seq=1, n_pts=2000, seed=6)
    assert infer.main(_argv(str(root), tmp_path / "logs", "--tta")) == 0
    exp = next(tmp_path.glob("**/ckp")).parent
    text = "".join(p.read_text() for p in exp.glob("log_*.txt"))
    assert "TTA val mIoU" in text and "(10 votes)" in text
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").open()]
    (rec,) = [r for r in recs if "val_tta_miou" in r]
    assert 0.0 <= rec["val_tta_miou"] <= 100.0
