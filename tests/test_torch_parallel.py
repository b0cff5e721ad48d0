"""Data-parallel training and evaluation of the port (``parallel/ddp.py``)
on the CPU: two ranks over gloo, each a process of
``openpcseg_torch.parallel.worker`` joined through a file store under the
test's tmp dir.

A 2-rank train step of a narrow MinkUNet (widths 8-16), float32, one
synthetic 1500-point scan a rank, from the same variables as JAX's
``shard_train_step`` over 2 virtual CPU devices (the conftest makes 8;
JAX's raw pmean'd gradients kept by an optax stash at the head of its
chain, as tests/test_torch_train.py does). Held to JAX and to the
one-process exact equivalent (``worker.exact_train_step``: the 2-scan
batch's forward, each scan's loss, their mean). Tolerances:

- loss: rtol 1e-4 (one float32 mean over ranks of per-rank sums);
- gradients, per tensor: max|port - JAX| <= 1e-4 * max|JAX| (float32
  through batch-statistics BN summed over ranks in another order; the
  same bound as the one-device step of tests/test_torch_train.py). A BN
  whose statistics are reduced by a plain ``dist.all_reduce`` (no
  gradient through the other rank's share) misses it;
- BN running statistics after the step and the parameters: rtol = atol =
  1e-4; both ranks bit-equal.

Then Cylinder3D's centred BN (two reductions) and its point branch under
2 ranks against the exact equivalent (its gradient within twice the
exact step's own spread under a change of summation order); a range
model's
per-rank BN taking rank 0's buffers; the eval over a loader whose tail is
padded to the global batch, and the sharded test-time augmentation, equal
to one process; the global batch of the Trainer; and ``torchrun`` through
``openpcseg_torch/cli/dist_train.sh 2 --device cpu``: an epoch, one
checkpoint per epoch written by rank 0, a resumed second epoch.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from mini_trees import make_mini_kitti
from test_torch_minkunet import _perturb
from test_torch_train import _grad_stash
from torch_threads import one_torch_thread  # noqa: F401

from openpcseg_tpu.config import CfgDict as JaxCfgDict
from openpcseg_tpu.engine import SegTask as JaxSegTask
from openpcseg_tpu.parallel import make_data_mesh
from openpcseg_tpu.parallel import shard_train_step as jax_shard_train_step
from openpcseg_torch.config import CfgDict, cfg_from_yaml_file
from openpcseg_torch.data.synthetic import synthetic_batch
from openpcseg_torch.engine.task import SegTask, batch_to_device
from openpcseg_torch.engine.trainer import tta_histogram
from openpcseg_torch.parallel.worker import (exact_train_step, load_batch,
                                             make_task, run_ranks)
from openpcseg_torch.utils.convert import jax_params_to_torch

ROOT = Path(__file__).resolve().parents[1]
WORLD, NUM_CLASS, N_PTS = 2, 20, 1500
TOL = 1e-4
MODEL = {"NAME": "MinkUNet", "IGNORE_LABEL": 0, "IN_FEATURE_DIM": 4,
         "BLOCK": "ResBlock", "NUM_LAYER": [1, 1, 1, 1, 1, 1, 1, 1],
         "PLANES": [8, 8, 16, 16, 16, 16, 16, 8, 8], "cr": 1.0,
         "DROPOUT_P": 0.0, "LABEL_SMOOTHING": 0.1}
# no warm-up: the first step takes the whole LR, so the parameters move by
# the gradients
OPTIM = {"BATCH_SIZE_PER_GPU": 1, "NUM_EPOCHS": 2, "OPTIMIZER": "sgd",
         "LR_PER_SAMPLE": 0.02, "WEIGHT_DECAY": 0.0001, "MOMENTUM": 0.9,
         "NESTEROV": True, "GRAD_NORM_CLIP": 10,
         "SCHEDULER": "linear_warmup_with_cosdecay", "WARMUP_EPOCH": 0}
CFGS = {"DATA": {"DATASET": "semantickitti", "VOXEL_SIZE": 0.25},
        "MODEL": MODEL, "OPTIM": OPTIM,
        "TPU": {"VOXEL_CAP_PER_SCAN": 2048,
                "VOXEL_CAP_RATIOS": [1.0, 1.0, 0.9, 0.7, 0.5]}}
ITERS = 4


def _spec(cfgs, batches=None, **kw):
    return dict(dict(cfgs=cfgs, num_class=NUM_CLASS, device="cpu",
                     compute_dtype="float32", world=WORLD, weights=None,
                     batches=batches, steps=1, iters_per_epoch=ITERS, seed=0,
                     threads=1, data=None), **kw)


def _save_batches(batch, d):
    paths = []
    for r in range(WORLD):
        paths.append(str(d / f"batch{r}.npz"))
        np.savez(paths[-1], **{k: v[r:r + 1] for k, v in batch.items()})
    return paths


def _unclipped(step, grads):
    coef = min(1.0, OPTIM["GRAD_NORM_CLIP"] / (step["grad_norm"] + 1e-6))
    return {n: g.numpy() / coef for n, g in grads.items()}


def _as_torch(params, stats):
    """JAX trees laid out as the port's named parameters and buffers."""
    twin = SegTask(CFGS, NUM_CLASS, device="cpu").model
    jax_params_to_torch(params, stats, twin)
    return ({n: p.detach().numpy() for n, p in twin.named_parameters()},
            {n: b.numpy() for n, b in twin.named_buffers()})


def _grad_err(got, want):
    """max over tensors of max|got - want| / max|want|."""
    assert set(got) == set(want)
    return max(np.abs(got[n] - want[n]).max()
               / max(np.abs(want[n]).max(), 1e-30) for n in want)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """JAX's 2-device shard_train_step, the port's 2 ranks and the exact
    one-process step, from the same variables and scans."""
    d = tmp_path_factory.mktemp("dp")
    batch = synthetic_batch(0, WORLD, n_points=N_PTS, num_class=NUM_CLASS)
    jtask = JaxSegTask(JaxCfgDict(CFGS), num_class=NUM_CLASS,
                       batch_per_device=1, num_devices=WORLD,
                       axis_name="data", iters_per_epoch=ITERS)
    jtask.tx = optax.chain(_grad_stash(), jtask.tx)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jtask.init_state(jax.random.PRNGKey(0),
                             {k: v[:1] for k, v in jb.items()})
    rng = np.random.default_rng(0)
    params0, stats0 = (_perturb(jax.device_get(state.params), rng),
                       _perturb(jax.device_get(state.batch_stats), rng))
    state = state.replace(params=params0, batch_stats=stats0)
    step = jax_shard_train_step(jtask, make_data_mesh(WORLD), jb)
    state, jm = step(state, jb, jax.random.PRNGKey(1))
    jax_grads, _ = _as_torch(jax.device_get(state.opt_state[0]), stats0)
    jax_params, jax_stats = _as_torch(jax.device_get(state.params),
                                      jax.device_get(state.batch_stats))

    model = SegTask(CFGS, NUM_CLASS, device="cpu").model
    jax_params_to_torch(params0, stats0, model)
    torch.save(model.state_dict(), d / "w.pt")
    paths = _save_batches(batch, d)
    spec = _spec(CFGS, paths, weights=str(d / "w.pt"))
    ranks = run_ranks(spec, d / "ranks")

    task = make_task(spec, "cpu", batch_per_device=WORLD)
    em = exact_train_step(task, [load_batch(p, "cpu") for p in paths])
    exact = dict(loss=float(em["loss"]),
                 grads={n: p.grad.numpy().copy()
                        for n, p in task.model.named_parameters()},
                 state={k: v.numpy().copy()
                        for k, v in task.model.state_dict().items()})
    return dict(jax=dict(loss=float(jm["loss"]), grads=jax_grads,
                         params=jax_params, stats=jax_stats,
                         num_voxels=int(jm["num_voxels"])),
                ranks=ranks, exact=exact)


def test_dp_loss_matches_jax_and_the_exact_step(dp):
    got = [r["steps"][0] for r in dp["ranks"]]
    assert got[0]["loss"] == got[1]["loss"]
    np.testing.assert_allclose(got[0]["loss"], dp["jax"]["loss"], rtol=TOL)
    np.testing.assert_allclose(got[0]["loss"], dp["exact"]["loss"], rtol=TOL)
    assert got[0]["num_voxels"] == dp["jax"]["num_voxels"]
    assert got[0]["voxel_overflow"] == 0


def test_dp_gradients_match_jax_and_the_exact_step(dp):
    r0 = dp["ranks"][0]
    assert _grad_err(_unclipped(r0["steps"][0], r0["grads"]),
                     dp["jax"]["grads"]) <= TOL
    assert _grad_err({n: g.numpy() for n, g in r0["grads"].items()},
                     dp["exact"]["grads"]) <= TOL


def test_dp_running_statistics_match_jax_and_the_exact_step(dp):
    state = dp["ranks"][0]["state"]
    for n, want in dp["jax"]["stats"].items():
        np.testing.assert_allclose(state[n].numpy(), want, rtol=TOL,
                                   atol=TOL, err_msg=n)
        np.testing.assert_allclose(state[n].numpy(), dp["exact"]["state"][n],
                                   rtol=TOL, atol=TOL, err_msg=n)


def test_dp_parameters_match_jax_and_are_equal_on_both_ranks(dp):
    s0, s1 = (r["state"] for r in dp["ranks"])
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    for n, want in dp["jax"]["params"].items():
        np.testing.assert_allclose(s0[n].numpy(), want, rtol=TOL, atol=TOL,
                                   err_msg=n)
        np.testing.assert_allclose(s0[n].numpy(), dp["exact"]["state"][n],
                                   rtol=TOL, atol=TOL, err_msg=n)


def test_dp_eval_histogram_is_the_sum_of_the_ranks(dp):
    r0, r1 = dp["ranks"]
    assert torch.equal(r0["hist"], r1["hist"])
    assert torch.equal(r0["hist"], r0["local_hist"] + r1["local_hist"])
    assert int(r0["hist"].sum()) == WORLD * N_PTS


CYL = {"MODALITY": "cylinder",
       "DATA": {"DATASET": "semantickitti",
                "CYLINDER_SPACE_MAX": [50, 180, 2],
                "CYLINDER_SPACE_MIN": [0, -180, -4],
                "CYLINDER_GRID_SIZE": [120, 90, 16]},
       "MODEL": {"NAME": "Cylinder_TS", "IGNORE_LABEL": 0,
                 "IN_FEATURE_DIM": 9, "INIT_SIZE": 8,
                 "POINT_REFINEMENT": True, "LABEL_SMOOTHING": 0.0,
                 "DROPOUT_P": 0.0},
       "OPTIM": OPTIM,
       "TPU": {"VOXEL_CAP_PER_SCAN": 3072,
               "VOXEL_CAP_RATIOS": [1.0, 1.0, 0.9, 0.7, 0.5]}}


def _l2(got, want):
    """|got - want| / |want| over every tensor as one vector."""
    num = sum(float(((got[n] - want[n]) ** 2).sum()) for n in want)
    return np.sqrt(num / sum(float((want[n] ** 2).sum()) for n in want))


def test_cylinder_centred_bn_under_two_ranks(tmp_path):
    """Cylinder3D over 2 ranks against the exact one-process step. Its
    point branch's first BN is centred: the count and sum are reduced,
    then the squared deviations from the global mean; its running
    statistics, and every BN's, at rtol = atol = 1e-4, the loss at rtol
    1e-4. This network's gradient moves by more than rounding under any
    change of summation order (the scatter-max's near-ties and the ReLU
    gates, tests/test_torch_cylinder.py): the exact step with the two
    scans swapped moves it by 6e-4 of its norm. The ranks' gradient is
    held within twice that spread of the exact step (at least 1e-4), as
    a whole."""
    batch = synthetic_batch(0, WORLD, n_points=2500, num_class=NUM_CLASS)
    paths = _save_batches(batch, tmp_path)
    spec = _spec(CYL, paths)
    r0, r1 = run_ranks(spec, tmp_path / "ranks")
    exact = []
    for order in (paths, paths[::-1]):
        task = make_task(spec, "cpu", batch_per_device=WORLD)
        m = exact_train_step(task, [load_batch(p, "cpu") for p in order])
        exact.append((float(m["loss"]), task.model.state_dict(), {
            n: p.grad.numpy() for n, p in task.model.named_parameters()}))
    assert task.model.point_bns[0].centered
    (loss, state, grads), (_, _, swapped) = exact
    np.testing.assert_allclose(r0["steps"][0]["loss"], loss, rtol=TOL)
    spread = _l2(swapped, grads)
    assert spread < 1e-2
    got = {n: g.numpy() for n, g in r0["grads"].items()}
    assert set(got) == set(grads)
    assert _l2(got, grads) <= max(TOL, 2 * spread)
    for n, _ in task.model.named_buffers():
        np.testing.assert_allclose(r0["state"][n].numpy(), state[n].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=n)
    assert all(torch.equal(r0["state"][k], r1["state"][k])
               for k in r0["state"])


RANGE = {"MODALITY": "range",
         "DATA": {"DATASET": "semantickitti", "H": 16, "W": 64},
         "MODEL": {"NAME": "CENet", "IGNORE_LABEL": 0,
                   "NUM_CLASS": NUM_CLASS, "IF_BN": True,
                   "IF_INTENSITY": True, "IF_RANGE": True,
                   "WITH_NORM": False, "LOSS": "wce", "IF_LS_LOSS": False,
                   "IF_BD_LOSS": False, "TOP_K_PERCENT_PIXELS": 1.0,
                   "IF_AUX": False, "AUX_WEIGHT": 1.0, "KNN_POST": False},
         "OPTIM": OPTIM, "TPU": {}}


def test_range_bn_stays_per_rank_and_takes_rank0_buffers(tmp_path):
    """A range model's BatchNorm2d is not synced (flax nn.BatchNorm
    without axis_name): after a step both ranks hold rank 0's running
    statistics, those of one process stepping on rank 0's scan alone,
    and not those of rank 1's scan."""
    rng = np.random.default_rng(0)
    batch = {"scan": rng.normal(size=(WORLD, 16, 64, 6)).astype(np.float32),
             "label": rng.integers(0, NUM_CLASS, (WORLD, 16, 64)).astype(
                 np.int32)}
    paths = _save_batches(batch, tmp_path)
    spec = _spec(RANGE, paths)
    r0, r1 = run_ranks(spec, tmp_path / "ranks")
    bufs = [n for n, _ in SegTask(RANGE, NUM_CLASS, device="cpu")
            .model.named_buffers()]
    assert bufs
    alone = []
    for p in paths:
        task = make_task(spec, "cpu", num_devices=WORLD)
        task.train_step(load_batch(p, "cpu"))
        alone.append(task.model.state_dict())
    for n in bufs:
        assert torch.equal(r0["state"][n], r1["state"][n]), n
        assert torch.equal(r0["state"][n], alone[0][n]), n
    assert any(not torch.equal(r1["state"][n], alone[1][n]) for n in bufs)


KITTI_CFG = "tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10.yaml"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A mini SemanticKITTI tree: 4 train scans, 3 val scans (odd, so a
    2-rank eval pads its tail)."""
    root = tmp_path_factory.mktemp("kitti") / "sequences"
    make_mini_kitti(root, seqs=("00",), scans_per_seq=4, n_pts=3000, seed=3)
    make_mini_kitti(root, seqs=("08",), scans_per_seq=3, n_pts=3000, seed=4)
    return str(root)


def test_padded_eval_and_sharded_tta_match_one_process(tree, tmp_path):
    """Two ranks over the val split of 3 scans: the loader's second global
    batch holds scan 2 and a padded sample, and test-time augmentation's
    second round a repeated scan with no valid point. Both histograms
    equal one process's, exactly."""
    ycfg = CfgDict()
    cfg_from_yaml_file(ROOT / KITTI_CFG, ycfg)
    cfgs = dict(CFGS, DATA=dict(CFGS["DATA"], VOXEL_SIZE=0.05),
                TPU={"VOXEL_CAP_PER_SCAN": 4096,
                     "VOXEL_CAP_RATIOS": [1.0, 1.0, 1.0, 1.0, 1.0]})
    data = dict(ycfg.DATA, DATA_PATH=tree)
    voting = 2
    spec = _spec(cfgs, data=dict(data=data, modality="voxel",
                                 point_cap=4096, voting=voting))
    r0, r1 = run_ranks(spec, tmp_path / "ranks")
    assert torch.equal(r0["eval_hist"], r1["eval_hist"])
    assert torch.equal(r0["tta_hist"], r1["tta_hist"])

    from openpcseg_torch.data import build_dataloader
    dataset, _ = build_dataloader(CfgDict(data), "voxel", 1, training=False,
                                  point_cap=4096, num_workers=1)
    assert len(dataset) == 3
    task = make_task(spec, "cpu")
    one = sum(task.eval_step(batch_to_device(
        {k: v[None] for k, v in dataset[i].items() if k != "name"}, "cpu")
    )["hist"] for i in range(len(dataset)))
    assert torch.equal(r0["eval_hist"], one)
    assert int(one.sum()) == 3 * 3000
    tta_task = SegTask({k: v for k, v in cfgs.items() if k != "OPTIM"},
                       NUM_CLASS, device="cpu", batch_per_device=voting,
                       model=task.model)
    tta_one = tta_histogram(tta_task, dataset, voting)
    np.testing.assert_array_equal(r0["tta_hist"].numpy(), tta_one)
    assert tta_one.sum() == 3 * 3000


def test_trainer_loads_the_global_batch(tree, tmp_path, monkeypatch):
    """Rank 1 of 2 with --batch_size 2: the loaders take the global batch
    of 4 and hand this rank its 2 scans; the LR is LR_PER_SAMPLE x 2 x 2
    (JAX trainer.py:77-91, task.py:156-157)."""
    from openpcseg_torch import data as tdata
    from openpcseg_torch.cli import train
    from openpcseg_torch.engine import trainer as trainer_mod

    monkeypatch.setattr(tdata, "rank_and_world", lambda: (1, WORLD))
    monkeypatch.setattr(trainer_mod, "rank_and_world", lambda: (1, WORLD))
    args, cfgs = train.parse_config([
        "--cfg_file", str(ROOT / KITTI_CFG), "--batch_size", "2",
        "--num_devices", str(WORLD), "--device", "cpu", "--workers", "1",
        "--log_dir", str(tmp_path), "--set", "DATA.DATA_PATH", tree,
        "TPU.POINT_CAP_PER_SCAN", "4096", "TPU.VOXEL_CAP_PER_SCAN", "4096",
        "MODEL.NUM_LAYER", "[1,1,1,1,1,1,1,1]", "MODEL.cr", "0.25"])
    t = trainer_mod.Trainer(args, cfgs)
    try:
        loader = t.train_loader
        assert (t.global_batch, loader.batch_size, loader.local_bs,
                loader.process_index) == (4, 4, 2, 1)
        assert len(loader) == 1                   # 4 train scans, drop_last
        assert next(iter(loader))["xyz"].shape[0] == 2
        assert (t.val_loader.batch_size, len(t.val_loader)) == (4, 1)
        assert t.task.optim_cfg["LR"] == pytest.approx(
            cfgs.OPTIM.LR_PER_SAMPLE * 2 * WORLD)
        assert t.task.caps[0] == 4096 * 2         # caps hold the rank's 2
        assert t.metrics is None and t.tb is None     # rank 0 writes
    finally:
        t.close()


def test_loader_ranks_draw_their_own_augmentations():
    """Every rank draws the same epoch seed; each must still augment its
    slice of the global batch apart from the others' (one process loading
    the whole batch draws each sample's in turn), and rank 0 keeps the
    one-process stream (what the loader tests hold to JAX's)."""
    from openpcseg_torch.data.voxel_view import BatchLoader

    class Draws:
        """Each sample: its index and one draw of its generator."""

        def __len__(self):
            return 8

        def get_with_rng(self, i, rng):
            return {"x": np.array([i, rng.random()])}

    def epochs(pi, pc):
        loader = BatchLoader(Draws(), 4, shuffle=True, num_workers=1, seed=3,
                             process_index=pi, process_count=pc)
        return [np.concatenate([b["x"] for b in loader]) for _ in range(2)]

    one = epochs(0, 1)
    ranks = [epochs(r, WORLD) for r in range(WORLD)]
    for e in range(2):
        r0, r1 = ranks[0][e], ranks[1][e]
        # the ranks' slices tile the one-process epoch's indices
        np.testing.assert_array_equal(
            np.sort(np.concatenate([r0[:, 0], r1[:, 0]])), np.arange(8))
        np.testing.assert_array_equal(
            r0[:, 0], one[e][:, 0].reshape(2, 4)[:, :2].reshape(-1))
        # rank 1's k-th sample draws apart from rank 0's k-th
        assert not np.isin(r1[:, 1], r0[:, 1]).any()
        # rank 0 draws what one process draws for its first samples
        np.testing.assert_array_equal(r0[:, 1], one[e][:4, 1])


def _dist_train(tree, log_dir, epochs):
    env = dict(os.environ, PYTHON=sys.executable, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT))
    return subprocess.run(
        ["sh", str(ROOT / "openpcseg_torch/cli/dist_train.sh"), str(WORLD),
         "--cfg_file", str(ROOT / KITTI_CFG), "--extra_tag", "dp",
         "--log_dir", str(log_dir), "--batch_size", "1", "--workers", "1",
         "--device", "cpu", "--epochs", str(epochs), "--log_interval", "1",
         "--set", "DATA.DATA_PATH", tree, "TPU.POINT_CAP_PER_SCAN", "4096",
         "TPU.VOXEL_CAP_PER_SCAN", "4096", "TPU.VOXEL_CAP_RATIOS",
         "[1.0,1.0,1.0,1.0,1.0]", "MODEL.NUM_LAYER", "[1,1,1,1,1,1,1,1]",
         "MODEL.cr", "0.25"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)


def test_torchrun_trains_checkpoints_on_rank0_and_resumes(tree, tmp_path):
    """``dist_train.sh 2 --device cpu``: two gloo ranks, 2 steps an epoch
    (4 train scans, global batch 2); rank 0 alone writes the checkpoint,
    the log file and metrics.jsonl; a rerun to 2 epochs resumes from
    epoch 0 on both ranks."""
    import json

    logs = tmp_path / "logs"
    for epochs in (1, 2):
        res = _dist_train(tree, logs, epochs)
        assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    exp = next(logs.glob("**/ckp")).parent
    assert sorted(p.name for p in (exp / "ckp").iterdir()) == ["0.pt", "1.pt"]
    assert len(list(exp.glob("log_train_*.txt"))) == 2      # one a run
    text = "".join(p.read_text() for p in exp.glob("log_train_*.txt"))
    assert "resumed from epoch 0" in text
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").open()]
    steps = [r for r in recs if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and r["voxel_overflow"] == 0
               for r in steps)
    assert sum("val_miou" in r for r in recs) == 2
    payload = torch.load(exp / "ckp" / "1.pt", weights_only=True)
    assert payload["step"] == 4 and payload["epoch"] == 1
