"""The port's Trainer and CLIs on the CPU (``--device cpu``, a narrow
MinkUNet, caps of 8192): train -> resume -> infer end to end on a mini
SemanticKITTI tree, a checkpoint restored bit for bit with the LR schedule
going on where it stopped, the profiler trace, checkpoint pruning and the
shape-tolerant pretrained load. Against the JAX package's Trainer:
tests/test_torch_trainer_jax.py."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from mini_trees import make_mini_kitti
from torch_threads import one_torch_thread  # noqa: F401

from openpcseg_tpu.data.semantickitti_meta import LEARNING_MAP_INV_LUT
from openpcseg_torch.cli import infer, train
from openpcseg_torch.engine import trainer as trainer_mod
from openpcseg_torch.engine.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1]
CFG = "tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10.yaml"
N_PTS = 3000
# no level overflows: every level holds the whole batch
TINY = ["TPU.POINT_CAP_PER_SCAN", "8192", "TPU.VOXEL_CAP_PER_SCAN", "8192",
        "TPU.VOXEL_CAP_RATIOS", "[1.0,1.0,1.0,1.0,1.0]",
        "MODEL.NUM_LAYER", "[1,1,1,1,1,1,1,1]", "MODEL.cr", "0.25"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti") / "sequences"
    make_mini_kitti(root, seqs=("00",), scans_per_seq=4, n_pts=N_PTS, seed=3)
    make_mini_kitti(root, seqs=("08",), scans_per_seq=3, n_pts=N_PTS, seed=4)
    return str(root)


def _argv(tree, log_dir, *extra, sets=()):
    return ["--cfg_file", str(ROOT / CFG), "--extra_tag", "t",
            "--log_dir", str(log_dir), "--batch_size", "2", "--workers", "2",
            "--device", "cpu", *extra, "--set", "DATA.DATA_PATH", tree,
            *TINY, *sets]


def _log_text(exp_dir):
    return "".join(p.read_text() for p in sorted(exp_dir.glob("log_*.txt")))


def test_train_resume_infer_end_to_end(tree, tmp_path):
    logs = tmp_path / "logs"
    assert train.main(_argv(tree, logs, "--epochs", "1",
                            "--log_interval", "1")) == 0
    exp = next(logs.glob("**/ckp")).parent
    assert sorted(p.name for p in (exp / "ckp").iterdir()) == ["0.pt"]
    assert train.main(_argv(tree, logs, "--epochs", "2",
                            "--log_interval", "1")) == 0
    assert sorted(p.name for p in (exp / "ckp").iterdir()) == ["0.pt", "1.pt"]
    assert "resumed from epoch 0" in _log_text(exp)
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").open()]
    steps = [r for r in recs if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and r["voxel_overflow"] == 0
               for r in steps)
    assert sum("val_miou" in r for r in recs) == 2
    assert any((exp / "tensorboard").iterdir())

    preds = tmp_path / "preds"
    assert infer.main(_argv(tree, logs, "--save_pred", "--save_raw_ids",
                            sets=["DATA.OUTPUT_DIR", str(preds)])) == 0
    assert "resumed from epoch 1" in _log_text(exp)
    labels = sorted(preds.glob("sequences/08/predictions/*.label"))
    assert [f.name for f in labels] == [f"{i:06d}.label" for i in range(3)]
    legal = set(np.asarray(LEARNING_MAP_INV_LUT).tolist())
    for f in labels:
        raw = np.fromfile(f, dtype=np.uint32)
        assert len(raw) == N_PTS            # one id per point of the scan
        assert set(np.unique(raw).tolist()) <= legal

    npy = tmp_path / "npy"
    assert infer.main(_argv(tree, logs, "--save_pred",
                            sets=["DATA.OUTPUT_DIR", str(npy)])) == 0
    files = sorted(npy.glob("*.npy"))
    assert [f.name for f in files] == [f"08_{i:06d}.npy" for i in range(3)]
    p = np.load(files[0])
    assert p.dtype == np.int32 and p.shape == (N_PTS,)


def test_restore_is_bit_exact_and_the_lr_goes_on(tree, tmp_path):
    args, cfgs = train.parse_config(_argv(tree, tmp_path, "--epochs", "3",
                                          "--log_interval", "1"))
    t1 = Trainer(args, cfgs)
    t1.train_one_epoch(0)
    path = t1.save_checkpoint(0)
    opt1 = t1.task.optimizer
    saved = {n: p.detach().clone() for n, p in
             t1.task.model.named_parameters()}
    bufs = {n: opt1.state[p]["momentum_buffer"].clone()
            for n, p in t1.task.model.named_parameters()}
    step = t1.task.step
    assert step == len(t1.train_loader) == 2
    t1.close()

    args, cfgs = train.parse_config(_argv(tree, tmp_path, "--epochs", "3",
                                          "--ckp", str(path)))
    t2 = Trainer(args, cfgs)
    t2.init_or_resume()
    assert t2.task.step == step and t2.start_epoch == 1
    opt2 = t2.task.optimizer
    for n, p in t2.task.model.named_parameters():
        assert torch.equal(p.detach(), saved[n]), n
        assert torch.equal(opt2.state[p]["momentum_buffer"], bufs[n]), n
        assert opt2.state[p]["momentum_buffer"].device == p.device
    assert torch.equal(t2.task.generator.get_state(),
                       t1.task.generator.get_state())
    batch = next(iter(t2.train_loader))
    m = t2.task.train_step(t2._device_batch(batch))
    assert m["lr"] == t2.task.lr_fn(step) != t2.task.lr_fn(0)
    t2.close()


def test_profile_pruning_and_shape_tolerant_pretrained_load(
        tree, tmp_path, monkeypatch):
    """--profile_dir writes a trace of the profiled steps; only the newest
    --max_ckp_save_num checkpoints stay; --pretrained_ckp loads every saved
    tensor whose name and shape match and skips the rest."""
    monkeypatch.setattr(trainer_mod, "PROFILE_STEPS", (0, 1))
    args, cfgs = train.parse_config(_argv(
        tree, tmp_path / "a", "--max_ckp_save_num", "2", "--profile_dir",
        str(tmp_path / "prof")))
    t1 = Trainer(args, cfgs)
    t1.train_one_epoch(0)
    assert len(list((tmp_path / "prof").glob("trace_*.json"))) == 1
    for epoch in range(4):
        t1.save_checkpoint(epoch)
    assert [e for e, _ in t1.checkpoints()] == [2, 3]
    payload = torch.load(t1.latest_checkpoint(), weights_only=True)
    t1.close()

    saved = payload["model"]
    head = next(k for k in saved if k.startswith("classifier"))
    saved[head] = torch.zeros(3)               # a head of another width
    gone = next(k for k in saved if k.endswith("running_mean"))
    del saved[gone]
    torch.save(payload, tmp_path / "pre.pt")
    args, cfgs = train.parse_config(_argv(
        tree, tmp_path / "b", "--seed", "5", "--pretrained_ckp",
        str(tmp_path / "pre.pt")))
    t2 = Trainer(args, cfgs)
    fresh = {k: v.clone() for k, v in t2.task.model.state_dict().items()}
    t2.init_or_resume()
    got = t2.task.model.state_dict()
    for k, v in got.items():
        want = fresh[k] if k in (head, gone) else saved[k]
        assert torch.equal(v, want), k
    assert t2.start_epoch == 0 and t2.task.step == 0
    assert "skipped (missing/shape-mismatch)" in _log_text(t2.exp_dir)
    t2.close()


def test_entry_points_target_the_card_and_raise_for_unported(tree, tmp_path):
    args, cfgs = train.parse_config(["--cfg_file", str(ROOT / CFG)])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(args, cfgs)
    args, cfgs = train.parse_config(_argv(tree, tmp_path, "--num_devices",
                                          "2"))
    with pytest.raises(NotImplementedError, match="item 10"):
        Trainer(args, cfgs)
    with pytest.raises(NotImplementedError, match="item 15"):
        infer.main(_argv(tree, tmp_path, "--tta"))


CYL_CFG = "tools/cfgs/voxel/semantic_kitti/cylinder_cy480_cr10.yaml"
CYL_TINY = ["TPU.POINT_CAP_PER_SCAN", "4096", "TPU.VOXEL_CAP_PER_SCAN",
            "4096", "TPU.VOXEL_CAP_RATIOS", "[1.0,1.0,1.0,1.0,1.0]",
            "MODEL.INIT_SIZE", "8"]


def test_cylinder_yaml_trains_and_infers(tree, tmp_path):
    """The Cylinder3D yaml as it stands (cylinder view, cylindrical
    partition, point-refinement loss) through the train CLI for an epoch
    and the infer CLI's raw-id dump from its checkpoint, narrowed to
    INIT_SIZE 8."""
    logs, preds = tmp_path / "logs", tmp_path / "preds"

    def argv(*extra, sets=()):
        return ["--cfg_file", str(ROOT / CYL_CFG), "--extra_tag", "c",
                "--log_dir", str(logs), "--batch_size", "2", "--workers",
                "2", "--device", "cpu", "--log_interval", "1", *extra,
                "--set", "DATA.DATA_PATH", tree, *CYL_TINY, *sets]
    assert train.main(argv("--epochs", "1")) == 0
    exp = next(logs.glob("**/ckp")).parent
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").open()]
    steps = [r for r in recs if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["voxel_overflow"] == 0
               for r in steps)
    assert infer.main(argv("--save_pred", "--save_raw_ids",
                           sets=["DATA.OUTPUT_DIR", str(preds)])) == 0
    assert "resumed from epoch 0" in _log_text(exp)
    labels = sorted(preds.glob("sequences/08/predictions/*.label"))
    assert len(labels) == 3
    legal = set(np.asarray(LEARNING_MAP_INV_LUT).tolist())
    for f in labels:
        raw = np.fromfile(f, dtype=np.uint32)
        assert len(raw) == N_PTS and set(np.unique(raw).tolist()) <= legal
