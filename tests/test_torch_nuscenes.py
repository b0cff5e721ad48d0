"""The port's nuScenes-lidarseg layer (openpcseg_torch/data/nuscenes.py,
nuscenes_meta.py, the ray-cast tree writer data/raycast_nuscenes.py), the
submission dump and CENet 32 x 1088 against the JAX package on the CPU.

- The copies of ``data/nuscenes.py`` and ``data/nuscenes_meta.py`` are the
  JAX package's modules with longer docstrings, and their tables equal.
- Every nuScenes view (voxel, cylinder, range, fusion), from the DATA block
  of its shipped yaml, gives JAX's batches byte for byte over two epochs:
  training with the yaml's augmentation (GlobalAugment_LP: LaserMix /
  PolarMix, ring ids rebuilt by ``ring_from_pitch``) and without, and eval
  with its <pad> tail, on tests/test_nuscenes.py's mini tree and on a tree
  of the ray-cast writer, with the range view's projection on its numpy
  path on both sides (``numpy_projection``, as tests/test_torch_range_data.py
  has it); the range view also on both sides' default path, the native
  C++ z-buffer. The scene split, SPLIT_FILE and
  ``ring_from_pitch`` give JAX's answers.
- ``cli/infer.py dump_predictions`` writes JAX's nuScenes submission files
  (lidarseg/val/<sample_data_token>_lidarseg.bin, uint8 raw ids) byte for
  byte under tests/test_nuscenes.py's stub trainer.
- CENet (the shipped 32 x 1088 yaml, LAYERS all 1, its SGD with
  linear_warmup_with_cosdecay) on a batch of the ray-cast tree's range
  view: eval logits at 32 x 1088 within 1e-4 of their largest value, and
  one train step at 32 x 128 in float64 on both sides (the loss, lr,
  gradients, parameters and BN statistics at rtol = atol = 1e-6).
- The CLIs on the CPU with a narrow model: train, a resumed second epoch,
  infer --save_pred --save_raw_ids: one raw id per valid point in the
  submission layout.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_nuscenes import make_mini_nuscenes
from test_torch_minkunet import _perturb
from test_torch_train import _grad_stash, _named
from torch_threads import one_torch_thread  # noqa: F401

import openpcseg_tpu.data as jdata
from openpcseg_tpu import native as jnative
from openpcseg_tpu.config import CfgDict as JaxCfgDict
from openpcseg_tpu.data import nuscenes as jnusc
from openpcseg_tpu.data import nuscenes_meta as jmeta
from openpcseg_tpu.engine import SegTask as JaxSegTask
from openpcseg_tpu.engine import TrainState
from openpcseg_torch import data as tdata
from openpcseg_torch import native as tnative
from openpcseg_torch.cli import infer, train
from openpcseg_torch.config import CfgDict, cfg_from_yaml_file
from openpcseg_torch.data import nuscenes as tnusc
from openpcseg_torch.data import nuscenes_meta as tmeta
from openpcseg_torch.data import raycast_nuscenes
from openpcseg_torch.engine.task import SegTask, batch_to_device
from openpcseg_torch.utils.convert import jax_params_to_torch

ROOT = Path(__file__).resolve().parents[1]
NUM_CLASS = 17
VIEWS = {"voxel": "tools/cfgs/voxel/nuscenes/minkunet_mk34_cr10.yaml",
         "cylinder": "tools/cfgs/voxel/nuscenes/cylinder_cy480_cr10.yaml",
         "range": "tools/cfgs/range/nuscenes/cenet_32x1088.yaml",
         "fusion": "tools/cfgs/fusion/nuscenes/spvcnn_mk34_cr10.yaml"}
N_PTS = 4096


def _yaml(path):
    cfg = CfgDict()
    cfg_from_yaml_file(str(ROOT / path), cfg)
    return cfg


def _code(path):
    text = path.read_text()
    return text[text.index('"""', 3) + 3:]


@pytest.mark.parametrize("name", ["nuscenes", "nuscenes_meta"])
def test_copies_are_the_jax_modules(name):
    assert _code(ROOT / f"openpcseg_torch/data/{name}.py") == _code(
        ROOT / f"openpcseg_tpu/data/{name}.py")


def test_meta_tables_and_dataset_meta_match():
    for name in ("RAW_CATEGORIES", "LEARNING_MAP", "CLASS_NAMES",
                 "FOV_UP_DEG", "FOV_DOWN_DEG", "NUM_BEAMS", "COLOR_MAP"):
        assert getattr(tmeta, name) == getattr(jmeta, name), name
    for name in ("LEARNING_MAP_LUT", "LEARNING_MAP_INV"):
        np.testing.assert_array_equal(getattr(tmeta, name),
                                      getattr(jmeta, name))
    assert tdata.dataset_meta("nuscenes") == jdata.dataset_meta("nuscenes")
    assert len(tdata.dataset_meta("nuscenes")[0]) == NUM_CLASS


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    mini = make_mini_nuscenes(str(tmp_path_factory.mktemp("mini_nusc")))
    ray = raycast_nuscenes.write_tree(tmp_path_factory.mktemp("ray_nusc"),
                                      4, 2)
    return {"mini": mini, "raycast": ray}


@pytest.fixture
def numpy_projection(monkeypatch):
    monkeypatch.setattr(jnative, "range_project_native",
                        lambda *a, **k: None)
    monkeypatch.setattr(tnative, "range_project",
                        tnative.range_project_plain)


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def test_writer_tree_and_split(trees):
    """The writer's tree: the reader's default scene split puts its 4
    train and 2 val sweeps where it asked, with JAX's split; each sweep
    is [x, y, z, intensity, ring] in the sensor frame with lidarseg raw
    ids of the ray-cast classes, and ring_from_pitch (a fractional beam
    index) falls in its ring column's beam."""
    cfg = {"DATASET": "nuscenes", "DATA_PATH": trees["raycast"],
           "AUGMENT": "NoAugment"}
    for training, n in ((True, 4), (False, 2)):
        t = tnusc.NuscenesDataset(CfgDict(cfg), training=training)
        j = jnusc.NuscenesDataset(JaxCfgDict(cfg), training=training)
        assert t.annos == j.annos and len(t.annos) == n
    pts = np.fromfile(t.annos[0]["path"], np.float32).reshape(-1, 5)
    assert 25_000 < len(pts) <= 32 * 1088
    assert pts[:, 2].min() < -1.5                 # the ground, 1.84 m down
    labels = tmeta.LEARNING_MAP_LUT[np.fromfile(t.annos[0]["label"],
                                                np.uint8)]
    assert set(np.unique(labels).tolist()) <= set(
        raycast_nuscenes.NUSC_OF_RAYCAST.tolist())
    ring = tnusc.NuscenesDataset.ring_from_pitch(pts[:, :4])
    assert (np.floor(ring) == pts[:, 4]).mean() > 0.99
    np.testing.assert_array_equal(
        ring, jnusc.NuscenesDataset.ring_from_pitch(pts[:, :4]))


def test_scene_split_and_split_file_match_jax(trees, tmp_path):
    cfg = {"DATASET": "nuscenes", "DATA_PATH": trees["mini"],
           "AUGMENT": "NoAugment"}
    full = tnusc.NuscenesDataset(CfgDict(cfg), training=True)
    val = tnusc.NuscenesDataset(CfgDict(cfg), training=False)
    assert full.annos == jnusc.NuscenesDataset(JaxCfgDict(cfg)).annos
    assert not ({r["scene"] for r in full.annos}
                & {r["scene"] for r in val.annos})
    split = tmp_path / "split.txt"
    split.write_text(Path(full.annos[1]["path"]).name + "\n")
    cfg["SPLIT_FILE"] = str(split)
    t = tnusc.NuscenesDataset(CfgDict(cfg), training=True)
    j = jnusc.NuscenesDataset(JaxCfgDict(cfg), training=True)
    assert t.annos == j.annos == [full.annos[1]]
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 20, (5000, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tnusc.NuscenesDataset.ring_from_pitch(pts),
        jnusc.NuscenesDataset.ring_from_pitch(pts))


@pytest.mark.parametrize("tree", ["mini", "raycast"])
@pytest.mark.parametrize("modality", ["voxel", "cylinder", "range",
                                      "fusion"])
@pytest.mark.parametrize("mode", ["augment", "no_augment", "eval"])
def test_views_give_jax_batches_over_two_epochs(trees, numpy_projection,
                                                tree, modality, mode):
    _views_match(trees, tree, modality, mode)


@pytest.mark.parametrize("tree", ["mini", "raycast"])
@pytest.mark.parametrize("mode", ["augment", "no_augment", "eval"])
def test_range_view_gives_jax_native_batches(trees, tree, mode):
    """The range view on both sides' default path, the native projection
    (JAX's where its library builds): every image of the port's view
    through native.range_project, and JAX's bytes."""
    assert jnative.get_lib() is not None
    projected = tnative.READS["projection"]
    _views_match(trees, tree, "range", mode)
    assert tnative.READS["projection"] - projected >= 2


def _views_match(trees, tree, modality, mode):
    """The view of `modality` from its yaml's DATA block on `tree` under
    `mode`: JAX's batches byte for byte over two epochs."""
    data = dict(_yaml(VIEWS[modality]).DATA, DATA_PATH=trees[tree])
    if mode == "no_augment":
        data["AUGMENT"] = "NoAugment"
    # one loader thread: the range view's augmentations draw from the
    # view's own generator, so two threads would draw in a racing order
    kw = dict(training=mode != "eval", point_cap=N_PTS,
              num_workers=1 if modality == "range" else 2, seed=3)
    tset, tload = tdata.build_dataloader(CfgDict(data), modality, 2, **kw)
    jset, jload = jdata.build_dataloader(JaxCfgDict(data), modality, 2, **kw)
    assert type(tset).__name__ == type(jset).__name__
    for _ in range(2):
        got, want = list(tload), list(jload)
        assert len(got) == len(want) >= 1
        for g, w in zip(got, want):
            if modality == "range":
                assert g["scan"].shape == (2, 32, 1088, 6)
            elif modality == "fusion":
                assert g["range_image"].shape == (2, 32, 1088, 5)
            _same(g, w)
        tset.resample()
        jset.resample()


def test_submission_dump_matches_jax(trees, tmp_path):
    """tests/test_nuscenes.py test_raw_id_submission_dump's stub trainer
    through both dumps: the same lidarseg/val/<token>_lidarseg.bin
    bytes."""
    import infer as jinfer

    cfg = {"DATASET": "nuscenes", "DATA_PATH": trees["mini"],
           "AUGMENT": "NoAugment"}
    rec = jnusc.NuscenesDataset(JaxCfgDict(cfg), training=False).annos[0]
    n = 64
    preds = np.tile(np.arange(NUM_CLASS, dtype=np.int32), n // 17 + 1)[
        None, :n]

    def stub(src, task, cfg_cls, init=None):
        class Trainer:
            cfgs = cfg_cls({"DATA": {"DATASET": "nuscenes"}})
            val_set = src
            val_loader = [{"name": [rec["path"]],
                           "valid": np.ones((1, n), bool)}]
            state = None

            def _device_batch(self, b):
                return {k: v for k, v in b.items() if k != "name"}
        Trainer.task = task
        if init:
            Trainer.init_or_resume = init
        return Trainer()

    class JaxTask:
        def predict_step(self, state, batch):
            return jnp.asarray(preds)

    class PortTask:
        def predict_step(self, batch):
            return torch.as_tensor(preds)

    jsrc = jnusc.NuscenesDataset(JaxCfgDict(cfg), training=False)
    tsrc = tnusc.NuscenesDataset(CfgDict(cfg), training=False)
    assert jinfer.dump_predictions(stub(jsrc, JaxTask(), JaxCfgDict),
                                   tmp_path / "jax", raw_ids=True) == 1
    assert infer.dump_predictions(stub(tsrc, PortTask(), CfgDict,
                                       lambda self: None),
                                  tmp_path / "port", raw_ids=True) == 1
    name = f"lidarseg/val/{rec['token']}_lidarseg.bin"
    got = (tmp_path / "port" / name).read_bytes()
    assert got == (tmp_path / "jax" / name).read_bytes()
    raw = np.frombuffer(got, np.uint8)
    assert len(raw) == n
    np.testing.assert_array_equal(tmeta.LEARNING_MAP_LUT[raw], preds[0])


def _cenet(trees, w):
    """CENet from the shipped yaml (LAYERS all 1, its SGD with
    linear_warmup_with_cosdecay) and a batch of 1 of the ray-cast tree's
    range view at 32 x `w`."""
    y = _yaml(VIEWS["range"])
    data = dict(y.DATA, DATA_PATH=trees["raycast"], AUGMENT="NoAugment",
                W=w)
    _, loader = tdata.build_dataloader(CfgDict(data), "range", 1,
                                       training=True, point_cap=N_PTS,
                                       num_workers=1)
    batch = {k: v for k, v in next(iter(loader)).items()
             if k in ("scan", "label", "mask")}
    assert batch["scan"].shape == (1, 32, w, 6)
    optim = dict(y.OPTIM, BATCH_SIZE_PER_GPU=1)
    assert (optim["OPTIMIZER"], optim["SCHEDULER"]) == (
        "sgd", "linear_warmup_with_cosdecay")
    cfgs = {"MODALITY": "range", "DATA": data,
            "MODEL": dict(y.MODEL, LAYERS=[1, 1, 1, 1]), "OPTIM": optim}
    rng = np.random.default_rng(0)
    jtask = JaxSegTask(JaxCfgDict(cfgs), num_class=NUM_CLASS,
                       batch_per_device=1, iters_per_epoch=2)
    jtask.tx = optax.chain(_grad_stash(), jtask.tx)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jtask.init_state(jax.random.PRNGKey(0), jb)
    params, stats = jax.device_get((_perturb(state.params, rng),
                                    _perturb(state.batch_stats, rng)))
    task = SegTask(cfgs, NUM_CLASS, device="cpu", iters_per_epoch=2)
    jax_params_to_torch(params, stats, task.model)
    return dict(cfgs=cfgs, batch=batch, jtask=jtask, task=task,
                state=state.replace(params=params, batch_stats=stats,
                                    opt_state=jtask.tx.init(params)))


def test_cenet_32x1088_eval_logits_match(trees, numpy_projection):
    """The eval logits at the yaml's 32 x 1088, float32 both sides, within
    1e-4 of their largest value (tests/range_parity.py's bound)."""
    c = _cenet(trees, 1088)
    jtask, s = c["jtask"], c["state"]
    want = np.asarray(jax.jit(lambda x: jtask.model.apply(
        {"params": s.params, "batch_stats": s.batch_stats}, x,
        train=False)[0])(jnp.asarray(c["batch"]["scan"])))
    got = c["task"].range_logits(batch_to_device(
        c["batch"], "cpu")).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 32, 1088, NUM_CLASS)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_cenet_32_row_sgd_step_matches(trees, numpy_projection):
    """One SGD + linear_warmup_with_cosdecay step on a 32-row image, 128
    columns wide (XLA's float64 convs at 32 x 1088 take minutes on the
    CPU), in float64 on both sides, as tests/range_parity.py
    check_three_steps holds the range models' AdamW steps (in float32 the
    BN statistics of near-constant channels make the step ill-conditioned:
    the port's and XLA's float32 steps land up to 1e-3 of a gradient's
    scale from the exact one here): the loss at rtol 1e-6, the lr, every
    raw gradient, the parameters and BN statistics after the step at rtol
    = atol = 1e-6."""
    c = _cenet(trees, 128)
    jtask, state, cfgs = c["jtask"], c["state"], c["cfgs"]
    with jax.enable_x64(True):
        st = state.replace(**{k: jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)),
            getattr(state, k)) for k in ("params", "batch_stats")})
        st = st.replace(opt_state=jtask.tx.init(st.params))
        b = {k: jnp.asarray(v.astype(np.float64) if k == "scan" else v)
             for k, v in c["batch"].items()}
        new, jm = jax.device_get(jax.jit(jtask.train_step)(
            st, b, jax.random.PRNGKey(1)))
    task = c["task"]
    task.model.double()
    m = task.train_step(batch_to_device(
        dict(c["batch"], scan=c["batch"]["scan"].astype(np.float64)),
        "cpu"))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    clip = cfgs["OPTIM"]["GRAD_NORM_CLIP"]
    coef = min(1.0, clip / (float(m["grad_norm"]) + 1e-6))
    got = {n: g / coef for n, g in _named(task.model, "grad").items()}
    for tree, have in ((new.opt_state[0], got),
                       (new.params, _named(task.model))):
        twin = SegTask(cfgs, NUM_CLASS, device="cpu").model.double()
        jax_params_to_torch(tree, new.batch_stats, twin)
        want = _named(twin)
        assert set(have) == set(want)
        for n in want:
            np.testing.assert_allclose(have[n], want[n], rtol=1e-6,
                                       atol=1e-6, err_msg=n)
    stats = {n: b.numpy() for n, b in twin.named_buffers()}
    for n, b in task.model.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[n], rtol=1e-6,
                                   atol=1e-6, err_msg=n)


TINY = ["TPU.POINT_CAP_PER_SCAN", str(N_PTS), "TPU.VOXEL_CAP_PER_SCAN",
        str(2 * N_PTS), "TPU.VOXEL_CAP_RATIOS", "[1.0,1.0,1.0,1.0,1.0]",
        "MODEL.NUM_LAYER", "[1,1,1,1,1,1,1,1]", "MODEL.cr", "0.25"]


def test_cli_train_resume_and_submission_dump(trees, tmp_path):
    """cli/train.py on the nuScenes MinkUNet yaml (narrow, CPU) for an epoch
    and a resumed second, then cli/infer.py --save_pred --save_raw_ids:
    one lidarseg/val/<token>_lidarseg.bin per val sweep, one raw id per
    point."""
    logs, out = tmp_path / "logs", tmp_path / "preds"
    argv = ["--cfg_file", str(ROOT / VIEWS["voxel"]), "--extra_tag", "t",
            "--log_dir", str(logs), "--batch_size", "2", "--workers", "1",
            "--device", "cpu"]
    sets = ["--set", "DATA.DATA_PATH", trees["mini"], *TINY]
    for epochs in ("1", "2"):
        assert train.main(argv + ["--epochs", epochs, "--log_interval",
                                  "1"] + sets) == 0
    exp = next(logs.glob("**/ckp")).parent
    text = "".join(p.read_text() for p in exp.glob("log_*.txt"))
    assert "resumed from epoch 0" in text
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").open()]
    steps = [r for r in recs if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and r["voxel_overflow"] == 0
               for r in steps)
    assert infer.main(argv + ["--save_pred", "--save_raw_ids"] + sets
                      + ["DATA.OUTPUT_DIR", str(out)]) == 0
    val = tnusc.NuscenesDataset(CfgDict({"DATASET": "nuscenes",
                                         "DATA_PATH": trees["mini"]}),
                                training=False).annos
    files = sorted(out.glob("lidarseg/val/*_lidarseg.bin"))
    assert [f.name for f in files] == sorted(
        f"{r['token']}_lidarseg.bin" for r in val)
    legal = set(tmeta.LEARNING_MAP_INV.tolist())
    for f in files:
        raw = np.fromfile(f, np.uint8)
        assert len(raw) == 2048                   # every point of a sweep
        assert set(np.unique(raw).tolist()) <= legal
