"""The port's Waymo Open layer (openpcseg_torch/data/waymo.py, the copy of
waymo_conversion.py, the ray-cast tree writer data/raycast_waymo.py) and
the models at the shipped Waymo yamls' settings, against the JAX package
on the CPU.

- The copies of ``data/waymo.py`` and ``data/waymo_conversion.py`` are the
  JAX package's modules with longer docstrings; the four round-trip cases
  of tests/test_waymo_conversion.py pass on the port's copy.
- Every Waymo view (voxel, cylinder, fusion), from the DATA block of its
  shipped yaml, gives JAX's batches byte for byte over two epochs: training
  with the yaml's augmentation and without, and eval with its <pad> tail,
  on a mini tree (tests/mini_trees.py make_mini_waymo) and on a tree of the
  ray-cast writer; the fusion view's image is 64 x 2656.
  ``WaymoInferDataset`` globs DATA_PATH/first/*.npy, reads the sibling
  second/ return and zeroes the labels, as JAX's does.
- Models, float32 on the CPU, weights from the port's seeded initializer
  through flax's layout with every BN leaf and bias perturbed, on
  ray-cast Waymo frames of 2048 points (caps where JAX's voxel_overflow is
  0): MinkUNet mk34_cr16 (widths 51-409, NUM_LAYER all 1) with the
  5-channel stem and the _xyz yaml's 3-channel one, its eval logits within
  1e-3 of their largest value and its loss (CE with label smoothing +
  Lovász) at rtol 1e-5; Cylinder3D cy480_cr10 on Waymo's 5-column input:
  the 10-wide point features within one float32 ulp and the logits and
  point-refine logits at rtol = atol = 1e-3 (tests/test_torch_cylinder.py's
  bounds); RPVNet (tests/test_waymo_fusion.py's widths, the mk18_cr10
  yaml's SGD) on a batch of the Waymo fusion view (64 x 2656): one SGD
  step, the port's float32 against JAX's float64 as
  tests/test_torch_rpvnet.py holds it (the loss at rtol 1e-5, every
  gradient at rtol = atol = 1e-4, the whole gradient within 1e-4 of its
  norm).
- The CLIs on the CPU with a narrow model: train, a resumed second epoch,
  and the _infer yaml streaming an unlabeled first/ sequence: one .npy per
  frame, one id per valid point.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import test_waymo_conversion as jconv_cases
import torch
from mini_trees import make_mini_waymo
from test_torch_data import _same_batch
from test_torch_minkunet import _perturb
from test_torch_rpvnet import no_flax_dropout
from test_torch_train import _grad_stash, _named
from test_torch_train_ref import torch_to_jax, variable_shapes
from torch_threads import one_torch_thread  # noqa: F401

import openpcseg_tpu.data as jdata
from openpcseg_tpu.config import CfgDict as JaxCfgDict
from openpcseg_tpu.engine import SegTask as JaxSegTask
from openpcseg_tpu.engine import TrainState
from openpcseg_torch import data as tdata
from openpcseg_torch.cli import infer, train
from openpcseg_torch.config import CfgDict, cfg_from_yaml_file
from openpcseg_torch.data import raycast_waymo, waymo_conversion
from openpcseg_torch.engine.task import SegTask, batch_to_device
from openpcseg_torch.utils.convert import jax_params_to_torch

ROOT = Path(__file__).resolve().parents[1]
NUM_CLASS = 23
MINK = "tools/cfgs/voxel/waymo/minkunet_mk34_cr16.yaml"
MINK_XYZ = "tools/cfgs/voxel/waymo/minkunet_mk34_cr16_xyz.yaml"
MINK_INFER = "tools/cfgs/voxel/waymo/minkunet_mk34_cr16_infer.yaml"
CYL = "tools/cfgs/voxel/waymo/cylinder_cy480_cr10.yaml"
RPV = "tools/cfgs/fusion/waymo/rpvnet_mk18_cr10.yaml"
VIEWS = {"voxel": MINK, "cylinder": CYL, "fusion": RPV}
N_PTS = 4096      # the loaders' point cap
N_MODEL = 2048    # the points of a model test's frame
# every level holds the whole frame: no voxel dropped on either side
CAPS = {"VOXEL_CAP_PER_SCAN": N_MODEL, "VOXEL_CAP_RATIOS": [1.0] * 5}
# the RPVNet step's widths: tests/test_waymo_fusion.py's (its network is
# test_rpvnet_on_waymo_one_step's, over the yaml's SGD)
STEP_PLANES = [8, 8, 16, 16, 16, 16, 16, 8, 8]


def _yaml(path):
    cfg = CfgDict()
    cfg_from_yaml_file(str(ROOT / path), cfg)
    return cfg


def _code(path):
    text = path.read_text()
    return text[text.index('"""', 3) + 3:]


@pytest.mark.parametrize("name", ["waymo", "waymo_conversion"])
def test_copies_are_the_jax_modules(name):
    """The port's modules are the JAX package's with longer docstrings."""
    assert _code(ROOT / f"openpcseg_torch/data/{name}.py") == _code(
        ROOT / f"openpcseg_tpu/data/{name}.py")


@pytest.mark.parametrize("case", [
    "test_roundtrip_identity_extrinsic", "test_roundtrip_with_extrinsic",
    "test_pixel_pose_roundtrip", "test_points_layout_and_mask"])
def test_conversion_round_trips_on_the_port(monkeypatch, case):
    """tests/test_waymo_conversion.py's cases, run on the port's copy."""
    for fn in ("compute_inclinations", "range_image_to_cartesian",
               "range_image_to_points"):
        monkeypatch.setattr(jconv_cases, fn, getattr(waymo_conversion, fn))
    getattr(jconv_cases, case)()


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    mini = tmp_path_factory.mktemp("mini_waymo")
    make_mini_waymo(mini, n_frames=3, n_pts=3000, seed=1, training=True)
    make_mini_waymo(mini, n_frames=2, n_pts=3000, seed=2, training=False)
    ray = tmp_path_factory.mktemp("raycast_waymo")
    raycast_waymo.write_tree(ray, 2, 1)
    raycast_waymo.write_sequence(ray / "sequence", 1)
    return {"mini": str(mini), "raycast": str(ray)}


def test_writer_tree_layout(trees):
    """The writer's tree: split lists of absolute first/ paths, each frame's
    second return beside it, rows [range, intensity, elongation, x, y, z,
    label] with Waymo train ids, and the unlabeled sequence."""
    root = Path(trees["raycast"])
    train_list = (root / "train-0-31.txt").read_text().split()
    assert train_list == [str(root / "first" / f"train_{i:06d}.npy")
                          for i in range(2)]
    assert (root / "val-0-7.txt").read_text().split() == [
        str(root / "first" / "val_000000.npy")]
    first, second = np.load(train_list[0]), np.load(
        train_list[0].replace("first/", "second/"))
    assert first.dtype == second.dtype == np.float32
    assert first.shape[1] == second.shape[1] == 7
    assert 150_000 < len(first) + len(second) < 196_608
    xyz = first[:, 3:6] - np.float32([0, 0, raycast_waymo.SENSOR_Z])
    np.testing.assert_allclose(np.linalg.norm(xyz, axis=1), first[:, 0],
                               rtol=1e-5)
    labels = set(np.unique(first[:, 6]).astype(int).tolist())
    assert labels <= set(raycast_waymo.WAYMO_OF_RAYCAST.tolist())
    assert len(labels) >= 8
    seq = np.load(root / "sequence" / "first" / "000000.npy")
    assert (seq[:, 6] == 0).all()
    batch = raycast_waymo.frame_batch(0, N_PTS)
    assert batch["feats"].shape == (1, N_PTS, 5) and batch["valid"].all()


@pytest.mark.parametrize("tree", ["mini", "raycast"])
@pytest.mark.parametrize("modality", ["voxel", "cylinder", "fusion"])
@pytest.mark.parametrize("mode", ["augment", "no_augment", "eval"])
def test_views_give_jax_batches_over_two_epochs(trees, tree, modality,
                                                mode):
    data = dict(_yaml(VIEWS[modality]).DATA, DATA_PATH=trees[tree])
    if mode == "no_augment":
        data["AUGMENT"] = "NoAugment"
    kw = dict(training=mode != "eval", point_cap=N_PTS, num_workers=2,
              seed=5)
    tset, tload = tdata.build_dataloader(CfgDict(data), modality, 2, **kw)
    jset, jload = jdata.build_dataloader(JaxCfgDict(data), modality, 2, **kw)
    assert type(tset).__name__ == type(jset).__name__
    assert tset.class_names == jset.class_names == tdata.WAYMO_CLASS_NAMES
    for _ in range(2):
        got, want = list(tload), list(jload)
        assert len(got) == len(want) == 1
        for g, w in zip(got, want):
            assert g["feats"].shape == (2, N_PTS, 5)
            if modality == "fusion":
                assert g["range_image"].shape == (2, 64, 2656, 5)
            _same_batch(g, w)
        tset.resample()
        jset.resample()


def test_infer_dataset_streams_an_unlabeled_sequence(trees):
    """WaymoInferDataset (the _infer yaml's USE_INFER_DATA) globs
    DATA_PATH/first/*.npy, not INPUT_DIR, appends the sibling second/
    return, tanh-squashes intensity and elongation and zeroes the labels;
    the voxel view over it gives JAX's batches."""
    seq = Path(trees["raycast"]) / "sequence"
    data = dict(_yaml(MINK_INFER).DATA, DATA_PATH=str(seq))
    assert data["USE_INFER_DATA"] and data["INPUT_DIR"] != str(seq)
    t = tdata.WaymoInferDataset(CfgDict(data))
    j = jdata.WaymoInferDataset(JaxCfgDict(data))
    assert t.annos == j.annos == [str(seq / "first" / "000000.npy")]
    got, want = t[0], j[0]
    first = np.load(seq / "first" / "000000.npy")
    second = np.load(seq / "second" / "000000.npy")
    assert len(got["xyzret"]) == len(first) + len(second)
    np.testing.assert_array_equal(got["xyzret"][:len(first), 3:],
                                  np.tanh(first[:, 1:3]))
    assert not got["labels"].any()
    for k in ("xyzret", "labels"):
        np.testing.assert_array_equal(got[k], want[k])
    kw = dict(training=False, point_cap=196_608, num_workers=1, seed=0)
    _, tload = tdata.build_dataloader(CfgDict(data), "voxel", 1, **kw)
    _, jload = jdata.build_dataloader(JaxCfgDict(data), "voxel", 1, **kw)
    (g,), (w,) = list(tload), list(jload)
    assert int(g["valid"].sum()) == len(first) + len(second)
    _same_batch(g, w)


def test_dataset_meta_names_the_waymo_classes():
    assert tdata.dataset_meta("waymo") == jdata.dataset_meta("waymo")
    assert len(tdata.dataset_meta("waymo")[0]) == NUM_CLASS


# ------------------------------------------------------------- models --

def _variables(task, jtask, jb, cfgs, rng):
    """The port's seeded weights in flax's layout, every BN leaf and bias
    perturbed, loaded back into the port: (params, batch_stats)."""
    params, stats = torch_to_jax(task.model, *variable_shapes(jtask, jb),
                                 cfgs=cfgs, num_class=NUM_CLASS)
    params, stats = jax.tree_util.tree_map(
        np.array, (_perturb(params, rng), _perturb(stats, rng)))
    jax_params_to_torch(params, stats, task.model)
    return params, stats


def _eval_sides(cfgs, batch):
    """Eval forward of both sides on the same variables: (JAX's voxel
    batch, outputs, loss, overflow; the port's)."""
    rng = np.random.default_rng(0)
    jtask = JaxSegTask(JaxCfgDict(cfgs), num_class=NUM_CLASS,
                       batch_per_device=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    task = SegTask(cfgs, NUM_CLASS, device="cpu")
    params, stats = _variables(task, jtask, jb, cfgs, rng)
    if cfgs["MODALITY"] == "cylinder":   # JAX's BN formula on raw features
        task.model.point_bns[0].centered = False

    @jax.jit
    def jax_eval(b):
        vb, pyr = jtask.preprocess(b)
        out = jtask.model.apply({"params": params, "batch_stats": stats},
                                jtask._model_inputs(vb, b), pyr,
                                train=False)
        logits = out[0] if isinstance(out, tuple) else out
        caps = jnp.asarray(jtask.caps)
        over = (jnp.maximum(vb.num_voxels - jtask.caps[0], 0)
                + jnp.sum(jnp.maximum(pyr.level_counts - caps, 0)))
        return vb, out, jtask.losses(logits, vb.voxel_labels,
                                     vb.voxel_valid), over

    j = jax.device_get(jax_eval(jb))
    tb = batch_to_device(batch, "cpu")
    with torch.no_grad():
        task.model.eval()
        tvb, tpyr = task.preprocess(tb)
        out = task._run_model(tvb, tpyr, tb)
        loss = task.losses(out[0], tvb.voxel_labels, tvb.voxel_valid)
    return j, (tvb, out, loss, task.voxel_overflow(tvb, tpyr))


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


@pytest.mark.parametrize("path", [MINK, MINK_XYZ])
def test_minkunet_cr16_logits_and_loss_match(path):
    """MinkUNet mk34_cr16 at the yaml's widths (51-409; NUM_LAYER all 1)
    with its 5- or 3-channel stem."""
    y = _yaml(path)
    cfgs = {"MODALITY": "voxel", "DATA": dict(y.DATA),
            "MODEL": dict(y.MODEL, NUM_LAYER=[1] * 8),
            "OPTIM": dict(y.OPTIM), "TPU": CAPS}
    (jvb, jout, jloss, jover), (tvb, tout, tloss, tover) = _eval_sides(
        cfgs, raycast_waymo.frame_batch(3, N_MODEL))
    assert int(jover) == int(tover) == 0
    t, j = _np(tout[0]), np.asarray(jout)
    assert t.shape == j.shape == (N_MODEL, NUM_CLASS)
    assert np.isfinite(t).all() and np.abs(t).max() > 1e-3
    assert np.abs(t - j).max() <= 1e-3 * np.abs(j).max()
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def test_cylinder_on_waymo_points_and_logits_match():
    """Cylinder3D cy480_cr10 on Waymo's 5-column input: 10-wide point
    features (IN_FEATURE_DIM 10), the yaml's cylinder space [75, 180, 4]."""
    y = _yaml(CYL)
    cfgs = {"MODALITY": "cylinder", "DATA": dict(y.DATA),
            "MODEL": dict(y.MODEL), "OPTIM": dict(y.OPTIM), "TPU": CAPS}
    (jvb, jout, _, jover), (tvb, tout, _, tover) = _eval_sides(
        cfgs, raycast_waymo.frame_batch(4, N_MODEL))
    assert int(jover) == int(tover) == 0
    assert tvb.point_feats.shape == (N_MODEL, 10)
    np.testing.assert_array_equal(_np(tvb.point_grid),
                                  np.asarray(jvb.point_grid))
    np.testing.assert_array_max_ulp(_np(tvb.point_feats),
                                    np.asarray(jvb.point_feats), maxulp=1)
    for a, b in ((tout[0], jout[0]), (tout[1]["point_refine_logits"],
                                      jout[1]["point_refine_logits"])):
        a, b = _np(a), np.asarray(b)
        assert a.shape == b.shape and a.shape[1] == NUM_CLASS
        assert np.isfinite(a).all() and np.abs(a).max() > 1e-3
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)


def test_rpvnet_on_the_waymo_fusion_view_one_step(trees):
    """RPVNet (the yaml's MODEL block at STEP_PLANES and NUM_LAYER all 1,
    its SGD) on a batch of the Waymo fusion view, 64 x 2656: the port's
    float32 step against JAX's step in float64 (the counterpart of
    tests/test_waymo_fusion.py test_rpvnet_on_waymo_one_step), held as
    tests/test_torch_rpvnet.py holds RPVNet: the loss at rtol 1e-5, every
    gradient at rtol = atol = 1e-4, the whole gradient within 1e-4 of its
    norm."""
    y = _yaml(RPV)
    data = dict(y.DATA, DATA_PATH=trees["mini"], AUGMENT="NoAugment")
    _, loader = tdata.build_dataloader(CfgDict(data), "fusion", 1,
                                       training=True, point_cap=N_MODEL,
                                       num_workers=1)
    batch = {k: v for k, v in next(iter(loader)).items() if k != "name"}
    assert batch["range_image"].shape == (1, 64, 2656, 5)
    optim = dict(y.OPTIM, BATCH_SIZE_PER_GPU=1)
    cfgs = {"MODALITY": "fusion", "DATA": data,
            "MODEL": dict(y.MODEL, NUM_LAYER=[1] * 8, DROPOUT_P=0.0,
                          PLANES=STEP_PLANES),
            "OPTIM": optim, "TPU": CAPS}
    rng = np.random.default_rng(1)
    jtask = JaxSegTask(JaxCfgDict(cfgs), num_class=NUM_CLASS,
                       batch_per_device=1, iters_per_epoch=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    task = SegTask(cfgs, NUM_CLASS, device="cpu", iters_per_epoch=2)
    for m in task.model.modules():     # the range blocks' dropout
        if isinstance(getattr(m, "p", None), float):
            m.p = 0.0
    params, stats = _variables(task, jtask, jb, cfgs, rng)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        no_flax_dropout(mp)
        jt = JaxSegTask(JaxCfgDict(cfgs), num_class=NUM_CLASS,
                        batch_per_device=1, iters_per_epoch=2,
                        compute_dtype=jnp.float64)
        jt.tx = optax.chain(_grad_stash(), jt.tx)
        p, st = (jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), t)
            for t in (params, stats))
        state = TrainState(step=jnp.zeros((), jnp.int32), params=p,
                           batch_stats=st, opt_state=jt.tx.init(p),
                           loss_state=jt.losses.init_state(NUM_CLASS))
        b = {k: jnp.asarray(v.astype(np.float64) if k in (
            "feats", "range_image") else v) for k, v in batch.items()}
        new, jm = jax.device_get(jax.jit(jt.train_step)(
            state, b, jax.random.PRNGKey(1)))
    assert int(jm["voxel_overflow"]) == 0
    m = task.train_step(batch_to_device(batch, "cpu"))
    assert int(m["voxel_overflow"]) == 0
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    coef = min(1.0, optim["GRAD_NORM_CLIP"] / (float(m["grad_norm"]) + 1e-6))
    got = {n: g / coef for n, g in _named(task.model, "grad").items()}

    twin = SegTask(cfgs, NUM_CLASS, device="cpu").model
    jax_params_to_torch(new.opt_state[0], new.batch_stats, twin)
    want = _named(twin)
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-4, atol=1e-4,
                                   err_msg=n)
    w = np.concatenate([want[n].ravel() for n in want]).astype(np.float64)
    g = np.concatenate([got[n].ravel() for n in want]).astype(np.float64)
    assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w)


# -------------------------------------------------------- entry points --

TINY = ["TPU.POINT_CAP_PER_SCAN", str(N_PTS), "TPU.VOXEL_CAP_PER_SCAN",
        str(2 * N_PTS), "TPU.VOXEL_CAP_RATIOS", "[1.0,1.0,1.0,1.0,1.0]",
        "MODEL.NUM_LAYER", "[1,1,1,1,1,1,1,1]", "MODEL.cr", "0.25"]


def test_cli_train_resume_and_stream_a_sequence(trees, tmp_path):
    """cli/train.py on the mk34_cr16 yaml (narrow, CPU) for an epoch and a
    resumed second, then cli/infer.py on the _infer yaml streaming the
    mini tree's unlabeled val/first sequence from the last checkpoint into
    DATA.OUTPUT_DIR: one <count>.npy per frame, one id per valid point."""
    logs, out = tmp_path / "logs", tmp_path / "stream"
    base = ["--extra_tag", "t", "--log_dir", str(logs), "--batch_size", "2",
            "--workers", "1", "--device", "cpu"]
    for epochs in ("1", "2"):
        assert train.main(["--cfg_file", str(ROOT / MINK), *base,
                           "--epochs", epochs, "--log_interval", "1",
                           "--set", "DATA.DATA_PATH", trees["mini"],
                           *TINY]) == 0
    exp = next(logs.glob("**/ckp")).parent
    text = "".join(p.read_text() for p in exp.glob("log_*.txt"))
    assert "resumed from epoch 0" in text
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").open()]
    steps = [r for r in recs if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["voxel_overflow"] == 0
               for r in steps)
    seq = Path(trees["mini"]) / "val"
    assert infer.main(["--cfg_file", str(ROOT / MINK_INFER), *base,
                       "--ckp", str(exp / "ckp" / "1.pt"), "--save_pred",
                       "--set", "DATA.DATA_PATH", str(seq),
                       "DATA.OUTPUT_DIR", str(out), *TINY]) == 0
    files = sorted(out.glob("*.npy"))
    assert [f.name for f in files] == ["000000.npy", "000001.npy"]
    for i, f in enumerate(files):
        ids = np.load(f)
        name = f"seq0_frame{i}.npy"
        n = len(np.load(seq / "first" / name)) + len(
            np.load(seq / "second" / name))
        assert ids.dtype == np.int32 and len(ids) == n
        assert 0 <= ids.min() and ids.max() < NUM_CLASS
