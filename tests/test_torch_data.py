"""The port's copies of the JAX package's numpy host modules, held to
their originals: SemanticKITTI metadata, augmentation, the scan reader,
the synthetic scans, the voxel, fusion and cylinder views and their
BatchLoader (byte-identical batches over two epochs, training and eval with
<pad> tails; the fusion view's range image and pxpy), the
ray-cast tree writer (the same bytes as tools/scripts/make_raycast_kitti.py),
and the logging, TensorBoard and report utilities."""
import logging
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
from mini_trees import make_mini_kitti
from torch_threads import one_torch_thread  # noqa: F401

import openpcseg_tpu.data as jdata
from openpcseg_tpu.config import CfgDict as JaxCfgDict
from openpcseg_tpu.data import augment as jaugment
from openpcseg_tpu.data import semantickitti_meta as jmeta
from openpcseg_tpu.data import synthetic as jsynthetic
from openpcseg_tpu.utils import logger as jlogger
from openpcseg_tpu.utils import reporting as jreporting
from openpcseg_tpu.utils import tb_writer as jtb
from openpcseg_torch import data as tdata
from openpcseg_torch.config import CfgDict
from openpcseg_torch.data import augment as taugment
from openpcseg_torch.data import raycast_kitti
from openpcseg_torch.data import semantickitti_meta as tmeta
from openpcseg_torch.data import synthetic as tsynthetic
from openpcseg_torch.utils import logger as tlogger
from openpcseg_torch.utils import reporting as treporting
from openpcseg_torch.utils import tb_writer as ttb

ROOT = Path(__file__).resolve().parents[1]


def _data_cfgs(path, **kw):
    d = {"DATASET": "semantickitti", "DATA_PATH": str(path),
         "VOXEL_SIZE": 0.05, "AUGMENT": "GlobalAugment_LP"}
    d.update(kw)
    return CfgDict(d), JaxCfgDict(d)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti") / "sequences"
    make_mini_kitti(root, seqs=("00",), scans_per_seq=5, n_pts=3000, seed=1)
    make_mini_kitti(root, seqs=("08",), scans_per_seq=3, n_pts=3000, seed=2)
    return root


def test_metadata_tables_match():
    for name in ("CLASS_NAMES", "NUM_CLASS", "IGNORE_LABEL", "CLASS_CONTENT",
                 "CLS_NUM_PTS", "LEARNING_MAP", "LEARNING_MAP_INV",
                 "SPLIT_SEQUENCES", "COLOR_MAP"):
        assert getattr(tmeta, name) == getattr(jmeta, name), name
    for name in ("LEARNING_MAP_LUT", "LEARNING_MAP_INV_LUT"):
        np.testing.assert_array_equal(getattr(tmeta, name),
                                      getattr(jmeta, name))
    raw = np.random.default_rng(0).integers(0, 2 ** 32, 1000, dtype=np.uint32)
    np.testing.assert_array_equal(tmeta.remap_labels(raw),
                                  jmeta.remap_labels(raw))
    assert tdata.dataset_meta("semantickitti") == jdata.dataset_meta(
        "semantickitti")
    for ds in ("semantickitti", "scribblekitti", "waymo", "nuscenes"):
        assert tdata.num_classes_for(ds) == jdata.num_classes_for(ds)


def _pts(rng, n):
    x = rng.normal(0, 15, (n, 4)).astype(np.float32)
    x[:, 2] = rng.uniform(-3, 2, n)
    return x


def test_augmentations_match():
    rng = np.random.default_rng(0)
    a, b = _pts(rng, 2000), _pts(rng, 1500)
    la = rng.integers(0, 20, 2000).astype(np.int32)
    lb = rng.integers(0, 20, 1500).astype(np.int32)
    kw = dict(if_flip=True, if_scale=True, scale_axis="xy", if_jitter=True,
              if_rotate=True)
    for tta, vote in ((False, 0), (True, 3)):
        got = taugment.aug_points(a[:, :3], if_tta=tta, num_vote=vote,
                                  rng=np.random.default_rng(5), **kw)
        want = jaugment.aug_points(a[:, :3], if_tta=tta, num_vote=vote,
                                   rng=np.random.default_rng(5), **kw)
        np.testing.assert_array_equal(got, want)
    for seed in range(4):
        for fn in ("lasermix", "polarmix"):
            kw = ({} if fn == "lasermix" else dict(
                alpha=-1.0, beta=2.0, instance_classes=[1, 2, 3],
                omega=[0.5, 2.5]))
            got = getattr(taugment, fn)(a, la, b, lb,
                                        rng=np.random.default_rng(seed), **kw)
            want = getattr(jaugment, fn)(a, la, b, lb,
                                         rng=np.random.default_rng(seed),
                                         **kw)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_synthetic_scans_match():
    got = tsynthetic.synthetic_batch(3, 2, n_points=4000, cap=4096)
    want = jsynthetic.synthetic_batch(3, 2, n_points=4000, cap=4096)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def _same_batch(got, want):
    assert got.keys() == want.keys()
    for k in got:
        if k == "name":
            assert got[k] == want[k]
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("training", [True, False])
def test_batch_loader_yields_jax_batches_over_two_epochs(tree, training):
    tcfg, jcfg = _data_cfgs(tree)
    kw = dict(training=training, point_cap=4096, num_workers=2, seed=7)
    tset, tload = tdata.build_dataloader(tcfg, "voxel", 2, **kw)
    jset, jload = jdata.build_dataloader(jcfg, "voxel", 2, **kw)
    assert len(tload) == len(jload) == (2 if training else 2)
    pads = 0
    for _ in range(2):
        got, want = list(tload), list(jload)
        assert len(got) == len(want) == len(tload)
        for g, w in zip(got, want):
            _same_batch(g, w)
            pads += g["name"].count("<pad>")
        tset.resample()
        jset.resample()
    # eval: 3 val scans in batches of 2 -> one all-invalid <pad> sample
    assert pads == (0 if training else 2)
    if not training:
        last = got[-1]
        assert not last["valid"][1].any() and (last["labels"][1] == -1).all()
        votes_t = tset.get_tta_sample(1, voting=3)
        votes_j = jset.get_tta_sample(1, voting=3)
        for g, w in zip(votes_t, votes_j):
            _same_batch(g, w)


@pytest.mark.parametrize("training", [True, False])
def test_fusion_loader_yields_jax_batches_over_two_epochs(tree, training):
    """The fusion view (the copy in openpcseg_torch/data/fusion_view.py):
    the same bytes as JAX's SemkittiFusionDataset, the range image and
    pxpy included, over two epochs."""
    tcfg, jcfg = _data_cfgs(tree)
    kw = dict(training=training, point_cap=4096, num_workers=2, seed=3)
    tset, tload = tdata.build_dataloader(tcfg, "fusion", 2, **kw)
    jset, jload = jdata.build_dataloader(jcfg, "fusion", 2, **kw)
    assert type(tset).__name__ == type(jset).__name__ == (
        "SemkittiFusionDataset")
    assert len(tload) == len(jload) == 2
    for _ in range(2):
        got, want = list(tload), list(jload)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g["range_image"].shape == (2, 64, 2048, 5)
            assert g["pxpy"].shape == (2, 4096, 2)
            assert g["feats"].shape[-1] == 5
            _same_batch(g, w)
        tset.resample()
        jset.resample()


@pytest.mark.parametrize("training", [True, False])
def test_cylinder_loader_yields_jax_batches_over_two_epochs(tree, training):
    """The cylinder view (the voxel view: Cylinder3D partitions the points
    on the device) under the Cylinder3D yaml's DATA keys: the same bytes as
    JAX's over two epochs."""
    d = {"DATASET": "semantickitti", "DATA_PATH": str(tree),
         "CYLINDER_GRID_SIZE": [480, 360, 32],
         "CYLINDER_SPACE_MAX": [50, 180, 2],
         "CYLINDER_SPACE_MIN": [0, -180, -4], "AUGMENT": "GlobalAugment_LP",
         "SCALE_AUG_RANGE": [0.95, 1.05]}
    kw = dict(training=training, point_cap=4096, num_workers=2, seed=5)
    tset, tload = tdata.build_dataloader(CfgDict(d), "cylinder", 2, **kw)
    jset, jload = jdata.build_dataloader(JaxCfgDict(d), "cylinder", 2, **kw)
    assert type(tset).__name__ == type(jset).__name__ == (
        "SemkittiVoxelDataset")
    assert len(tload) == len(jload) == 2
    for _ in range(2):
        got, want = list(tload), list(jload)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _same_batch(g, w)
        tset.resample()
        jset.resample()


def test_loader_rank_and_unported_views(tree, tmp_path):
    """The rank and world of a loader, and the Waymo and nuScenes views
    that once raised: each builds over a mini tree of its dataset, is
    JAX's view class with JAX's class names, and dataset_meta names the
    dataset's class table (their batches: tests/test_torch_waymo.py,
    tests/test_torch_nuscenes.py)."""
    from mini_trees import make_mini_waymo
    from test_nuscenes import make_mini_nuscenes

    tcfg, _ = _data_cfgs(tree)
    assert tdata.rank_and_world() == (0, 1)
    _, load = tdata.build_dataloader(tcfg, "voxel", 2, num_workers=1)
    assert (load.process_index, load.local_bs) == (0, 2)
    roots = {"waymo": make_mini_waymo(tmp_path / "waymo", n_frames=2,
                                      n_pts=500),
             "nuscenes": make_mini_nuscenes(str(tmp_path / "nusc"),
                                            n_pts=500)}
    for modality, ds in (("range", "nuscenes"), ("cylinder", "waymo"),
                         ("fusion", "waymo"), ("voxel", "waymo")):
        d = {"DATASET": ds, "DATA_PATH": roots[ds], "VOXEL_SIZE": 0.1}
        tset, tload = tdata.build_dataloader(CfgDict(d), modality, 2,
                                             num_workers=1)
        jset, _ = jdata.build_dataloader(JaxCfgDict(d), modality, 2,
                                         num_workers=1)
        assert type(tset).__name__ == type(jset).__name__
        assert tset.class_names == jset.class_names
        assert len(tload) >= 1
        names, _ = tdata.dataset_meta(ds)
        assert names == jdata.dataset_meta(ds)[0]
        assert len(names) == tdata.num_classes_for(ds)
        if modality != "range":   # JAX's nuScenes range view keeps
            assert tset.class_names == names   # SemanticKITTI's names


def test_raycast_tree_has_the_scripts_bytes(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, str(ROOT / "tools/scripts/"
                                        "make_raycast_kitti.py"),
                    str(tmp_path / "jax"), "2", "1"], check=True, env=env,
                   capture_output=True, timeout=600)
    out = raycast_kitti.write_tree(tmp_path / "torch", 2, 1)
    assert out == str(tmp_path / "torch" / "sequences")
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert len(files) == 6
    assert files == sorted(p.relative_to(tmp_path / "torch") for p in
                           (tmp_path / "torch").rglob("*") if p.is_file())
    for f in files:
        assert (tmp_path / "torch" / f).read_bytes() == (
            tmp_path / "jax" / f).read_bytes(), f


def test_reports_match():
    rng = np.random.default_rng(0)
    hist = rng.integers(0, 1000, (6, 6))
    names = ["car", "road", "pole", "a", "b", "c"]
    iou = rng.random(6) * 100
    assert treporting.iou_table(61.5, iou, names) == jreporting.iou_table(
        61.5, iou, names)
    assert treporting.confusion_table(hist, names) == \
        jreporting.confusion_table(hist, names)


def test_tb_writer_writes_the_same_bytes(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    for mod, d in ((ttb, "t"), (jtb, "j")):
        w = mod.TBWriter(tmp_path / d)
        w.add_scalar("val_miou", 61.25, 3)
        w.add_scalars({"train/loss": 1.5, "train/lr": 0.02}, 7)
        w.close()
    (t,), (j,) = (list((tmp_path / d).iterdir()) for d in "tj")
    assert t.name == j.name and t.read_bytes() == j.read_bytes()


def test_metrics_meters_and_log_format(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.5)
    for mod, d in ((tlogger, "t"), (jlogger, "j")):
        w = mod.MetricsWriter(tmp_path / d / "metrics.jsonl")
        w.write(3, loss=np.float32(1.25), lr=0.02)
        w.write(4, val_miou=61.0)
        w.close()
    assert (tmp_path / "t/metrics.jsonl").read_text() == (
        tmp_path / "j/metrics.jsonl").read_text()
    mt, mj = tlogger.AverageMeter(), jlogger.AverageMeter()
    for v, n in ((1.0, 2), (4.0, 1)):
        mt.update(v, n)
        mj.update(v, n)
    assert (mt.avg, mt.val, mt.count) == (mj.avg, mj.val, mj.count)

    # the same record format; a second logger call moves the file output
    log = tlogger.create_logger(tmp_path / "a.txt")
    log.info("first")
    log = tlogger.create_logger(tmp_path / "b.txt")
    log.info("second")
    fmt = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    assert all(h.formatter._fmt == fmt._fmt for h in log.handlers)
    assert "first" in (tmp_path / "a.txt").read_text()
    assert (tmp_path / "b.txt").read_text().endswith(" INFO  second\n")
    jl = jlogger.create_logger(None)
    assert all(h.formatter._fmt == fmt._fmt for h in jl.handlers)
    for h in list(log.handlers):
        if isinstance(h, logging.FileHandler):
            log.removeHandler(h)
            h.close()
