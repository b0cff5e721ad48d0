"""The range view of the port against the JAX package's: the copy of
``data/range_view.py`` (projection, packing, paste / union / mix, the
synthetic batch, the TTA votes) held to its original, and the range
loaders byte-identical to JAX's over two epochs, training and eval, the
eval's per-point arrays and ``<pad>`` tail included: with both views on
their default path, the native C++ z-buffer (``native`` cases), and with
both on the numpy one (``numpy_projection``: JAX's native projection off,
the port's view pointed at ``native.range_project_plain``; the numpy
z-buffer differs from the native one on a few pixels a scan). Also: every
shipped range yaml through ``build_dataloader`` and ``SegTask``, the
optimizer and scheduler builders, and what still raises (POST_CRF, the
other optimizers) with the item that ports it."""
import numpy as np
import pytest
import torch
from mini_trees import make_mini_kitti
from torch_threads import one_torch_thread  # noqa: F401

import openpcseg_tpu.data as jdata
import openpcseg_tpu.data.range_view as jrv
from openpcseg_tpu import native as jnative
from openpcseg_tpu.config import CfgDict as JaxCfgDict
from openpcseg_torch import data as tdata
from openpcseg_torch import native as tnative
from openpcseg_torch.config import CfgDict, cfg_from_yaml_file
from openpcseg_torch.data import range_view as trv
from openpcseg_torch.engine.task import SegTask
from openpcseg_torch.optim import build_optimizer

YAMLS = ["tools/cfgs/range/semantic_kitti/{}_64x2048.yaml".format(m)
         for m in ("cenet", "fidnet", "rangenet", "salsanext")]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti") / "sequences"
    make_mini_kitti(root, seqs=("00",), scans_per_seq=5, n_pts=3000, seed=1)
    make_mini_kitti(root, seqs=("08",), scans_per_seq=3, n_pts=3000, seed=2)
    return root


@pytest.fixture
def numpy_projection(monkeypatch):
    monkeypatch.setattr(jnative, "range_project_native",
                        lambda *a, **k: None)
    monkeypatch.setattr(tnative, "range_project",
                        tnative.range_project_plain)


def _yaml(path):
    cfg = CfgDict()
    cfg_from_yaml_file(path, cfg)
    return cfg


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def test_range_view_functions_match(rng):
    assert trv.RANGE_PASTE_CLASSES == jrv.RANGE_PASTE_CLASSES
    assert trv.MIXTEACHER_V2_STRATEGIES == jrv.MIXTEACHER_V2_STRATEGIES
    pts = rng.uniform(-40, 40, (6000, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-3, 1, 6000)
    pts[:50] = pts[50:100]                     # z-buffer ties
    rem = rng.random(6000).astype(np.float32)
    lab = rng.integers(0, 20, 6000).astype(np.int32)
    for h, w, fov in ((64, 512, (3.0, -25.0)), (32, 1024, (10.0, -30.0))):
        got = trv.range_project(pts, rem, lab, h, w, *fov)
        want = jrv.range_project(pts, rem, lab, h, w, *fov)
        _same(got, want)
        _same(dict(enumerate(trv.pack_scan_tensor(got))),
              dict(enumerate(jrv.pack_scan_tensor(want))))
    a = trv.synthetic_range_batch(0, 2, h=16, w=128)
    _same(a, jrv.synthetic_range_batch(0, 2, h=16, w=128))
    s1 = (a["scan"][0], a["label"][0], a["mask"][0])
    s2 = (a["scan"][1], a["label"][1], a["mask"][1])
    for fn in ("range_paste", "range_union"):
        _same(dict(enumerate(getattr(trv, fn)(*s1, *s2))),
              dict(enumerate(getattr(jrv, fn)(*s1, *s2))))
    for seed in range(8):
        _same(dict(enumerate(trv.range_mix(
            *s1, *s2, np.random.default_rng(seed)))),
            dict(enumerate(jrv.range_mix(
                *s1, *s2, np.random.default_rng(seed)))))


@pytest.mark.parametrize("training,projection", [
    pytest.param(True, "numpy", id="True"),
    pytest.param(False, "numpy", id="False"),
    pytest.param(True, "native", id="native-True"),
    pytest.param(False, "native", id="native-False")])
def test_range_loader_yields_jax_batches_over_two_epochs(
        tree, training, projection, request):
    """The shipped CENet yaml's DATA block (every point and range
    augmentation on) at 32 x 256: the same bytes as JAX's over two epochs,
    per-point eval arrays and the <pad> tail included; the TTA votes too.
    Natively, every image of the port's loader goes through
    native.range_project."""
    if projection == "numpy":
        request.getfixturevalue("numpy_projection")
    else:
        assert jnative.get_lib() is not None
    projected = tnative.READS["projection"]
    d = dict(_yaml(YAMLS[0]).DATA, DATA_PATH=str(tree), H=32, W=256)
    kw = dict(training=training, point_cap=4096, num_workers=1, seed=9)
    tset, tload = tdata.build_dataloader(CfgDict(d), "range", 2, **kw)
    jset, jload = jdata.build_dataloader(JaxCfgDict(d), "range", 2, **kw)
    assert type(tset).__name__ == type(jset).__name__ == (
        "SemkittiRangeViewDataset")
    assert len(tload) == len(jload) == 2
    pads = 0
    for _ in range(2):
        got, want = list(tload), list(jload)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g["scan"].shape == (2, 32, 256, 6)
            assert ("p_label" in g) == (not training)
            _same(g, w)
            pads += g["name"].count("<pad>")
        tset.resample()
        jset.resample()
    assert pads == (0 if training else 2)
    projected = tnative.READS["projection"] - projected
    assert (projected >= 2 * len(tset)) == (projection == "native")
    if not training:
        assert not got[-1]["p_valid"][1].any()
        for g, w in zip(tset.get_tta_sample(1, voting=3),
                        jset.get_tta_sample(1, voting=3)):
            _same(g, w)


@pytest.mark.parametrize("path", YAMLS)
def test_shipped_range_yamls_build(tree, path):
    """build_dataloader, SegTask and build_optimizer take each shipped
    range yaml as it stands (AdamW + onecycle); one train step and one
    eval step run on the loader's first batch at 16 x 256 (RangeShift
    draws its roll from [100, W - 100))."""
    cfg = _yaml(path)
    cfg.DATA.DATA_PATH = str(tree)
    cfg.DATA.H, cfg.DATA.W = 16, 256
    if cfg.MODEL.NAME in ("CENet", "FIDNet"):
        cfg.MODEL.LAYERS = [1, 1, 1, 1]
    _, tl = tdata.build_dataloader(cfg.DATA, "range", 2, point_cap=4096,
                                   num_workers=1)
    _, vl = tdata.build_dataloader(cfg.DATA, "range", 2, training=False,
                                   point_cap=4096, num_workers=1)
    task = SegTask(dict(cfg), 20, device="cpu", batch_per_device=2,
                   iters_per_epoch=len(tl), total_epochs=2)
    assert isinstance(task.optimizer, torch.optim.AdamW)
    batch = {k: torch.as_tensor(v) for k, v in next(iter(tl)).items()
             if k != "name"}
    m = task.train_step(batch)
    assert np.isfinite(float(m["loss"])) and int(m["voxel_overflow"]) == 0
    vb = next(iter(vl))
    out = task.eval_step({k: torch.as_tensor(v) for k, v in vb.items()
                          if k != "name"})
    assert int(out["hist"].sum()) == int(vb["p_valid"].sum())


def test_optimizers_and_what_still_raises():
    """Every OPTIMIZER and SCHEDULER of the JAX package builds on the range
    yaml's OPTIM block (their parity: tests/test_torch_optim_zoo.py), and
    MODEL.POST_CRF builds the range task's CRF (tests/test_torch_crf.py);
    a name the JAX package does not know still raises."""
    cfg = _yaml(YAMLS[0])
    params = [("classifier.w", torch.nn.Parameter(torch.zeros(3)))]
    for name, sched in (("adam", "onecycle"), ("sgd_fc", "onecycle"),
                        ("adam_onecycle", "onecycle"),
                        ("adamw", "cos_warmup_with_cosdecay")):
        opt, lr_fn = build_optimizer(dict(cfg.OPTIM, LR=1e-3, OPTIMIZER=name,
                                          SCHEDULER=sched), params, 4, 2)
        assert np.isfinite(lr_fn(3))
    with pytest.raises(NotImplementedError, match="rmsprop"):
        build_optimizer(dict(cfg.OPTIM, LR=1e-3, OPTIMIZER="rmsprop"),
                        params, 4, 2)
    task = SegTask(dict(cfg, MODEL=dict(cfg.MODEL, POST_CRF=True)), 20,
                   device="cpu")
    assert task.crf == dict(iters=3, lcn_h=3, lcn_w=5, xyz_coef=0.1,
                            xyz_sigma=0.7)


def test_range_segtask_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: SegTask runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SegTask(dict(_yaml(YAMLS[0])), 20, device="cuda")


def test_range_modules_import_no_jax_flax_optax_or_the_jax_package():
    import subprocess
    import sys
    from pathlib import Path

    mods = ["openpcseg_torch.data.range_view",
            "openpcseg_torch.models.range_layers",
            "openpcseg_torch.models.range_cenet",
            "openpcseg_torch.models.range_fidnet",
            "openpcseg_torch.models.range_rangenet",
            "openpcseg_torch.models.range_salsanext",
            "openpcseg_torch.losses.range_losses",
            "openpcseg_torch.ops.range_knn", "openpcseg_torch.cli.range_tf32"]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'yaml', 'openpcseg_tpu')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    res = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "clean" in res.stdout
