"""The port's Trainer against the JAX package's on the CPU, on the mini
SemanticKITTI tree and narrow config of tests/test_torch_trainer.py: the
eval from the same weights, the loader lengths and the LR sequence; and the
golden surrogate run's payload and GT-present mIoU against JAX's
protocol."""
import argparse
import json

import jax
import numpy as np
import pytest
from test_torch_trainer import CFG, N_PTS, ROOT, TINY, _argv, tree  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

from openpcseg_tpu.config import CfgDict as JaxCfgDict
from openpcseg_tpu.config import cfg_from_list as jax_cfg_from_list
from openpcseg_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from openpcseg_tpu.engine.trainer import Trainer as JaxTrainer
from openpcseg_tpu.utils.metrics import crop_hist as jax_crop_hist
from openpcseg_tpu.utils.metrics import miou_from_hist as jax_miou
from openpcseg_torch.cli import golden_run, train
from openpcseg_torch.engine.trainer import Trainer
from openpcseg_torch.utils.convert import jax_params_to_torch
from openpcseg_torch.utils.metrics import crop_hist, gt_present_miou


@pytest.fixture(scope="module")
def jax_and_port(tree, tmp_path_factory):
    """The JAX Trainer (one device) and the port's, on the same tree and
    config, the port holding JAX's initial weights."""
    log_dir = tmp_path_factory.mktemp("logs")
    args = argparse.Namespace(
        log_dir=str(log_dir / "jax"), extra_tag="t", batch_size=2, workers=2,
        seed=0, epochs=3, num_devices=1, max_ckp_save_num=2, log_interval=1)
    jcfgs = jax_cfg_from_yaml(ROOT / CFG, JaxCfgDict())
    jax_cfg_from_list(["DATA.DATA_PATH", tree, *TINY], jcfgs)
    jt = JaxTrainer(args, jcfgs)
    batch = next(iter(jt.val_loader))
    db = jt._device_batch(batch)
    jt._compile_steps(db)
    jt.init_or_resume(db)
    targs, tcfgs = train.parse_config(_argv(tree, log_dir / "torch",
                                            "--epochs", "3", "--seed", "0"))
    tt = Trainer(targs, tcfgs)
    state = jax.device_get(jt.state)
    jax_params_to_torch(state.params, state.batch_stats, tt.task.model)
    yield jt, tt
    tt.close()


def test_evaluate_matches_the_jax_trainer(jax_and_port):
    jt, tt = jax_and_port
    want = jt.evaluate()
    got = tt.evaluate()
    assert abs(got - want) <= 0.1, (got, want)
    pstep = jax.jit(jt.task.predict_step)
    agree, n = 0, 0
    for jb, tb in zip(jt.val_loader, tt.val_loader):
        assert jb["name"] == tb["name"]
        jp = np.asarray(pstep(jt.state, jt._device_batch(jb)))
        tp = tt.task.predict_step(tt._device_batch(tb)).numpy()
        valid = tb["valid"]
        agree += int((jp == tp)[valid].sum())
        n += int(valid.sum())
    assert n == 3 * N_PTS
    assert agree >= 0.999 * n, (agree, n)


def test_loader_length_and_lr_sequence_match_the_jax_trainer(jax_and_port):
    jt, tt = jax_and_port
    assert len(tt.train_loader) == len(jt.train_loader) == 2
    assert len(tt.val_loader) == len(jt.val_loader) == 2
    for s in range(len(tt.train_loader) * tt.total_epochs + 2):
        np.testing.assert_allclose(tt.task.lr_fn(s),
                                   float(jt.task.lr_fn(s)), rtol=1e-6,
                                   atol=1e-9)


def test_golden_surrogate_payload(tmp_path):
    out = tmp_path / "g.json"
    assert golden_run.main([
        "--device", "cpu", "--n_train", "2", "--n_val", "1", "--steps", "3",
        "--eval_every", "2", "--loss_every", "1", "--point_cap", "8192",
        "--voxel_cap", "8192", "--cr", "0.25", "--workers", "1",
        "--cache_dir", str(tmp_path / "cache"), "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    jax_keys = json.loads((ROOT / "GOLDEN_r05f_minkunet_s0.json").read_text())
    assert set(jax_keys) <= set(got)
    assert [s for s, _ in got["val_miou_curve"]] == [2, 3]
    assert [s for s, _ in got["loss_curve"]] == [1, 2, 3]
    assert got["device"] == "cpu" and got["schedule"].startswith(
        "linear warmup")
    assert (tmp_path / "cache" / "golden_scans_2_v1_c8192.npz").is_file()


def test_gt_present_miou_is_the_jax_protocols(rng):
    hist = rng.integers(0, 50, (20, 20))
    hist[[3, 7, 12]] = 0                  # classes 2, 6, 11 absent from the GT
    hist[:, 7] = 0                        # ... one of them never predicted
    miou, raw, per = gt_present_miou(hist, 20)
    ul = np.arange(19)
    want_raw, want_per = jax_miou(hist, ul)
    present = jax_crop_hist(hist, ul).sum(1) > 0
    np.testing.assert_array_equal(crop_hist(hist, ul),
                                  jax_crop_hist(hist, ul))
    np.testing.assert_allclose(per, want_per)
    assert raw == pytest.approx(want_raw)
    assert miou == pytest.approx(float(np.nanmean(want_per[present])))
    assert present.sum() == 16 and miou != pytest.approx(raw)
