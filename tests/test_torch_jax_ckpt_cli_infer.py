"""A JAX checkpoint served by the port's CLI, on the CPU: the JAX
``Trainer`` of the narrow MinkUNet of tests/test_torch_trainer.py on its
mini SemanticKITTI tree saves ``ckp/0`` (its initial state, every BN leaf
perturbed from a seeded numpy generator so the statistics carry real
values), ``tools/scripts/jax_ckpt_to_torch.py`` converts it, and the
port's ``cli/infer.py --ckp <converted> --save_pred`` and JAX's
``infer.py --ckp ckp/0 --save_pred`` (its eval stubbed,
tests/test_torch_jax_ckpt_cli_train.py ``run_jax_cli``) dump each val
scan's predictions in float32: at least 99.9% of the points agree
(tests/test_torch_minkunet.py: only a near-tie in the argmax may go the
other way)."""
import argparse

import jax
import numpy as np
from jax_ckpt_parity import SCRIPT
from test_torch_jax_ckpt_cli_train import jax_argv, run_jax_cli
from test_torch_minkunet import _perturb
from test_torch_trainer import CFG, N_PTS, ROOT, TINY, _argv, _log_text, tree  # noqa: F401,E501
from torch_threads import one_torch_thread  # noqa: F401

from openpcseg_tpu.config import CfgDict as JaxCfgDict
from openpcseg_tpu.config import cfg_from_list as jax_cfg_from_list
from openpcseg_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from openpcseg_tpu.engine.trainer import Trainer as JaxTrainer
from openpcseg_torch.cli import infer


def test_port_infer_serves_a_jax_checkpoint(tree, tmp_path, monkeypatch):
    jlogs = tmp_path / "jax"
    args = argparse.Namespace(
        log_dir=str(jlogs), extra_tag="t", batch_size=2, workers=2, seed=0,
        epochs=1, num_devices=1, max_ckp_save_num=2, log_interval=1)
    jcfgs = jax_cfg_from_yaml(ROOT / CFG, JaxCfgDict())
    jax_cfg_from_list(["DATA.DATA_PATH", tree, *TINY], jcfgs)
    jt = JaxTrainer(args, jcfgs)
    db = jt._device_batch(next(iter(jt.val_loader)))
    jt._compile_steps(db)
    jt.init_or_resume(db)
    rng = np.random.default_rng(0)
    state = jax.device_get(jt.state)
    jt.state = state.replace(params=_perturb(state.params, rng),
                             batch_stats=_perturb(state.batch_stats, rng))
    jt.save_checkpoint(0)
    ckp = next(jlogs.glob("**/ckp/0"))

    out = tmp_path / "from_jax.pt"
    assert SCRIPT.main(["--cfg_file", str(ROOT / CFG), "--ckp", str(ckp),
                        "--out", str(out), "--set", "DATA.DATA_PATH", tree,
                        *TINY]) == 0
    jpred, tpred = tmp_path / "jax_pred", tmp_path / "port_pred"
    run_jax_cli("infer", jax_argv(tree, jlogs, "--ckp", str(ckp),
                                  "--save_pred", sets=[
                                      "DATA.OUTPUT_DIR", str(jpred)]),
                monkeypatch)
    logs = tmp_path / "port"
    assert infer.main(_argv(tree, logs, "--ckp", str(out), "--save_pred",
                            sets=["DATA.OUTPUT_DIR", str(tpred)])) == 0
    exp = next(logs.glob("**/ckp")).parent
    assert "resumed from epoch 0" in _log_text(exp)
    files = sorted(p.name for p in tpred.glob("*.npy"))
    assert files == sorted(p.name for p in jpred.glob("*.npy"))
    assert files == [f"08_{i:06d}.npy" for i in range(3)]
    agree = sum(int((np.load(jpred / f) == np.load(tpred / f)).sum())
                for f in files)
    assert agree >= 0.999 * 3 * N_PTS, agree
