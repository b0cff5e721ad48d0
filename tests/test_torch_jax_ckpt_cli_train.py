"""A JAX run carried to the port through the CLIs, on the CPU: JAX's
``train.py`` trains one epoch of the narrow MinkUNet of
tests/test_torch_trainer.py on its mini SemanticKITTI tree (two steps at
batch 2, then its eval), ``tools/scripts/jax_ckpt_to_torch.py`` converts
``ckp/0``, and the port's ``cli/train.py --ckp`` resumes from it: it logs
``resumed from epoch 0`` (JAX's first epoch; the JAX and port CLIs count
epochs from 0), trains the second epoch from JAX's step 2 on, with the
LR schedule where JAX's left it, and writes ``ckp/1.pt``. JAX's CLIs
compile their steps at XLA's backend optimisation level 0, as
tests/jax_ckpt_parity.py does, to keep the file near a minute."""
import importlib.util
import json
import sys

import jax
import numpy as np
from jax_ckpt_parity import SCRIPT, fast_jit
from test_torch_trainer import CFG, ROOT, TINY, _argv, _log_text, tree  # noqa: F401,E501
from torch_threads import one_torch_thread  # noqa: F401

from openpcseg_tpu.engine.trainer import Trainer as JaxTrainer
from openpcseg_torch.cli import train


def jax_cli(name):
    """The JAX package's CLI module `name` (train.py or infer.py)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}_cli",
                                                  ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_cli(name, argv, monkeypatch):
    """JAX's CLI `name` with `argv` on one device, compiling into the
    tests' JAX cache at FAST_COMPILE, with its Trainer's evaluate stubbed:
    the validation mIoU it logs is read by neither the checkpoint train.py
    writes before it nor the predictions infer.py dumps after it, and its
    step would be one more compile."""
    monkeypatch.setenv("OPENPCSEG_JAX_CACHE",
                       jax.config.jax_compilation_cache_dir)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    with monkeypatch.context() as mp:
        mp.setattr(jax, "jit", fast_jit(jax.jit))
        mp.setattr(JaxTrainer, "evaluate", lambda self, *a, **k: 0.0)
        jax_cli(name).main()


def jax_argv(tree, log_dir, *extra, sets=()):
    return ["--cfg_file", str(ROOT / CFG), "--extra_tag", "t", "--log_dir",
            str(log_dir), "--batch_size", "2", "--workers", "2", "--seed",
            "0", "--num_devices", "1", *extra, "--set", "DATA.DATA_PATH",
            tree, *TINY, *sets]


def test_jax_train_then_port_train_resumes(tree, tmp_path, monkeypatch):
    jlogs = tmp_path / "jax"
    run_jax_cli("train", jax_argv(tree, jlogs, "--epochs", "1",
                                  "--log_interval", "1"), monkeypatch)
    ckp = next(jlogs.glob("**/ckp/0"))
    out = tmp_path / "from_jax.pt"
    assert SCRIPT.main(["--cfg_file", str(ROOT / CFG), "--ckp", str(ckp),
                        "--out", str(out), "--seed", "0", "--set",
                        "DATA.DATA_PATH", tree, *TINY]) == 0
    logs = tmp_path / "port"
    assert train.main(_argv(tree, logs, "--epochs", "2", "--ckp", str(out),
                            "--log_interval", "1")) == 0
    exp = next(logs.glob("**/ckp")).parent
    assert "resumed from epoch 0" in _log_text(exp)
    assert sorted(p.name for p in (exp / "ckp").iterdir()) == ["1.pt"]
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").open()]
    steps = [r for r in recs if "loss" in r]
    assert [r["step"] for r in steps] == [3, 4]
    assert all(np.isfinite(r["loss"]) for r in steps)
