"""The committed fixture of chip_smoke.py's jax_ckpt phase
(``openpcseg_torch/tools/fixtures/jax_ckpt_mk_narrow.pt`` and
``_expect.npz``, made by tests/jax_ckpt_fixture.py) through the port
alone on the CPU, in float32: the checkpoint restored by
``Trainer.restore`` on a mini SemanticKITTI tree of two train scans at
batch 1 (JAX's two steps an epoch), then

- the step, the epoch and a momentum buffer for every parameter;
- the eval logits on the fixture's scan (chip_smoke.scan_for, the digest
  recorded with the fixture) against JAX's: rtol = atol = 1e-3
  (tests/test_torch_minkunet.py);
- one train step against JAX's third: the lr at rtol 1e-6, the loss at
  rtol 1e-5, the raw gradient and the parameters after it within 1e-4 of
  each tensor's largest value (tests/jax_ckpt_parity.py);
- JAX's bf16 reading in the expectations sets a rule (train_ref_rule) its
  own first draw meets, and both files together stay under 4 MB.

tests/test_torch_jax_ckpt_sgd.py and ..._fixture_eval.py rebuild both
files with JAX and hold the committed copies to them."""
import argparse

import numpy as np
import pytest
import torch
from jax_ckpt_fixture import FIXTURE, fixture_cfgs
from jax_ckpt_parity import mini_tree
from torch_threads import one_torch_thread  # noqa: F401

import chip_smoke
from openpcseg_torch.engine.task import batch_to_device
from openpcseg_torch.engine.trainer import Trainer

def _close(got, want, what):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    assert got.shape == want.shape, what
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    assert err <= 1e-4 * scale, (what, err, scale)


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fixture")
    args = argparse.Namespace(
        log_dir=str(tmp / "logs"), extra_tag="t", batch_size=1, workers=1,
        seed=0, epochs=0, device="cpu", log_interval=1)
    trainer = Trainer(args, fixture_cfgs(mini_tree(tmp / "kitti", 1)))
    trainer.restore(FIXTURE.with_suffix(".pt"))
    want = np.load(str(FIXTURE) + "_expect.npz")
    scan = chip_smoke.scan_for(chip_smoke.CFGS, chip_smoke.SEED,
                               cap=chip_smoke.JAX_CKPT_CAP)
    batch = batch_to_device(scan, "cpu")
    task = trainer.task
    out = dict(want=want, trainer=trainer, scan=scan,
               step=task.step, start_epoch=trainer.start_epoch,
               buffers=[task.optimizer.state[p].get("momentum_buffer")
                        for p in task.model.parameters()],
               logits=task.forward(batch)[2].detach().numpy())
    m = task.train_step(batch)
    coef = min(1.0, 10.0 / (float(m["grad_norm"]) + 1e-6))
    out.update(loss=float(m["loss"]), lr=m["lr"],
               grads={n: p.grad / coef
                      for n, p in task.model.named_parameters()},
               params={n: p.detach().clone()
                       for n, p in task.model.named_parameters()})
    yield out
    trainer.close()


def test_restored_step_epoch_and_buffers(resumed):
    want = resumed["want"]
    assert resumed["step"] == int(want["step"]) == 2
    assert resumed["start_epoch"] == int(want["epoch"]) + 1 == 1
    assert all(b is not None and b.abs().max() > 0
               for b in resumed["buffers"])


def test_the_scan_is_the_fixtures(resumed):
    assert chip_smoke.inputs_digest([resumed["scan"]], torch.nn.Module()) \
        == str(resumed["want"]["scan_digest"])


def test_eval_logits_match_jax(resumed):
    want = resumed["want"]["logits"]
    assert resumed["logits"].shape == want.shape == (8192, 20)
    np.testing.assert_allclose(resumed["logits"], want, rtol=1e-3,
                               atol=1e-3)


def test_train_step_matches_jax_step_3(resumed):
    want = resumed["want"]
    np.testing.assert_allclose(resumed["lr"], float(want["lr3"]), rtol=1e-6)
    np.testing.assert_allclose(resumed["loss"], float(want["loss3"]),
                               rtol=1e-5)
    for n, g in resumed["grads"].items():
        _close(g, want[f"grads3/{n}"], n)
    for n, p in resumed["params"].items():
        _close(p, want[f"params3/{n}"], n)


def test_reading_rule_and_size():
    want = np.load(str(FIXTURE) + "_expect.npz")
    reading = tuple(map(tuple, want["reading"]))
    assert len(reading) == 10
    loss_bound, rows = chip_smoke.train_ref_rule(reading)
    assert reading[0][0] <= loss_bound
    assert all(r[1] >= row[0] and r[2] >= row[1]
               for r, row in zip(reading, rows))
    size = (FIXTURE.with_suffix(".pt").stat().st_size
            + FIXTURE.parent.joinpath(FIXTURE.name + "_expect.npz")
            .stat().st_size)
    assert size < 4 * 2 ** 20
