"""A JAX run under sgd with Nesterov momentum (the optimizer of 25 of the
29 shipped yamls) carried into the port and resumed, and the committed
fixture of chip_smoke.py's jax_ckpt phase held to JAX, from one JAX run
(tests/jax_ckpt_fixture.py ``fixture_steps``: the entry yaml narrowed by
chip_smoke.JAX_CKPT_SETS, init_state, two float32 steps on the fixture's
8192-point scan, then the third; compiled at XLA's backend optimisation
level 0, ``fast_jit``).

The resume: the two-step state saved with orbax, read and converted by
the script and restored by the port's Trainer (``--ckp``), whose step 3
on the scan is held to JAX's own by the bounds of tests/jax_ckpt_parity.py
(every parameter, BN statistic and momentum buffer within 1e-4 of its
scale); also the payload's layout, which the port's own checkpoints share.

The fixture, so that it cannot go stale: every tensor of the committed
checkpoint (weights, BN statistics, momentum), the raw gradient and the
parameters of the third step within 1e-4 of each tensor's largest value,
the loss at rtol 1e-5 and the lr at rtol 1e-6, the step, epoch, generator
seed, valid mask and scan digest equal. The eval logits and JAX's bf16
reading: tests/test_torch_jax_ckpt_fixture_eval.py."""
import jax
import numpy as np
import pytest
import torch
from jax_ckpt_fixture import FIXTURE, KW, SEED, fixture_cfgs, fixture_steps
from jax_ckpt_parity import (SCRIPT, _as_torch, _close, check, fast_jit,
                             jax_buffers, resume, save_jax_checkpoint)
from torch_threads import one_torch_thread  # noqa: F401

from openpcseg_torch.utils.convert import jax_state_to_torch


@pytest.fixture(scope="module")
def jax_run():
    """(config at batch 1, the scan, the saved state, the expectations of
    step 3, the state after it)."""
    cfgs = fixture_cfgs()
    cfgs.OPTIM.BATCH_SIZE_PER_GPU = 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", fast_jit(jax.jit))
        return (cfgs, *fixture_steps(cfgs))


def test_resumed_sgd_step_matches_jax(jax_run, tmp_path):
    cfgs, scan, saved, expect, third = jax_run
    save_jax_checkpoint(tmp_path / "ckp" / "0", saved, 0)
    tmpl = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(np.shape(x), np.asarray(x).dtype),
        saved)
    t = resume(cfgs, tmp_path, tmpl, scan, epochs=0)
    twin = SCRIPT.port_task(cfgs, SEED, **KW).model
    check(dict(t=t, j=dict(
        loss=float(expect["loss3"]), lr=float(expect["lr3"]),
        step=int(third.step), loss_state=third.loss_state,
        tensors=_as_torch(twin, third.params, third.batch_stats),
        buffers=jax_buffers(third.opt_state, third.batch_stats, twin))))
    payload = t["restored"]["payload"]
    assert sorted(payload) == ["epoch", "generator", "loss_state", "model",
                               "optimizer", "step"]
    assert payload["generator"] == SEED and payload["epoch"] == 0
    assert payload["loss_state"] == {}
    group = payload["optimizer"]["param_groups"][0]
    assert group["nesterov"] and group["momentum"] == 0.9
    assert all(set(s) == {"momentum_buffer"}
               for s in payload["optimizer"]["state"].values())


def test_committed_fixture_is_jaxs(jax_run):
    cfgs, _, saved, expect, _ = jax_run
    pt = jax_state_to_torch(
        {"params": saved.params, "batch_stats": saved.batch_stats,
         "step": int(saved.step), "loss_state": saved.loss_state,
         "opt": SCRIPT.opt_moments(saved.opt_state)},
        SCRIPT.port_task(fixture_cfgs(), SEED), 0, SEED)
    committed = torch.load(FIXTURE.with_suffix(".pt"), weights_only=True)
    for k in ("step", "epoch", "generator", "loss_state"):
        assert committed[k] == pt[k], k
    assert committed["model"].keys() == pt["model"].keys()
    for n, t in pt["model"].items():
        _close(committed["model"][n], t, n)
    got, want = committed["optimizer"], pt["optimizer"]
    assert got["param_groups"] == want["param_groups"]
    for i, s in want["state"].items():
        _close(got["state"][i]["momentum_buffer"], s["momentum_buffer"],
              f"momentum {i}")
    old = np.load(str(FIXTURE) + "_expect.npz")
    for k in ("loss3", "lr3"):
        np.testing.assert_allclose(old[k], expect[k],
                                   rtol=1e-5 if k == "loss3" else 1e-6)
    for k in ("valid", "scan_digest", "step", "epoch"):
        np.testing.assert_array_equal(old[k], expect[k], k)
    for k in ("grads3", "params3"):
        assert {f for f in old.files if f.startswith(k + "/")} == {
            f"{k}/{n}" for n in expect[k]}
        for n, v in expect[k].items():
            _close(old[f"{k}/{n}"], v, f"{k}/{n}")
