"""The eval logits in the expectations of chip_smoke.py's jax_ckpt phase
rebuilt with JAX on the CPU from the committed checkpoint (its weights and
BN statistics laid out for flax through the converter's walk,
``jax_ckpt_parity.to_flax``; tests/jax_ckpt_fixture.py ``fixture_logits``
compiled at XLA's backend optimisation level 0): the
committed logits within 1e-4 of their largest value. JAX's bf16 reading
in the expectations, which takes two more full compiles (at XLA's
default level, as the script takes it), is rebuilt by the ``slow`` test
below, held as tests/test_torch_train_ref.py holds a recorded reading
(the loss difference at rtol 0.01, the cosines within 2e-5):

    JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_jax_ckpt_fixture_eval.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_ckpt_fixture import (FIXTURE, KW, SEED, fixture_cfgs,
                              fixture_logits, fixture_scan, jax_reading)
from jax_ckpt_parity import SCRIPT, _close, fast_jit, to_flax
from torch_threads import one_torch_thread  # noqa: F401

from openpcseg_tpu.engine import TrainState


@pytest.fixture(scope="module")
def committed():
    """(config, scan, the committed checkpoint as a JAX TrainState, the
    committed expectations)."""
    cfgs = fixture_cfgs()
    scan = fixture_scan()
    tmpl = SCRIPT.template(SCRIPT.jax_task(cfgs, **KW), scan)
    payload = torch.load(FIXTURE.with_suffix(".pt"), weights_only=True)
    model = SCRIPT.port_task(cfgs, SEED, **KW).model
    named = list(model.named_parameters()) + list(model.named_buffers())
    params, stats = to_flax(tmpl.params, tmpl.batch_stats, model,
                            {id(t): payload["model"][n] for n, t in named})
    state = TrainState(step=jnp.asarray(payload["step"], jnp.int32),
                       params=params, batch_stats=stats, opt_state=(),
                       loss_state={})
    return cfgs, scan, state, np.load(str(FIXTURE) + "_expect.npz")


def test_committed_logits_are_jaxs(committed, monkeypatch):
    cfgs, scan, state, old = committed
    with monkeypatch.context() as mp:
        mp.setattr(jax, "jit", fast_jit(jax.jit))
        got = fixture_logits(cfgs, state, scan)
    assert got.shape == old["logits"].shape == (8192, 20)
    _close(old["logits"], got, "logits")


@pytest.mark.slow
def test_committed_reading_is_jaxs(committed):
    """Compiled as the script compiles it: at XLA's backend optimisation
    level 0 bf16's conversions fold otherwise (the first draw's loss
    difference read 9.07e-5 against 8.90e-5)."""
    cfgs, scan, state, old = committed
    got = jax_reading(cfgs, state)
    for r, want in zip(got, old["reading"], strict=True):
        assert r[0] == pytest.approx(want[0], rel=0.01)
        assert r[1:] == pytest.approx(want[1:], abs=2e-5)
