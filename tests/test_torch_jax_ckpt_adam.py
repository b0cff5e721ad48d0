"""A JAX run under adam (L2 decay into the gradient, optax's default
betas) with the yaml's CE + Lovász loss carried into the port and
resumed: the set-up and bounds of tests/jax_ckpt_parity.py, the
parameters and moments held to optax's update by the port's gradient
(``held="port_grad"``); optax's one int count becomes each parameter's float
``step``. CE alone, held to JAX's own step: ..._adam_ce.py."""
from jax_ckpt_parity import ITERS, check, mink_cfgs, run_case, tmp_dir  # noqa: F401,E501
from torch_threads import one_torch_thread  # noqa: F401


def test_resumed_adam_step_matches_jax(tmp_dir):
    sides = run_case(mink_cfgs("adam", LR_PER_SAMPLE=0.002), tmp_dir,
                     held="port_grad")
    check(sides)
    state = sides["t"]["restored"]["payload"]["optimizer"]["state"]
    assert {float(s["step"]) for s in state.values()} == {float(ITERS)}
    assert all(set(s) == {"step", "exp_avg", "exp_avg_sq"}
               for s in state.values())
