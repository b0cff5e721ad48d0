"""A JAX run under adam_onecycle (fastai's OneCycle: the lr and Adam's b1
annealed in antiphase, decoupled decay; optax's inject-hyperparams state
around scale_by_adam) with the yaml's CE + Lovász loss carried into the
port and resumed: the set-up and bounds of tests/jax_ckpt_parity.py, the
parameters and moments held to optax's update by the port's gradient
(``port_grad``; with CE alone too JAX's own step moves the moments by up
to 3.7e-4 of a tensor's scale under a one-ulp change of its inputs)."""
from jax_ckpt_parity import check, mink_cfgs, run_case, tmp_dir  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


def test_resumed_adam_onecycle_step_matches_jax(tmp_dir):
    sides = run_case(mink_cfgs("adam_onecycle", LR_PER_SAMPLE=0.002,
                               WEIGHT_DECAY=0.01), tmp_dir, held="port_grad")
    check(sides)
