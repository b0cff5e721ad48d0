"""A JAX run under adam with CE alone carried into the port and resumed:
the set-up and bounds of tests/jax_ckpt_parity.py, every parameter and
Adam moment after step 3 held to JAX's own step."""
from jax_ckpt_parity import CE_ONLY, check, mink_cfgs, run_case, tmp_dir  # noqa: F401,E501
from torch_threads import one_torch_thread  # noqa: F401


def test_resumed_adam_ce_step_matches_jax(tmp_dir):
    check(run_case(mink_cfgs("adam", CE_ONLY, LR_PER_SAMPLE=0.002),
                   tmp_dir))
