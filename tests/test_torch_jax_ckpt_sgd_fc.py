"""A JAX run under sgd_fc (the classifier at 10x the lr: a param group of
its own in the port) carried into the port and resumed: the set-up and
bounds of tests/jax_ckpt_parity.py."""
from jax_ckpt_parity import check, mink_cfgs, run_case, tmp_dir  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


def test_resumed_sgd_fc_step_matches_jax(tmp_dir):
    sides = run_case(mink_cfgs("sgd_fc"), tmp_dir)
    check(sides)
    groups = sides["t"]["restored"]["payload"]["optimizer"]["param_groups"]
    assert [g.get("lr_scale", 1.0) for g in groups] == [1.0, 10.0]
    assert len(groups[1]["params"]) == 2       # classifier weight and bias
