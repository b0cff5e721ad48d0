"""A JAX run of a narrow CENet under adamw + onecycle (what the four range
yamls train with) carried into the port and resumed, in float64 on both
sides (tests/range_parity.py says why), at batch 1 (XLA's float64 CENet
step takes ~7 s a scan on the CPU): the set-up and bounds of
tests/jax_ckpt_parity.py."""
from jax_ckpt_parity import check, run_case, tmp_dir  # noqa: F401
from range_parity import range_cfgs
from torch_threads import one_torch_thread  # noqa: F401


def test_resumed_cenet_adamw_step_matches_jax(tmp_dir):
    cfgs = range_cfgs("CENet", LAYERS=[1, 1, 1, 1])
    cfgs["OPTIM"]["BATCH_SIZE_PER_GPU"] = 1
    assert cfgs["OPTIM"]["OPTIMIZER"] == "adamw"
    check(run_case(cfgs, tmp_dir, f64=True))
