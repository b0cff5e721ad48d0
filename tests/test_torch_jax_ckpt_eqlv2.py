"""A JAX run under CE + EQLv2 (whose positive and negative gradient
buffers carry across steps in TrainState.loss_state) carried into the
port and resumed: the set-up and bounds of tests/jax_ckpt_parity.py, the
parameters held to JAX's own step and the momentum to optax's update by
the port's gradient (``held="jax_params"``), the EQLv2 buffers after step
3 to JAX's own at rtol 1e-5."""
import numpy as np
from jax_ckpt_parity import check, mink_cfgs, run_case, tmp_dir  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


def test_resumed_eqlv2_step_matches_jax(tmp_dir):
    cfgs = mink_cfgs("sgd")
    cfgs["MODEL"]["LOSS_CONFIG"] = {"LOSS_TYPES": ["CELoss", "EQLv2"],
                                    "LOSS_WEIGHTS": [1.0, 1.0]}
    sides = run_case(cfgs, tmp_dir, held="jax_params")
    check(sides)
    carried = sides["t"]["restored"]["payload"]["loss_state"]["eqlv2"]
    assert sorted(carried) == ["neg_grad", "pos_grad"]
    assert all(np.abs(v.numpy()).max() > 0 for v in carried.values())
