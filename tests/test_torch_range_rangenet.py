"""Port parity of RangeNet++ (DarkNet-53 as the yaml has it: the width-only
strided convs, the transposed-conv decoder, the detached skips) against the
JAX package on the CPU, at the sizes of tests/test_range_models.py on two
real projected scans (set-up and the float32 / float64 scheme:
tests/range_parity.py):

- float32 eval logits within 1e-4 of the largest |logit| of JAX's, and
  the per-point histograms of the eval step (pixel argmax, KNN
  re-projection) equal;
- one float32 train step against JAX's float64 reading of it: the loss at
  rtol 1e-5, the BN running statistics at rtol = atol = 1e-5, every raw
  gradient at rtol 1e-4 and an atol of 1e-4, or twice JAX's own float32
  distance from its float64 step on that tensor where that is larger.
  JAX's float32 step lies up to 3.4e-3 (scale 0.24) from its float64 one; the
  port's float32 step up to 8.8e-4, at most 0.81 of that bound on a
  tensor;
- three float64 AdamW + onecycle steps: each loss at rtol 1e-6, each lr,
  the parameters and BN statistics after them at rtol = atol = 1e-6;
- the network from the shipped yaml has JAX's parameter sizes, and SegTask
  takes the yaml as it stands.
"""
import pytest
from range_parity import (check_eval, check_shipped_width, check_three_steps,
                          check_train_step, make_sides, projected_batch)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def sides():
    return make_sides("RangeNet", projected_batch(0))


def test_eval_logits_and_knn_hist_match(sides):
    check_eval(sides)


def test_float32_train_step_matches(sides):
    check_train_step(sides)


def test_three_adamw_onecycle_steps_match(sides):
    check_three_steps(sides)


def test_shipped_yaml_builds_at_full_width():
    check_shipped_width("RangeNet")
