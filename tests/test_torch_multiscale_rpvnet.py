"""RPVNet under ``MODEL.MULTI_SCALE: "none"`` against the JAX package on
the CPU: the set-up and tolerances of tests/multiscale_parity.py."""
import pytest
from multiscale_parity import (check_classifier_reads_z3_alone,
                               check_eval_logits_match,
                               check_train_step_loss_and_head_gradient_match,
                               make_sides)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def sides():
    return make_sides("RPVNet")


def test_classifier_reads_z3_alone(sides):
    check_classifier_reads_z3_alone(sides)


def test_eval_logits_match(sides):
    check_eval_logits_match(sides)


def test_train_step_loss_and_head_gradient_match(sides):
    check_train_step_loss_and_head_gradient_match(sides)
