"""JAX checkpoints of the shipped MinkUNet mk34_cr10 yaml at full width
converted into the port with no forward pass: its leaves (every weight,
BN statistic and SGD trace, and the step and epoch) drawn by seeded numpy
into the shapes of JAX's ``init_state`` (traced with ``jax.eval_shape``
at small caps; the widths are the yaml's), saved with orbax as the JAX
``Trainer`` saves them and converted as
``tools/scripts/jax_ckpt_to_torch.py`` converts them. Every tensor of the
port equals its flax leaf under the layout transform bit for bit, read
back through the converter's walk of each value's leaf and index
(``jax_ckpt_parity.to_flax``): with the repeated blocks stacked for
``nn.scan`` (JAX's default) and unrolled (OPENPCSEG_SCAN_BLOCKS=0, the
converter's ``scan_blocks=False``)."""
import numpy as np
import pytest
from jax_ckpt_parity import full_width_case
from torch_threads import one_torch_thread  # noqa: F401

YAML = "tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10.yaml"


@pytest.mark.parametrize("scanned", [True, False],
                         ids=["scanned", "unscanned"])
def test_mk34_cr10_converts_bit_for_bit(scanned, tmp_path, monkeypatch):
    got = full_width_case(YAML, tmp_path, monkeypatch, scanned)
    stacked = [k for k in got["paths"] if k.startswith("StackedBlocks")]
    assert bool(stacked) == scanned
    assert got["parameters"] == got["flax_parameters"] > 37_000_000
    assert np.all(got["exact"]), got["mismatched"]
