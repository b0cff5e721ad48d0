"""A JAX checkpoint of the shipped RPVNet mk34_cr17_5 yaml at full width
(123.0M parameters: the voxel branch, the range branch's HWIO convs and
the point MLPs) converted into the port with no forward pass, every
tensor equal to its flax leaf bit for bit: tests/test_torch_jax_ckpt_
full_mk.py says how."""
import numpy as np
from jax_ckpt_parity import full_width_case
from torch_threads import one_torch_thread  # noqa: F401

YAML = "tools/cfgs/fusion/semantic_kitti/rpvnet_mk34_cr17_5.yaml"


def test_rpvnet_mk34_cr17_5_converts_bit_for_bit(tmp_path, monkeypatch):
    got = full_width_case(YAML, tmp_path, monkeypatch, True)
    assert got["parameters"] == got["flax_parameters"]
    assert 122_900_000 < got["parameters"] < 123_100_000
    assert any(k.startswith("RPVResContext") for k in got["paths"])
    assert np.all(got["exact"]), got["mismatched"]
