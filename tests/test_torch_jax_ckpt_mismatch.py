"""A JAX checkpoint of another config than the one it is carried or
loaded under: the conversion and ``--ckp`` refuse it and name what
differs; ``--pretrained_ckp`` keeps the tensors that match.

The checkpoint: the narrow MinkUNet of tests/jax_ckpt_parity.py, its
leaves seeded numpy in the shapes of JAX's init_state, saved with orbax.
The other configs: two blocks in the second stage (``NUM_LAYER``, a leaf
the checkpoint lacks) and a last plane of 16 (another width of the last
up stage and of the classifier)."""
import argparse

import jax
import numpy as np
import pytest
import torch
from jax_ckpt_parity import (CAP, SCRIPT, SEED, mini_tree, mink_cfgs,
                             save_jax_checkpoint, scan_batch)
from torch_threads import one_torch_thread  # noqa: F401

from openpcseg_torch.config import CfgDict
from openpcseg_torch.engine.trainer import Trainer
from openpcseg_torch.utils.checkpoint import write_atomic
from openpcseg_torch.utils.convert import jax_state_to_torch

DEEPER = dict(NUM_LAYER=[1, 2, 1, 1, 1, 1, 1, 1])
NARROWER = dict(PLANES=[32, 32, 64, 128, 256, 256, 128, 96, 64])


def _cfgs(tree, **model):
    cfgs = mink_cfgs("sgd")
    cfgs["MODEL"].update(model)
    cfgs["DATA"]["DATA_PATH"] = tree
    return cfgs


def _template(cfgs):
    jt = SCRIPT.jax_task(cfgs, batch_per_device=1, voxel_cap_per_scan=CAP)
    return SCRIPT.template(jt, scan_batch(cfgs))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(tree, the JAX checkpoint dir, its conversion as a .pt)."""
    tmp = tmp_path_factory.mktemp("mismatch")
    tree = mini_tree(tmp / "kitti", 1)
    cfgs = _cfgs(tree)
    tmpl = _template(cfgs)
    rng = np.random.default_rng(SEED)
    state = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape).astype(s.dtype)
                   if np.issubdtype(s.dtype, np.floating)
                   else np.full(s.shape, 2, s.dtype)), tmpl)
    save_jax_checkpoint(tmp / "ckp" / "0", state, 0)
    st, epoch = SCRIPT.read_checkpoint(tmp / "ckp" / "0", tmpl)
    payload = jax_state_to_torch(st, SCRIPT.port_task(cfgs, SEED), epoch,
                                 SEED)
    write_atomic(payload, tmp / "x.pt")
    return tree, tmp / "ckp" / "0", tmp / "x.pt"


@pytest.mark.parametrize("model,named", [
    (DEEPER, r"first state/params/ResidualBlock_\d+/\S+ is not in the "
     "checkpoint"),
    (NARROWER, r"first state/params/\S+ has shape \(\d+,( \d+)?\), "
     r"this config's model \(\d+")],
    ids=["num_layer", "classifier_width"])
def test_conversion_refuses_another_config(saved, model, named):
    tree, ckp, _ = saved
    with pytest.raises(ValueError, match="--ckp .* leaves differ .*" + named):
        SCRIPT.read_checkpoint(ckp, _template(_cfgs(tree, **model)))


def _trainer(tree, tmp_path, model, **args):
    args = argparse.Namespace(
        log_dir=str(tmp_path), extra_tag="t", batch_size=1, workers=1,
        seed=SEED, epochs=2, device="cpu", **args)
    return Trainer(args, CfgDict(_cfgs(tree, **model)))


@pytest.mark.parametrize("model,named", [
    (DEEPER, "down_blocks.1.1.conv1.weight"),
    (NARROWER, "size mismatch for classifier.weight")],
    ids=["num_layer", "classifier_width"])
def test_ckp_refuses_another_config(saved, tmp_path, model, named):
    tree, _, pt = saved
    trainer = _trainer(tree, tmp_path, model, ckp=str(pt))
    with pytest.raises(RuntimeError, match=named):
        trainer.init_or_resume()
    trainer.close()


def test_pretrained_ckp_keeps_the_matching_tensors(saved, tmp_path):
    tree, _, pt = saved
    trainer = _trainer(tree, tmp_path, NARROWER, pretrained_ckp=str(pt))
    fresh = {n: t.clone() for n, t in
             trainer.task.model.state_dict().items()}
    trainer.init_or_resume()
    want = torch.load(pt, weights_only=True)["model"]
    kept, skipped = [], []
    for n, t in trainer.task.model.state_dict().items():
        if want[n].shape == t.shape:
            assert torch.equal(t, want[n]), n
            kept.append(n)
        else:
            assert torch.equal(t, fresh[n]), n
            skipped.append(n)
    # the last up stage and the head take the last plane's width
    last = ("ups.3.", "up_bns.3.", "up_blocks.3.", "classifier.")
    assert len(kept) > 100 and skipped
    assert all(n.startswith(last) for n in skipped)
    assert trainer.task.step == 0 and trainer.start_epoch == 0
    trainer.close()
