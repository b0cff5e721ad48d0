"""The plain reference against the port's plain CPU path, at a tiny size
and in float32: the same voxels, the same kernel-map pairs at every level,
the same logits, and the same first train step."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark.lib import weights
from benchmark.reference import geometry as G, minkunet as R
from benchmark.scangen.raycast import pad_scan, raycast_scan
from benchmark.tests import tiny

CFG = json.loads((tiny.DATA / "configs" / "tiny-kitti.json").read_text())
MODEL = dict(CFG["MODEL"], NUM_LAYER=[1, 2, 1, 1, 1, 1, 1, 1])


def _batch(n=2, cap=8192):
    scans = [pad_scan(*raycast_scan(100 + i, n_beams=16, n_azimuth=512), cap)
             for i in range(n)]
    return {k: np.stack([s[j] for s in scans])
            for j, k in enumerate(("xyz", "feats", "labels", "valid"))}


@pytest.fixture(scope="module")
def setup():
    from openpcseg_torch.engine.task import SegTask, batch_to_device
    from openpcseg_torch.models import build_segmentor

    torch.manual_seed(0)
    batch = _batch()
    one = [torch.as_tensor(batch[k][:1]) for k in
           ("xyz", "feats", "labels", "valid")]
    # BN's running statistics from the first scan, as a serving cell's
    p0 = weights.make(R.param_spec(MODEL, 20), 7, torch.device("cpu"),
                      MODEL, G.build(*one, voxel_size=CFG["DATA"]
                                     ["VOXEL_SIZE"]))
    model = build_segmentor(MODEL, 20, compute_dtype=torch.float32)
    model.load_state_dict(p0)
    cfgs = dict(MODALITY="voxel", DATA=CFG["DATA"], MODEL=MODEL,
                OPTIM=CFG["OPTIM"])
    task = SegTask(cfgs, 20, device="cpu", voxel_cap_per_scan=32768,
                   batch_per_device=2, model=model, iters_per_epoch=100)
    geo = G.build(*(torch.as_tensor(batch[k]) for k in
                    ("xyz", "feats", "labels", "valid")),
                  voxel_size=CFG["DATA"]["VOXEL_SIZE"])
    return task, batch_to_device(batch, "cpu"), geo, p0


def _keys(coords):
    c = coords.long()
    return (((c[:, 0] << 16 | c[:, 1]) << 16 | c[:, 2]) << 16) | c[:, 3]


def test_param_spec_is_the_programs_checkpoint(setup):
    task, _, _, _ = setup
    sd = task.model.state_dict()
    spec = {n: tuple(s) for n, s, _, _ in R.param_spec(MODEL, 20)}
    assert spec == {n: tuple(t.shape) for n, t in sd.items()}


def test_voxels_and_maps_match(setup):
    task, b, geo, _ = setup
    vb, pyr = task.preprocess(b)
    assert pyr.level_counts.tolist() == geo.counts()
    for lvl, ref in zip(pyr.levels, geo.levels):
        coords = lvl.coords[lvl.valid]
        assert torch.equal(torch.sort(_keys(coords)).values, ref.keys)
        km = lvl.subm_kmap
        for k, i, o in ref.subm:
            rows = torch.nonzero(km[k] >= 0)[:, 0]
            port = set(zip(_keys(lvl.coords[rows]).tolist(),
                           _keys(lvl.coords[km[k][rows].long()]).tolist()))
            mine = set(zip(ref.keys[o].tolist(), ref.keys[i].tolist()))
            assert port == mine, (k, len(port), len(mine))


def test_eval_logits_match(setup):
    task, b, geo, p0 = setup
    vb, _, logits = task.forward(b)
    ref = R.eval_logits(p0, geo, MODEL)
    pv, inv = geo.point_voxel, vb.inverse_map.long()
    hit = pv >= 0
    assert torch.equal(hit, inv >= 0)
    diff = (logits[inv[hit]] - ref[pv[hit]]).abs().max()
    assert float(diff) <= 1e-5 * float(ref.abs().max())


def test_one_train_step_matches(setup):
    task, b, geo, p0 = setup
    out = task.train_step(b)
    # float64: the BN scales' and shifts' gradients of the first levels are
    # small residues of large sums, which float32 rounds on either side
    losses, grads, _ = R.train_steps(p0, [geo], MODEL, CFG["OPTIM"], 2, 100,
                                     dtype=torch.float64)
    assert abs(float(out["loss"]) - losses[0]) <= 1e-5 * abs(losses[0])
    for n, p in task.model.named_parameters():
        scale = max(float(grads[n].norm()), 1e-6)
        assert float((p.grad - grads[n]).norm()) <= 1e-3 * scale, n
