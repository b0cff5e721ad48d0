"""The traffic's inputs: every step of a run sends points of its own, the
same seed makes the same steps, the weights' BN statistics come from
data where BN uses them, and the voxel counts that judge an overflow are
the reference's own."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.lib import weights
from benchmark.lib.scans import Feed, transform
from benchmark.reference import geometry as G, minkunet as R
from benchmark.scangen.raycast import pad_scan, raycast_scan
from benchmark.tests import tiny

TRAIN = {"rotate": True, "scale": [0.9, 1.1], "flip": True, "jitter": 0.1}
SEED = 3_000_000_019


def _batches(n=2, b=2, cap=8192):
    scans = [pad_scan(*raycast_scan(200 + i, n_beams=16, n_azimuth=512),
                      cap) for i in range(n * b)]
    return [{k: np.stack([s[j] for s in scans[i:i + b]])
             for j, k in enumerate(("xyz", "feats", "labels", "valid"))}
            for i in range(0, n * b, b)]


def test_every_step_sends_points_of_its_own():
    batches = _batches()
    feed = Feed(batches, TRAIN, SEED)
    try:
        seen = [feed(i) for i in range(6)]
        again = Feed(batches, TRAIN, SEED, ahead=False)
        for i, b in enumerate(seen):
            # pure: the reference remakes step i exactly
            assert np.array_equal(b["xyz"], again.make(i)["xyz"])
            assert np.array_equal(b["feats"][..., :3], b["xyz"])
            assert np.array_equal(b["feats"][..., 3:],
                                  batches[i % 2]["feats"][..., 3:])
            assert not b["xyz"][~b["valid"]].any()
        # step i and step i + 2 share a pool batch, never their points
        for i in range(4):
            assert not np.array_equal(seen[i]["xyz"], seen[i + 2]["xyz"])
        assert not np.array_equal(
            seen[0]["xyz"], Feed(batches, TRAIN, SEED + 1).make(0)["xyz"])
    finally:
        feed.close()
    # without a transform the pool's batches go out as they are
    assert Feed(batches, None, SEED, ahead=False).make(3) is batches[1]


def test_transform_is_the_yamls():
    rng = np.random.default_rng(5)
    for _ in range(50):
        m, t = transform(TRAIN, rng)
        s = np.linalg.svd(m[:2, :2], compute_uv=False)
        # a rotation and flip of x, y, times one scale in [0.9, 1.1]
        assert s[0] == pytest.approx(s[1], rel=1e-5)
        assert 0.9 <= s[0] <= 1.1 and abs(m[2, 2]) == pytest.approx(s[0])
        assert m[:2, 2].tolist() == [0.0, 0.0] and m[2, :2].tolist() == [
            0.0, 0.0]
    m, t = transform({"rotate": True}, rng)
    assert np.linalg.det(m) == pytest.approx(1.0, rel=1e-5)
    assert t.tolist() == [0.0, 0.0, 0.0]


def test_level_counts_are_builds():
    b = Feed(_batches(1), TRAIN, SEED, ahead=False).make(1)
    t = [torch.as_tensor(b[k]) for k in ("xyz", "feats", "labels", "valid")]
    geo = G.build(*t, voxel_size=0.05)
    assert G.level_counts(t[0], t[3], voxel_size=0.05) == geo.counts()


def test_bn_statistics_come_from_data_where_bn_uses_them():
    import json
    cfg = json.loads((tiny.DATA / "configs" / "tiny-kitti.json").read_text())
    batches = _batches(1)
    dev = torch.device("cpu")
    spec = {n: k for n, _, _, k in R.param_spec(cfg["MODEL"], 20)}
    ev = weights.for_cell(cfg, {"mode": "eval"}, SEED, dev, batches)
    tr = weights.for_cell(cfg, {"mode": "train"}, SEED, dev, batches)
    for n, k in spec.items():
        if k == "bn_var":
            assert torch.equal(tr[n], torch.ones_like(tr[n]))
            assert not torch.allclose(ev[n], torch.ones_like(ev[n]))
        elif k in ("bn_w", "bn_b"):
            assert torch.equal(tr[n], ev[n])
            assert float(tr[n].std()) > 0.05
    # the statistics are those of the first scan's activations: BN in
    # evaluation then gives each channel of the first BN mean 0, std 1
    one = [torch.as_tensor(batches[0][k][:1]) for k in
           ("xyz", "feats", "labels", "valid")]
    geo = G.build(*one, voxel_size=0.05)
    stats = {}
    R.Net(cfg["MODEL"], tr, train=True, stats=stats)(geo)
    mean, var = stats["stem.0.bn"]
    assert torch.allclose(ev["stem.0.bn.running_mean"], mean)
    assert torch.allclose(ev["stem.0.bn.running_var"], var)
