"""The arithmetic of the readers, on records built by hand: the tail
percentile over every request, the idle share of an overlapping
timeline, and the FLOP and roofline counts of a hand-built map."""
from __future__ import annotations

import re

import pytest
import torch

from benchmark.lib import readers, trace, work
from benchmark.reference import geometry as G


def test_p95_is_over_all_requests_not_chunk_medians():
    lat = [10.0] * 90 + [100.0] * 10
    # the medians of chunks of ten never see the slow tail
    chunk_medians = [sorted(lat[i:i + 10])[5] for i in range(0, 100, 10)]
    assert max(chunk_medians) == 100.0 and sorted(chunk_medians)[5] == 10.0
    assert readers.percentile(lat, 95.0) == pytest.approx(100.0)
    assert readers.percentile(lat, 50.0) == pytest.approx(10.0)
    assert readers.percentile([], 95.0) is None


def test_idle_share_merges_overlaps():
    kernels = [("a", 0.0, 4e5), ("b", 1e5, 3e5), ("c", 3.5e5, 5e5),
               ("d", 8e5, 9e5)]
    assert trace.merge([(a, b) for _, a, b in kernels]) == [
        (0.0, 5e5), (8e5, 9e5)]
    rec = dict(mode="train", kernels=kernels, t0=0.0, t1=1e6, window_s=1.0,
               plain_s=1.0, scans=4, port_kernel=re.compile(r"\b(c|d)\b"))
    assert readers.device_idle_share(rec, "train") == pytest.approx(40.0)
    assert readers.device_idle_share(rec, "eval") is None
    # the profiler's host cost stretches the traced wall, not the share
    assert readers.device_idle_share(dict(rec, window_s=2.0),
                                     "train") == pytest.approx(40.0)
    # a busy time over the untraced wall reads below 0, not as 0
    assert readers.device_idle_share(dict(rec, plain_s=0.5),
                                     "train") == pytest.approx(-20.0)
    # tail: a and b (4e5 + 2e5 us) over 4 scans
    assert readers.tail_device_ms_per_scan(rec, "train") == pytest.approx(
        150.0)
    assert trace.gaps([(0, 1), (2, 3)], 0, 4) == [(1, 2), (3, 4)]


def _two_voxels():
    """Two level-0 voxels, neighbours along z, in one scan."""
    xyz = torch.tensor([[[0.0, 0.0, 0.0], [0.0, 0.0, 0.05]]])
    feats = torch.zeros(1, 2, 4)
    return G.build(xyz, feats, torch.ones(1, 2, dtype=torch.long),
                   torch.ones(1, 2, dtype=torch.bool), voxel_size=0.05,
                   num_levels=5)


def test_counts_of_a_hand_built_map():
    geo = _two_voxels()
    c = work.geometry_counts(geo)
    # level 0: each voxel hits itself and the other: 4 hits
    assert c["voxels"] == [2, 1, 1, 1, 1] and c["subm_hits"] == [4, 1, 1,
                                                                 1, 1]
    # both corners (0,0,0) of level 4 exist for both points; z-fraction 0
    # or 1/32 puts weight on the (0,0,1) corner, which is missing
    assert c["devox_live"][4] == 2 and c["devox_live"][2] == 2


def test_flops_and_bound_of_one_conv():
    cfg = dict(IN_FEATURE_DIM=4, NUM_LAYER=[1] * 8, cr=1.0,
               PLANES=[32, 32, 64, 128, 256, 256, 128, 96, 96])
    counts = dict(voxels=[1000, 500, 250, 125, 60],
                  subm_hits=[9000, 4000, 2000, 900, 400],
                  devox_live={4: 8000, 2: 8000})
    flops, calls = work.step_work(counts, cfg, 20, train=False)
    first = calls[0]
    assert first[0] == "subm_fwd"
    assert first[2] == 2.0 * 9000 * 4 * 32
    moved = 4.0 * 9000 + 2.0 * 1000 * 4 + 2.0 * 1000 * 32 + 2.0 * 27 * 4 * 32
    assert first[1] == moved
    assert work.bound_s(first) == pytest.approx(max(
        moved / work.HBM_BYTES_PER_S, first[2] / work.BF16_TC_FLOPS))
    tflops, tcalls = work.step_work(counts, cfg, 20, train=True)
    assert tflops == pytest.approx(3 * flops)
    # training adds dfeats (not for the first conv) and dW to every conv,
    # and K8 to every devoxelized level
    convs = sum(1 for k in work.convs(cfg) if k[0] != "1x1")
    assert len(tcalls) == 3 * convs - 1 + 2 * 2
    assert len(calls) == convs + 2


def test_kernel_share_and_mfu():
    rec = dict(mode="serve", kernels=[("gather_gemm_kernel<4>", 0, 2e3),
                                      ("at::native::add", 2e3, 3e3)],
               t0=0.0, t1=3e3, window_s=0.02, plain_s=0.01, scans=1,
               bound_s=1e-3,
               flops=989e9, peak_flops=989e12,
               port_kernel=trace.port_kernel_pattern())
    assert readers.kernel_roofline_share(rec, "serve") == pytest.approx(50.0)
    assert readers.mfu(rec, "serve") == pytest.approx(10.0)
    assert readers.mfu(rec, "eval") is None
