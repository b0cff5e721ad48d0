"""K8's segmented transpose on the CPU.

The tables the kernel walks (core.geometry.devox_table: the CSR of idx by
voxel and its cut into segments of at most `chunk` contributors) against a
numpy construction, integer for integer; and a plain emulation of the
kernel's summation order (csrc/devox.cu devox_bwd_kernel: per segment, G
lane groups over every G-th contributor joined by a butterfly; a voxel cut
in several segments sums their f32 partials in segment order) against the
plain transpose ``_devox_bwd`` and the gradient of JAX's
``pallas_devoxelize`` in interpret mode, at 1e-5 in float32. The kernel
itself runs only on the card (tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_grads import _flag
from test_torch_kernels import (PALLAS_DEVOX_TOL, devox_tables,
                                small_pallas_config)  # noqa

import openpcseg_tpu.ops.pallas_devox as pd
from openpcseg_torch.core.geometry import (DEVOX_CHUNK, devox_table,
                                           p2v_table)
from openpcseg_torch.ops import cuda_lib, devox
from openpcseg_torch.ops.voxelize import _devox_bwd

F32 = np.float32


def numpy_devox_tables(idx, w, num_voxels, chunk):
    """(t_ptr, t_point, t_weight, seg_ptr, seg_voxel) built in numpy: a
    stable sort of the (corner, point) contributors of idx [K, N] by voxel,
    and each voxel's range cut into max(1, ceil(len / chunk)) segments."""
    n = idx.shape[1]
    flat = idx.reshape(-1).astype(np.int64)
    key = np.where(flat >= 0, flat, num_voxels)
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=num_voxels + 1)[:num_voxels]
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    seg_ptr, seg_voxel = [0], []
    for v in range(num_voxels):
        ns = max(1, -(-int(counts[v]) // chunk))
        seg_voxel += [v] * ns
        seg_ptr.append(seg_ptr[-1] + ns)
    cap = num_voxels + -(-idx.size // chunk)
    assert len(seg_voxel) <= cap
    seg_voxel += [-1] * (cap - len(seg_voxel))
    return (ptr, (order % n).astype(np.int32), w.reshape(-1)[order],
            np.asarray(seg_ptr, np.int32), np.asarray(seg_voxel, np.int32))


NAMES = ("t_ptr", "t_point", "t_weight", "seg_ptr", "seg_voxel")


def check_devox_table(tbl, idx, w):
    """Every transpose and segment field of `tbl` equals the numpy
    construction (the used prefix of t_point / t_weight: the misses after
    t_ptr[V] are in no voxel's range)."""
    want = numpy_devox_tables(idx, w, tbl.num_voxels, tbl.chunk)
    used = int(want[0][-1])
    for name, ref in zip(NAMES, want):
        got = getattr(tbl, name).numpy()
        if name in ("t_point", "t_weight"):
            got, ref = got[:used], ref[:used]
        np.testing.assert_array_equal(got, ref, err_msg=name)
        if name != "t_weight":
            assert getattr(tbl, name).dtype == torch.int32


def k8_emulation(d, tbl, groups):
    """dvox as devox_bwd_kernel sums it, in float32 numpy: segment s of
    voxel v covers contributors [beg, end); lane group g sums those at
    beg + g, beg + g + G, ...; the groups join as a butterfly of
    shuffle-xor steps 16, 8, ... (group g meets g + G / 2 first); one
    segment is the row, several are f32 partials added in segment order
    from zero."""
    ptr, point, weight, seg_ptr, seg_voxel = (getattr(tbl, k).numpy()
                                              for k in NAMES)
    c = d.shape[1]
    out = np.zeros((tbl.num_voxels, c), F32)
    partial = {}
    for s, v in enumerate(seg_voxel):
        if v < 0:
            continue
        beg = ptr[v] + (s - seg_ptr[v]) * tbl.chunk
        end = min(beg + tbl.chunk, ptr[v + 1])
        sums = [np.zeros(c, F32) for _ in range(groups)]
        for q in range(beg, end):
            g = (q - beg) % groups
            sums[g] = sums[g] + weight[q] * d[point[q]]
        while len(sums) > 1:
            half = len(sums) // 2
            sums = [sums[i] + sums[i + half] for i in range(half)]
        if seg_ptr[v + 1] - seg_ptr[v] == 1:
            out[v] = sums[0]
        else:
            partial[s] = sums[0]
    for v in range(tbl.num_voxels):
        if seg_ptr[v + 1] - seg_ptr[v] > 1:
            acc = np.zeros(c, F32)
            for z in range(seg_ptr[v], seg_ptr[v + 1]):
                acc = acc + partial[z]
            out[v] = acc
    return out


def long_voxel_scene(rng, n=300, v=16, c=8):
    """devox_tables with one corner column pinned: corners 0 and 1 of
    every point hit voxels 5 and 6, so each holds hundreds of
    contributors; voxels 14 and 15 are never hit (the padding rows)."""
    vf, idx, w = devox_tables(rng, n, v - 2, c)
    idx[0] = np.where(idx[0] >= 0, 5, -1)
    idx[1] = np.where(idx[1] >= 0, 6, -1)
    w[idx < 0] = 0.0
    vf = np.concatenate([vf, np.zeros((2, c), F32)])
    return vf, idx, w


def p2v_scene(rng, n=300, v=16, c=8):
    """A one-corner table, as core.geometry.p2v_table builds: each point
    in one voxel below v - 2 or none (-1), weight 1 where it hits; voxel 5
    holds about a third of the points, voxels v - 2 and v - 1 none."""
    p2v = rng.integers(0, v - 2, n).astype(np.int32)
    p2v[rng.random(n) < 1 / 3] = 5
    p2v[rng.random(n) < 0.15] = -1
    vf = rng.normal(size=(v, c)).astype(F32)
    vf[v - 2:] = 0.0
    return vf, p2v[None], (p2v >= 0).astype(F32)[None]


def _scene(rng, kind):
    """A scene whose last two voxels are never hit (padding rows)."""
    if kind == "long":
        return long_voxel_scene(rng)
    if kind == "p2v":
        return p2v_scene(rng)
    vf, idx, w = devox_tables(rng, 200, 70, 8)
    return np.concatenate([vf, np.zeros((2, 8), F32)]), idx, w


def _table(idx, w, v, chunk):
    return devox_table(torch.as_tensor(idx), torch.as_tensor(w), v, chunk)


KINDS = ["random", "long"]


@pytest.mark.parametrize("kind", KINDS + ["p2v"])
@pytest.mark.parametrize("chunk", [4, 16, DEVOX_CHUNK])
def test_devox_table_matches_numpy(rng, kind, chunk):
    vf, idx, w = _scene(rng, kind)
    tbl = _table(idx, w, vf.shape[0], chunk)
    check_devox_table(tbl, idx, w)
    nseg = np.diff(tbl.seg_ptr.numpy())
    assert (nseg >= 1).all()
    assert (np.diff(tbl.t_ptr.numpy())[-2:] == 0).all()
    if chunk == 4:
        assert nseg.max() >= 4     # a voxel of more than four chunks


def _emulated(rng, kind, chunk, groups):
    vf, idx, w = _scene(rng, kind)
    d = rng.normal(size=(idx.shape[1], vf.shape[1])).astype(F32)
    tbl = _table(idx, w, vf.shape[0], chunk)
    got = k8_emulation(d, tbl, groups)
    empty = np.diff(tbl.t_ptr.numpy()) == 0
    assert empty[-2:].all() and (got[empty] == 0).all()
    assert np.abs(got).max() > 0.1
    return got, vf, idx, w, d, tbl


@pytest.mark.parametrize("kind", KINDS + ["p2v"])
@pytest.mark.parametrize("chunk", [4, 16, DEVOX_CHUNK])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_k8_summation_order_matches_plain(rng, kind, chunk, groups):
    got, vf, _, _, d, tbl = _emulated(rng, kind, chunk, groups)
    ref = _devox_bwd(torch.as_tensor(d), tbl.idx, tbl.weights, vf.shape[0])
    np.testing.assert_allclose(got, ref.numpy(), **PALLAS_DEVOX_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_k8_summation_order_matches_pallas(rng, kind):
    """Against jax.grad of the JAX Pallas entry, with voxels cut in
    several segments and two lane groups."""
    got, vf, idx, w, d, _ = _emulated(rng, kind, 4, 2)
    jgrad = jax.grad(lambda x_: jnp.sum(pd.pallas_devoxelize(
        x_, jnp.asarray(idx), jnp.asarray(w), compute_dtype=jnp.float32)
        * d))(jnp.asarray(vf))
    np.testing.assert_allclose(got, np.asarray(jgrad), **PALLAS_DEVOX_TOL)


def test_devox_bwd_launch_gets_the_segment_table(rng, monkeypatch):
    """K8 on the card: one launch with the transpose, its segments, a
    float32 partial row per segment, zeroed counters per voxel, and the
    segment count, width and chunk of the table."""
    calls = []
    monkeypatch.setattr(cuda_lib, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(cuda_lib, "launch",
                        lambda name, counter, *a: calls.append((name, a)))
    vf, idx, w = long_voxel_scene(rng)
    tbl = _table(idx, w, vf.shape[0], 16)
    d = torch.zeros(idx.shape[1], 8, dtype=torch.bfloat16)
    devox.devoxelize_bwd(_flag(d), tbl)
    ((name, a),) = calls
    assert name == "opcs_devox_bwd_bf16"
    assert a[1:6] == tuple(getattr(tbl, k).data_ptr() for k in NAMES)
    n_seg = tbl.seg_voxel.shape[0]
    assert n_seg == vf.shape[0] + -(-8 * idx.shape[1] // 16)
    assert a[9:] == (n_seg, 8, 16)


def test_one_corner_table_launches(rng, monkeypatch):
    """The mean-voxelize on the card over a p2v table (idx [1, N]): K8
    gets a segment grid of V + ceil(N / chunk), K7 the corner count 1,
    each counted under its own counter."""
    calls = []
    monkeypatch.setattr(cuda_lib, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(cuda_lib, "launch",
                        lambda name, counter, *a: calls.append(
                            (name, counter, a)))
    vf, idx, _ = p2v_scene(rng)
    tbl = p2v_table(torch.as_tensor(idx[0]), vf.shape[0])
    n = idx.shape[1]
    devox.voxel_sum(_flag(torch.zeros(n, 8)), tbl)
    devox.point_gather(_flag(torch.zeros(vf.shape[0], 8)), tbl)
    (k8, k8_counter, a8), (k7, k7_counter, a7) = calls
    assert (k8, k8_counter) == ("opcs_devox_bwd_f32", "vmean")
    assert a8[9:] == (vf.shape[0] + -(-n // DEVOX_CHUNK), 8, DEVOX_CHUNK)
    assert (k7, k7_counter) == ("opcs_devox_f32", "vmean_bwd")
    assert a7[1:3] == (tbl.idx.data_ptr(), tbl.weights.data_ptr())
    assert a7[4:] == (n, 8, 1)


def test_devox_rejects_a_corner_count_without_a_kernel(rng, monkeypatch):
    """K7 is built for 8 corners (trilinear) and 1 (a p2v table)."""
    monkeypatch.setattr(cuda_lib, "check_cuda", lambda *a, **k: None)
    idx = torch.zeros(2, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\[8, N\] or \[1, N\]"):
        devox.devoxelize(_flag(torch.zeros(4, 8)), idx, torch.ones(2, 16))


def test_devox_bwd_rejects_a_table_that_does_not_fit(rng):
    vf, idx, w = long_voxel_scene(rng)
    tbl = _table(idx, w, vf.shape[0], 16)
    tbl.seg_voxel = tbl.seg_voxel[:-1]
    d = torch.zeros(idx.shape[1], 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="does not fit"):
        devox.devoxelize_bwd(_flag(d), tbl)
