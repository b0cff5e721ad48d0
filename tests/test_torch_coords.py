"""Port parity, part (a): keys, dedup, kernel maps, the pyramid and the
voxelizer of openpcseg_torch against openpcseg_tpu on the same numpy inputs.

Integer tables (sorted rows, inverse maps, kernel maps, up/down maps,
corner tables, devoxelize idx) must be equal integer for integer; float
outputs (devoxelize weights, voxel features) agree to 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpcseg_tpu.core.batch import voxelize_points_batch as jx_voxelize
from openpcseg_tpu.core.geometry import _corner_table as jx_corner_table
from openpcseg_tpu.core.geometry import build_pyramid as jx_build_pyramid
from openpcseg_tpu.data.raycast import raycast_batch as jx_raycast_batch
from openpcseg_tpu.engine.task import default_caps as jx_default_caps
from openpcseg_tpu.ops import coords as jxc
from openpcseg_tpu.ops import kmap as jxk
from openpcseg_tpu.ops import segment as jxseg
from openpcseg_torch.core.batch import voxelize_points_batch
from openpcseg_torch.core.geometry import _corner_table, build_pyramid
from openpcseg_torch.data.raycast import raycast_batch
from openpcseg_torch.engine.task import default_caps
from openpcseg_torch.ops import coords as tc
from openpcseg_torch.ops import kmap as tk
from openpcseg_torch.ops import segment as tseg

RATIOS = [1.0, 1.0, 0.6, 0.3, 0.15]   # no level overflows on the 8192 scan
CAP0 = 8192


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x))


def _eq(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


def _random_coords(rng, n=400, span=9, n_batch=3, cap=512):
    """Coords with duplicates, invalid rows and out-of-range rows."""
    c = np.concatenate([rng.integers(0, n_batch, (n, 1)),
                        rng.integers(-1, span, (n, 3))], axis=1)
    c = c.astype(np.int32)
    valid = rng.random(n) > 0.1
    return c, valid, cap


def test_make_keys_and_unique_coords(rng):
    c, v, cap = _random_coords(rng)
    jk = jxc.make_keys(jnp.asarray(c), jnp.asarray(v))
    tk_ = tc.make_keys(torch.as_tensor(c), torch.as_tensor(v))
    _eq(tk_.hi, jk.hi)
    _eq(tk_.lo, jk.lo)
    for cap_ in (cap, 64):   # 64 < #unique: the capacity drop path
        ju = jxc.unique_coords(jnp.asarray(c), jnp.asarray(v), cap_)
        tu = tc.unique_coords(torch.as_tensor(c), torch.as_tensor(v), cap_)
        for name in ("coords", "valid", "inverse", "num_unique"):
            _eq(getattr(tu, name), getattr(ju, name))
        _eq(tu.keys.hi, ju.keys.hi)
        _eq(tu.keys.lo, ju.keys.lo)


def test_lookups_match(rng):
    c, v, cap = _random_coords(rng)
    ju = jxc.unique_coords(jnp.asarray(c), jnp.asarray(v), cap)
    tu = tc.unique_coords(torch.as_tensor(c), torch.as_tensor(v), cap)
    q, qv, _ = _random_coords(rng, n=300)
    _eq(tc.lookup_coords(tu.keys, torch.as_tensor(q), torch.as_tensor(qv)),
        jxc.lookup_coords(ju.keys, jnp.asarray(q), jnp.asarray(qv)))
    qk_j = jxc.make_keys(jnp.asarray(q), jnp.asarray(qv))
    qk_t = tc.make_keys(torch.as_tensor(q), torch.as_tensor(qv))
    _eq(tc.lookup_keys_z3(tu.keys, qk_t), jxc.lookup_keys_z3(ju.keys, qk_j))


def test_subm_kmap_and_downsample(rng):
    c, v, cap = _random_coords(rng, n=600, span=12)
    ju = jxc.unique_coords(jnp.asarray(c), jnp.asarray(v), cap)
    tu = tc.unique_coords(torch.as_tensor(c), torch.as_tensor(v), cap)
    np.testing.assert_array_equal(tk.kernel_offsets(3), jxk.kernel_offsets(3))
    np.testing.assert_array_equal(tk.kernel_offsets(2), jxk.kernel_offsets(2))
    _eq(tk.build_subm_kmap(tu.keys, tu.coords, tu.valid, 3),
        jax.jit(jxk.build_subm_kmap, static_argnums=3)(
            ju.keys, ju.coords, ju.valid, 3))
    zm_t, zp_t = tk._self_z_neighbors(tu.keys, tu.valid)
    zm_j, zp_j = jxk._self_z_neighbors(ju.keys, ju.valid)
    _eq(zm_t, zm_j)
    _eq(zp_t, zp_j)
    jd = jxk.build_downsample(ju.coords, ju.valid, 256)
    td = tk.build_downsample(tu.coords, tu.valid, 256)
    for name in ("coords", "valid", "inverse", "num_unique"):
        _eq(getattr(td, name), getattr(jd, name))


def test_segment_ops(rng):
    ids = rng.integers(-1, 12, 300).astype(np.int32)
    data = rng.normal(size=(300, 3)).astype(np.float32)
    _eq(tseg.segment_min_index(torch.as_tensor(ids), 10),
        jxseg.segment_min_index(jnp.asarray(ids), 10))
    np.testing.assert_allclose(
        _np(tseg.segment_sum(torch.as_tensor(data), torch.as_tensor(ids), 10)),
        _np(jxseg.segment_sum(jnp.asarray(data), jnp.asarray(ids), 10)),
        rtol=1e-6, atol=1e-6)


def test_raycast_scan_is_the_jax_packages():
    a = raycast_batch(3, 1, cap=4096)
    b = jx_raycast_batch(3, 1, cap=4096)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.fixture(scope="module")
def scan_pyramids():
    """The 8192-point ray-cast scan through both voxelizers and pyramids."""
    batch = raycast_batch(0, 1, cap=CAP0)
    caps = default_caps(CAP0, 5, RATIOS)
    assert caps == jx_default_caps(CAP0, 5, RATIOS)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}

    @jax.jit   # one compile (~2 s) instead of ~30 s of eager dispatch
    def jax_side(b):
        jvb = jx_voxelize(b["xyz"], b["feats"], b["labels"], b["valid"],
                          voxel_size=0.05, voxel_cap=caps[0])
        return jvb, jx_build_pyramid(
            jvb.voxel_coords, jvb.voxel_valid, caps, subm_kernel=3,
            updown_kernel=2, devox_levels=(4, 2, 0),
            level0_keys=jxc.Keys(jvb.voxel_keys_hi, jvb.voxel_keys_lo))

    jvb, jpyr = jax_side({k: jnp.asarray(v) for k, v in batch.items()})
    tvb = voxelize_points_batch(tb["xyz"], tb["feats"], tb["labels"],
                                tb["valid"], voxel_size=0.05,
                                voxel_cap=caps[0])
    tpyr = build_pyramid(
        tvb.voxel_coords, tvb.voxel_valid, caps,
        level0_keys=tc.Keys(tvb.voxel_keys_hi, tvb.voxel_keys_lo),
        devox_levels=(4, 2, 0))
    return caps, jvb, tvb, jpyr, tpyr


def test_voxelize_points_batch(scan_pyramids):
    caps, jvb, tvb, _, _ = scan_pyramids
    for name in ("voxel_coords", "voxel_valid", "voxel_keys_hi",
                 "voxel_keys_lo", "voxel_labels", "inverse_map",
                 "point_labels", "point_valid", "point_batch", "num_voxels",
                 "voxel_rep"):
        _eq(getattr(tvb, name), getattr(jvb, name))
    np.testing.assert_allclose(_np(tvb.voxel_feats), _np(jvb.voxel_feats),
                               rtol=1e-6, atol=1e-6)
    assert int(tvb.num_voxels) <= caps[0]


def test_pyramid_levels_and_maps(scan_pyramids):
    caps, _, _, jpyr, tpyr = scan_pyramids
    counts = _np(tpyr.level_counts)
    _eq(counts, jpyr.level_counts)
    assert (counts <= np.asarray(caps)).all(), "a level overflowed"
    for l, (tl, jl) in enumerate(zip(tpyr.levels, jpyr.levels)):
        assert tl.stride == ((1, 1, 1) if l == 0 else (2 ** l,) * 3)
        _eq(tl.coords, jl.coords)
        _eq(tl.valid, jl.valid)
        _eq(tl.keys.hi, jl.keys.hi)
        _eq(tl.keys.lo, jl.keys.lo)
        _eq(tl.subm_kmap, jl.subm_kmap)
        if l >= 1:
            _eq(tl.down_kmap, jl.down_kmap)
        if l + 1 < len(caps):
            assert tl.up_one_hot and jl.up_one_hot
            _eq(tl.up_kmap, jl.up_kmap)
    _eq(tpyr.point_to_voxel0, jpyr.point_to_voxel0)


@pytest.mark.parametrize("level", [2, 4])
def test_corner_and_devox_tables(scan_pyramids, level):
    _, _, _, jpyr, tpyr = scan_pyramids
    _eq(_corner_table(tpyr.levels[level]),
        jax.jit(jx_corner_table)(jpyr.levels[level]))
    td, jd = tpyr.devox[level], jpyr.devox[level]
    assert not td.identity and not jd.identity
    _eq(td.idx, jd.idx)
    np.testing.assert_allclose(_np(td.weights), _np(jd.weights),
                               rtol=1e-6, atol=1e-6)
    assert tpyr.devox[0].identity and jpyr.devox[0].identity
