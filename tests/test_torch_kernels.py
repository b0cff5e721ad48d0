"""Port parity, part (b): one test group per kernel module.

Each port wrapper gets CPU tensors here, so it runs its plain version (the
CUDA kernels themselves are checked against these plain versions on the
card by chip_smoke.py and tests/test_torch_cuda.py). The plain version is
held against
  - the JAX Pallas entry in interpret mode, patched as
    tests/test_pallas_{conv,updown,devox}.py patch it, at those files'
    tolerances (0.05 for conv/updown: the kernels stage in bf16-grade
    arithmetic; 1e-5 for devox), and
  - the JAX XLA path in float32 at rtol = atol = 1e-4 (same maths, other
    summation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openpcseg_tpu.ops.pallas_conv as pc
import openpcseg_tpu.ops.pallas_devox as pd
import openpcseg_tpu.ops.pallas_updown as pud
from openpcseg_tpu.core.geometry import build_pyramid as jx_build_pyramid
from openpcseg_tpu.ops import build_subm_kmap, kernel_offsets, unique_coords
from openpcseg_tpu.ops.sparse_conv import (sparse_conv, sparse_conv_up2,
                                           window_subm_conv)
from openpcseg_tpu.ops.voxelize import _devox_apply as jx_devox_apply
from openpcseg_torch.ops import cuda_lib
from openpcseg_torch.ops.devox import devoxelize
from openpcseg_torch.ops.subm_conv import subm_conv
from openpcseg_torch.ops.updown import down_conv, parent_parity, up_conv

XLA_TOL = dict(rtol=1e-4, atol=1e-4)
PALLAS_CONV_TOL = dict(rtol=0.05, atol=0.05)
PALLAS_DEVOX_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def small_pallas_config(monkeypatch):
    """The patches of tests/test_pallas_{conv,updown,devox}.py."""
    monkeypatch.setattr(pc, "INTERPRET", True)
    monkeypatch.setattr(pc, "BLK", 64)
    monkeypatch.setattr(pc, "WIN", 128)
    monkeypatch.setattr(pc, "NW", 4)
    monkeypatch.setattr(pud, "INTERPRET", True)
    monkeypatch.setattr(pud, "BLK", 64)
    monkeypatch.setattr(pud, "WIN", 128)
    monkeypatch.setattr(pd, "INTERPRET", True)
    monkeypatch.setattr(pd, "BLK", 16)
    monkeypatch.setattr(pd, "WIN", 16)
    monkeypatch.setattr(pd, "NW", 8)
    monkeypatch.setattr(pd, "NWT", 32)
    monkeypatch.setattr(pd, "VBLK", 8)
    monkeypatch.setattr(pd, "DWIN", 128)
    monkeypatch.setattr(pd, "DNWT", 64)


def _t(x, dtype=None):
    t = torch.as_tensor(np.array(x))
    return t if dtype is None else t.to(dtype)


def _masked(out, valid):
    return torch.where(_t(valid)[:, None], out, 0.0).numpy()


def _coords(rng, span, n_batch, n_active):
    coords = []
    for b in range(n_batch):
        xyz = np.unique(rng.integers(0, span, size=(n_active, 3)), axis=0)
        coords.append(np.concatenate([np.full((len(xyz), 1), b), xyz], 1))
    return np.concatenate(coords).astype(np.int32)


def subm_scene(rng, cin, span=10, n_batch=2, n_active=120, cap=640):
    """test_pallas_conv.scene: a padded level with its 3^3 kernel map."""
    coords = _coords(rng, span, n_batch, n_active)
    n = len(coords)
    pcrd = np.full((cap, 4), -1, np.int32)
    pcrd[:n] = coords
    valid = np.zeros(cap, bool)
    valid[:n] = True
    res = unique_coords(jnp.asarray(pcrd), jnp.asarray(valid), cap)
    feats = np.zeros((cap, cin), np.float32)
    feats[np.asarray(res.valid)] = rng.normal(
        size=(int(np.asarray(res.valid).sum()), cin)).astype(np.float32)
    kmap = build_subm_kmap(res.keys, res.coords, res.valid, 3)
    return feats, kmap, res.valid


def updown_scene(rng, cin=8, span=12, n_batch=2, n_active=150):
    """test_pallas_updown.updown_scene: two levels with the parity maps."""
    coords = _coords(rng, span, n_batch, n_active)
    n = len(coords)
    pyr = jx_build_pyramid(jnp.asarray(coords), jnp.ones(n, bool), [n, n],
                           subm_kernel=None, updown_kernel=2)
    fine, coarse = pyr.levels[0], pyr.levels[1]
    assert fine.up_one_hot
    f_fine = np.zeros((n, cin), np.float32)
    f_fine[np.asarray(fine.valid)] = rng.normal(
        size=(int(np.asarray(fine.valid).sum()), cin)).astype(np.float32)
    f_coarse = np.zeros((n, cin), np.float32)
    f_coarse[np.asarray(coarse.valid)] = rng.normal(
        size=(int(np.asarray(coarse.valid).sum()), cin)).astype(np.float32)
    return (f_fine, f_coarse, coarse.down_kmap, fine.up_kmap, fine.valid,
            coarse.valid)


# ------------------------------------------------------------------ K1 ----

def test_subm_conv_matches_pallas_interpret(rng):
    feats, kmap, valid = subm_scene(rng, cin=8)
    w = rng.normal(size=(27, 8, 12)).astype(np.float32)
    ref = pc.pallas_window_subm_conv(
        jnp.asarray(feats), jnp.asarray(w), kmap, valid, kernel_offsets(3),
        compute_dtype=jnp.float32)
    got = _masked(subm_conv(_t(feats), _t(w), _t(kmap)), valid)
    np.testing.assert_allclose(got, np.asarray(ref), **PALLAS_CONV_TOL)
    assert np.abs(got).max() > 0.1


@pytest.mark.parametrize("cin", [4, 8])   # 4: the stem's ragged width
def test_subm_conv_matches_xla(rng, cin):
    feats, kmap, valid = subm_scene(rng, cin=cin)
    w = rng.normal(size=(27, cin, 12)).astype(np.float32)
    ref = window_subm_conv(jnp.asarray(feats), jnp.asarray(w), kmap, valid,
                           kernel_offsets(3), compute_dtype=jnp.float32)
    got = _masked(subm_conv(_t(feats), _t(w), _t(kmap)), valid)
    np.testing.assert_allclose(got, np.asarray(ref), **XLA_TOL)


# ------------------------------------------------------------ K3 / K4 ----

def test_down_conv_matches_pallas_and_xla(rng):
    f_fine, _, dk, uk, _, cvalid = updown_scene(rng)
    w = rng.normal(size=(8, 8, 12)).astype(np.float32)
    got = _masked(down_conv(_t(f_fine), _t(w), _t(dk)), cvalid)
    ref_pl = pud.pallas_conv_down2(jnp.asarray(f_fine), jnp.asarray(w), dk,
                                   cvalid, uk, compute_dtype=jnp.float32)
    np.testing.assert_allclose(got, np.asarray(ref_pl), **PALLAS_CONV_TOL)
    ref_x = sparse_conv(jnp.asarray(f_fine), jnp.asarray(w), dk, cvalid,
                        kmap_t=uk, compute_dtype=jnp.float32)
    np.testing.assert_allclose(got, np.asarray(ref_x), **XLA_TOL)
    assert np.abs(got).max() > 0.1


def test_up_conv_matches_pallas_and_xla(rng):
    _, f_coarse, dk, uk, fvalid, _ = updown_scene(rng)
    w = rng.normal(size=(8, 8, 12)).astype(np.float32)
    got = _masked(up_conv(_t(f_coarse), _t(w), _t(uk)), fvalid)
    ref_pl = pud.pallas_conv_up2(jnp.asarray(f_coarse), jnp.asarray(w), uk,
                                 fvalid, dk, compute_dtype=jnp.float32)
    np.testing.assert_allclose(got, np.asarray(ref_pl), **PALLAS_CONV_TOL)
    ref_x = sparse_conv_up2(jnp.asarray(f_coarse), jnp.asarray(w), uk,
                            fvalid, dk, compute_dtype=jnp.float32)
    np.testing.assert_allclose(got, np.asarray(ref_x), **XLA_TOL)
    assert np.abs(got).max() > 0.1


def test_parent_parity_is_the_one_hot_hit(rng):
    _, _, _, uk, fvalid, _ = updown_scene(rng)
    uk = np.asarray(uk)
    parent, parity = parent_parity(_t(uk))
    hit = (uk >= 0).sum(0)
    assert set(np.unique(hit)) <= {0, 1}
    np.testing.assert_array_equal(parent.numpy(), uk.max(0))
    rows = np.nonzero(hit)[0]
    np.testing.assert_array_equal(uk[parity.numpy()[rows], rows],
                                  uk.max(0)[rows])


# ------------------------------------------------------------------ K7 ----

def devox_tables(rng, n, v, c, miss_frac=0.15):
    """test_pallas_devox._mk: monotone base rows per (cx, cy) column and
    z-adjacent corner pairs, as the geometry pass produces them."""
    idx = np.full((8, n), -1, np.int32)
    for j in range(4):
        base = np.sort(rng.integers(0, v - 1, n).astype(np.int32))
        idx[2 * j] = np.where(rng.random(n) >= miss_frac, base, -1)
        idx[2 * j + 1] = np.where(rng.random(n) >= miss_frac, base + 1, -1)
    w = rng.random((8, n)).astype(np.float32)
    w[idx < 0] = 0.0
    return rng.normal(size=(v, c)).astype(np.float32), idx, w


@pytest.mark.parametrize("n,v,c", [(100, 40, 16), (200, 70, 96)])
def test_devox_matches_pallas_and_xla(rng, n, v, c):
    vf, idx, w = devox_tables(rng, n, v, c)
    got = devoxelize(_t(vf), _t(idx), _t(w)).numpy()
    ref_pl = pd.pallas_devoxelize(jnp.asarray(vf), jnp.asarray(idx),
                                  jnp.asarray(w), compute_dtype=jnp.float32)
    np.testing.assert_allclose(got, np.asarray(ref_pl), **PALLAS_DEVOX_TOL)
    ref_x = jx_devox_apply(jnp.asarray(vf), jnp.asarray(idx), jnp.asarray(w))
    np.testing.assert_allclose(got, np.asarray(ref_x), **XLA_TOL)


def test_cpu_wrappers_count_no_launch(rng):
    """CPU tensors take the plain versions: no launch is counted, and no
    plain run is recorded as one on a CUDA tensor."""
    cuda_lib.reset_counts()
    vf, idx, w = devox_tables(rng, 50, 20, 8)
    devoxelize(_t(vf), _t(idx), _t(w))
    feats, kmap, _ = subm_scene(rng, cin=4)
    subm_conv(_t(feats), _t(rng.normal(size=(27, 4, 8)), torch.float32),
              _t(kmap))
    assert sum(cuda_lib.LAUNCHES.values()) == 0
    assert sum(cuda_lib.PLAIN_ON_CUDA.values()) == 0
