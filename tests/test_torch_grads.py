"""Port parity of the backward passes: one group per autograd Function.

On CPU tensors each Function's backward runs its plain version (the CUDA
kernels K2, K5, K6, K8 and the shared dW kernel are checked against these
plain versions on the card by chip_smoke.py and tests/test_torch_cuda.py).
The same numpy inputs and the same numpy cotangent R (loss = sum(out * R)
over the valid rows) go through
  - ``jax.grad`` of the JAX Pallas entry in interpret mode, patched as
    tests/test_torch_kernels.py patches it: 0.05 for the convs (the Pallas
    conv kernels stage in bf16-grade arithmetic, the tolerance of
    tests/test_pallas_*.py), 1e-5 for devox (float32 throughout);
  - ``jax.grad`` of the JAX XLA path in float32 at rtol = atol = 1e-4 (same
    maths, other summation order);
  - ``torch.autograd.gradcheck`` in float64 at a tiny size (finite
    differences against the analytic backward, gradcheck's own default
    tolerances).
It also checks, on CPU, the formulation of each CUDA branch: with the
kernel launchers replaced by plain equivalents, the maps, transposes and
operand sides the wrappers hand the kernels give the plain backward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import (PALLAS_CONV_TOL, PALLAS_DEVOX_TOL, XLA_TOL,
                                devox_tables, scene_plan,
                                small_pallas_config,  # noqa
                                subm_scene, tiled_parent_gemm, updown_scene)
from torch_threads import one_torch_thread  # noqa: F401

import openpcseg_tpu.ops.pallas_conv as pc
import openpcseg_tpu.ops.pallas_devox as pd
import openpcseg_tpu.ops.pallas_updown as pud
from openpcseg_torch.core.geometry import devox_table
from openpcseg_torch.ops import cuda_lib, subm_conv, updown
from openpcseg_torch.ops.devox import DevoxFn
from openpcseg_torch.ops.sparse_conv import _conv_apply
from openpcseg_torch.data.raycast import raycast_batch
from openpcseg_torch.engine.task import SegTask, batch_to_device
from openpcseg_torch.ops.subm_conv import (SubmConvFn, dw_chunks,
                                           gather_dw_plain)
from openpcseg_torch.ops.updown import DownConvFn, UpConvFn
from openpcseg_torch.ops.voxelize import _devox_bwd
from openpcseg_tpu.ops import kernel_offsets
from openpcseg_tpu.ops.sparse_conv import _core_bwd as jx_core_bwd
from openpcseg_tpu.ops.sparse_conv import (sparse_conv, sparse_conv_up2,
                                           window_subm_conv)
from openpcseg_tpu.ops.voxelize import _devox_apply as jx_devox_apply

F32 = jnp.float32


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x)).to(dtype)


def _jax_grads(fn, feats, w, r):
    """d/d(feats, w) of sum(fn(feats, w) * r)."""
    return jax.grad(lambda f, w_: jnp.sum(fn(f, w_) * r), argnums=(0, 1))(
        jnp.asarray(feats), jnp.asarray(w))


def _torch_grads(fn_apply, feats, w, r, valid, *maps):
    f = _t(feats).requires_grad_()
    w_ = _t(w).requires_grad_()
    out = torch.where(_t(valid, torch.bool)[:, None],
                      fn_apply(f, w_, *maps), 0.0)
    (out * _t(r)).sum().backward()
    return f.grad.numpy(), w_.grad.numpy()


def _check(got, want, tol):
    for g, x in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(x), **tol)
    assert min(np.abs(g).max() for g in got) > 0.1


# ------------------------------------------------------------------ K2 ----

def test_subm_grads_match_pallas_and_xla(rng):
    feats, kmap, valid = subm_scene(rng, cin=8)
    w = rng.normal(size=(27, 8, 12)).astype(np.float32)
    r = rng.normal(size=(feats.shape[0], 12)).astype(np.float32)
    got = _torch_grads(SubmConvFn.apply, feats, w, r, valid, _t(kmap,
                                                                torch.int32))
    offs = kernel_offsets(3)
    _check(got, _jax_grads(lambda f, w_: pc.pallas_window_subm_conv(
        f, w_, kmap, valid, offs, compute_dtype=F32), feats, w, r),
        PALLAS_CONV_TOL)
    _check(got, _jax_grads(lambda f, w_: window_subm_conv(
        f, w_, kmap, valid, offs, compute_dtype=F32), feats, w, r), XLA_TOL)


def test_subm_stem_width_grads_match_xla(rng):
    """Cin = 4, the stem's ragged width."""
    feats, kmap, valid = subm_scene(rng, cin=4)
    w = rng.normal(size=(27, 4, 8)).astype(np.float32)
    r = rng.normal(size=(feats.shape[0], 8)).astype(np.float32)
    got = _torch_grads(SubmConvFn.apply, feats, w, r, valid, _t(kmap,
                                                                torch.int32))
    _check(got, _jax_grads(lambda f, w_: window_subm_conv(
        f, w_, kmap, valid, kernel_offsets(3), compute_dtype=F32),
        feats, w, r), XLA_TOL)


# ------------------------------------------------------------ K6 / K5 ----

def test_down_grads_match_pallas_and_xla(rng):
    f_fine, _, dk, uk, _, cvalid = updown_scene(rng)
    w = rng.normal(size=(8, 8, 12)).astype(np.float32)
    r = rng.normal(size=(dk.shape[1], 12)).astype(np.float32)
    got = _torch_grads(DownConvFn.apply, f_fine, w, r, cvalid,
                       _t(dk, torch.int32), _t(uk, torch.int32),
                       scene_plan(dk, uk.shape[1]))
    _check(got, _jax_grads(lambda f, w_: pud.pallas_conv_down2(
        f, w_, dk, cvalid, uk, compute_dtype=F32), f_fine, w, r),
        PALLAS_CONV_TOL)
    _check(got, _jax_grads(lambda f, w_: sparse_conv(
        f, w_, dk, cvalid, kmap_t=uk, compute_dtype=F32), f_fine, w, r),
        XLA_TOL)


def test_up_grads_match_pallas_and_xla(rng):
    _, f_coarse, dk, uk, fvalid, _ = updown_scene(rng)
    w = rng.normal(size=(8, 8, 12)).astype(np.float32)
    r = rng.normal(size=(uk.shape[1], 12)).astype(np.float32)
    got = _torch_grads(UpConvFn.apply, f_coarse, w, r, fvalid,
                       _t(uk, torch.int32), _t(dk, torch.int32),
                       scene_plan(dk, uk.shape[1]))
    _check(got, _jax_grads(lambda f, w_: pud.pallas_conv_up2(
        f, w_, uk, fvalid, dk, compute_dtype=F32), f_coarse, w, r),
        PALLAS_CONV_TOL)
    _check(got, _jax_grads(lambda f, w_: sparse_conv_up2(
        f, w_, uk, fvalid, dk, compute_dtype=F32), f_coarse, w, r),
        XLA_TOL)


# ------------------------------------------------------------------ K8 ----

def _devox_table(idx, w, v):
    return devox_table(_t(idx, torch.int32), _t(w), v)


@pytest.mark.parametrize("n,v,c", [(100, 40, 16), (200, 70, 96)])
def test_devox_grads_match_pallas_and_xla(rng, n, v, c):
    vf, idx, w = devox_tables(rng, n, v, c)
    r = rng.normal(size=(n, c)).astype(np.float32)
    x = _t(vf).requires_grad_()
    (DevoxFn.apply(x, _devox_table(idx, w, v)) * _t(r)).sum().backward()
    got = x.grad.numpy()

    def jgrad(fn):
        return np.asarray(jax.grad(lambda x_: jnp.sum(fn(x_) * r))(
            jnp.asarray(vf)))
    np.testing.assert_allclose(got, jgrad(lambda x_: pd.pallas_devoxelize(
        x_, jnp.asarray(idx), jnp.asarray(w), compute_dtype=F32)),
        **PALLAS_DEVOX_TOL)
    np.testing.assert_allclose(got, jgrad(lambda x_: jx_devox_apply(
        x_, jnp.asarray(idx), jnp.asarray(w))), **XLA_TOL)
    assert np.abs(got).max() > 0.1


def test_devox_transpose_table_is_the_csr_of_idx(rng):
    """What K8 walks: each voxel's (point, weight) contributors in (corner,
    point) order, misses outside every range; walking it gives the plain
    transpose."""
    vf, idx, w = devox_tables(rng, 150, 60, 8)
    tbl = _devox_table(idx, w, 60)
    ptr = tbl.t_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == (idx >= 0).sum()
    assert (np.diff(ptr) >= 0).all()
    d = rng.normal(size=(150, 8)).astype(np.float32)
    walked = np.zeros((60, 8), np.float32)
    for v in range(60):
        pts = tbl.t_point.numpy()[ptr[v]:ptr[v + 1]]
        flat = np.flatnonzero(idx.reshape(-1) == v)
        np.testing.assert_array_equal(pts, flat % 150)
        walked[v] = (tbl.t_weight.numpy()[ptr[v]:ptr[v + 1], None]
                     * d[pts]).sum(0)
    ref = _devox_bwd(_t(d), tbl.idx, tbl.weights, 60).numpy()
    np.testing.assert_allclose(walked, ref, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ gradcheck --

def test_gradcheck_float64(rng):
    """Finite differences against every Function's analytic backward."""
    f64 = torch.float64
    feats, kmap, _ = subm_scene(rng, cin=2, span=4, n_batch=1, n_active=14,
                                cap=16)
    f = _t(feats, f64).requires_grad_()
    w27 = _t(rng.normal(size=(27, 2, 3)), f64).requires_grad_()
    assert torch.autograd.gradcheck(
        SubmConvFn.apply, (f, w27, _t(kmap, torch.int32)))

    f_fine, f_coarse, dk, uk, _, _ = updown_scene(rng, cin=2, span=5,
                                                  n_batch=1, n_active=20)
    w8 = _t(rng.normal(size=(8, 2, 3)), f64).requires_grad_()
    plan = scene_plan(dk, uk.shape[1])
    dk, uk = _t(dk, torch.int32), _t(uk, torch.int32)
    assert torch.autograd.gradcheck(
        DownConvFn.apply, (_t(f_fine, f64).requires_grad_(), w8, dk, uk,
                           plan))
    assert torch.autograd.gradcheck(
        UpConvFn.apply, (_t(f_coarse, f64).requires_grad_(), w8, uk, dk,
                         plan))

    vf, idx, w = devox_tables(rng, 20, 9, 3)
    tbl = _devox_table(idx, w, 9)
    assert torch.autograd.gradcheck(
        lambda x: DevoxFn.apply(x, tbl), (_t(vf, f64).requires_grad_(),))


# ------------------------------------------- the CUDA branches' formulation --

class _CudaFlagged(torch.Tensor):
    """A CPU tensor that reports is_cuda, to reach a wrapper's CUDA branch."""

    @property
    def is_cuda(self):
        return True


def _flag(t):
    return t.as_subclass(_CudaFlagged)


def _plain(t):
    return None if t is None else t.as_subclass(torch.Tensor).float()


@pytest.fixture
def plain_launchers(monkeypatch):
    """The kernel launchers replaced by plain float32 equivalents; the
    parent gather by its tiled formulation over the parity plan."""
    def gemm(feats, w, kmap, counter, reverse=False):   # gather_gemm
        kmap = kmap.as_subclass(torch.Tensor)
        return _conv_apply(_plain(feats), _plain(w),
                           kmap.flip(0) if reverse else kmap, None,
                           torch.float32)

    def parent(src, w, plan, counter):         # parent_gemm
        return tiled_parent_gemm(_plain(src), _plain(w), plan)

    def dw(a, ia, b, ib):
        return gather_dw_plain(_plain(a), ia, _plain(b), ib)
    monkeypatch.setattr(cuda_lib, "check_cuda", lambda *a, **k: None)
    for mod in (subm_conv, updown):
        monkeypatch.setattr(mod, "gather_gemm", gemm)
        monkeypatch.setattr(mod, "gather_dw", dw)
    monkeypatch.setattr(updown, "parent_gemm", parent)


def _bf16_grade(rng, *shape):
    """float32 values exact in bf16, so the branch's bf16 casts are exact."""
    return torch.as_tensor(rng.normal(size=shape).astype(np.float32)).to(
        torch.bfloat16).float()


@pytest.mark.parametrize("kind", ["subm", "down", "up"])
def test_cuda_branch_formulation(rng, plain_launchers, kind):
    """Offset order of the flipped map against W[k]^T, the up / down maps
    and the parity plan each backward reads, and the side of dW each map
    gathers."""
    fine_f, coarse_f, dk, uk, fvalid, cvalid = updown_scene(rng, cin=8)
    plan = scene_plan(dk, uk.shape[1], tile_rows=8)
    dk, uk = _t(dk, torch.int32), _t(uk, torch.int32)
    extra = ()
    if kind == "subm":
        feats, kmap, valid = subm_scene(rng, cin=8)
        kmap = _t(kmap, torch.int32)
        x = _t(feats)
        w = _bf16_grade(rng, 27, 8, 12)
        d = _bf16_grade(rng, x.shape[0], 12) * _t(valid, torch.bool)[:, None]
        args = (x, w, kmap)
        kern, plain = subm_conv.subm_conv_bwd, subm_conv.subm_conv_bwd_plain
    elif kind == "down":
        x, w = _t(fine_f), _bf16_grade(rng, 8, 8, 12)
        d = _bf16_grade(rng, dk.shape[1], 12) * _t(cvalid, torch.bool)[:,
                                                                       None]
        args = (x, w, dk, uk)
        extra = (plan,)               # the kernel branch tiles by the plan
        kern, plain = updown.down_conv_bwd, updown.down_conv_bwd_plain
    else:
        x, w = _t(coarse_f), _bf16_grade(rng, 8, 8, 12)
        d = _bf16_grade(rng, uk.shape[1], 12) * _t(fvalid, torch.bool)[:,
                                                                       None]
        args = (x, w, uk, dk)
        kern, plain = updown.up_conv_bwd, updown.up_conv_bwd_plain
    x16 = x.to(torch.bfloat16)
    got = kern(_flag(d), _flag(x16), *args[1:], *extra)
    want = plain(d, x16.float(), *args[1:])
    for g, r in zip(got, want):
        np.testing.assert_allclose(_plain(g).numpy(), r.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_subm_bwd_reads_the_map_reversed_without_a_copy(rng, monkeypatch):
    """K2 on the card: the dfeats launch gets the original map and the
    reverse flag (no flipped copy), the dW launch the same map."""
    calls = []
    monkeypatch.setattr(cuda_lib, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(cuda_lib, "launch",
                        lambda name, counter, *a: calls.append((name, a)))
    kmap = torch.full((27, 16), -1, dtype=torch.int32)
    f = _flag(torch.zeros(16, 8, dtype=torch.bfloat16))
    subm_conv.subm_conv_bwd(_flag(torch.zeros(16, 12)), f,
                            torch.zeros(27, 8, 12), kmap)
    (gemm, g), (dw, d) = calls
    assert gemm == "opcs_gather_gemm_bf16" and dw == "opcs_gather_dw_bf16"
    assert g[2] == kmap.data_ptr() and g[6:] == (16, 27, 12, 8, 1, 1)
    assert d[1] == kmap.data_ptr() and d[3] is None


# ------------------------------------------------ the dW kernel's order --

def compacted_dw(a, ia, b, ib, rows, n_chunks, tk=32, seg=2048):
    """csrc/gather_dw.cu's order in plain float32: for each offset and each
    chunk of `rows` rows, the live pairs (both indices >= 0) of each
    segment of `seg` rows in row order, summed `tk` pairs a step into the
    chunk's partial; the partials then summed in chunk order."""
    idx = ia if ia is not None else ib
    num_k, n = idx.shape
    ident = torch.arange(n, dtype=torch.int32)
    out = torch.zeros(num_k, a.shape[1], b.shape[1])
    for k in range(num_k):
        ra = ident if ia is None else ia[k]
        rb = ident if ib is None else ib[k]
        total = torch.zeros_like(out[k])
        for c in range(n_chunks):
            part = torch.zeros_like(total)
            for s0 in range(c * rows, min(n, (c + 1) * rows), seg):
                sl = slice(s0, min(n, (c + 1) * rows, s0 + seg))
                live = (ra[sl] >= 0) & (rb[sl] >= 0)
                pa, pb = ra[sl][live].long(), rb[sl][live].long()
                for p in range(0, len(pa), tk):
                    part = part + (a[pa[p:p + tk]].float().t()
                                   @ b[pb[p:p + tk]].float())
            total = total + part
        out[k] = total
    return out


@pytest.fixture(scope="module")
def scan_pyramid():
    """The port's pyramid of an 8192-point ray-cast scan, on the CPU."""
    cfgs = {"DATA": {"VOXEL_SIZE": 0.05},
            "MODEL": {"NAME": "MinkUNet", "BLOCK": "ResBlock"},
            "TPU": {"VOXEL_CAP_PER_SCAN": 8192}}
    task = SegTask(cfgs, 20, device="cpu")
    return task.preprocess(batch_to_device(raycast_batch(0, 1, cap=8192),
                                           "cpu"))[1]


def _dw_cases(rng, kind, pyr):
    """(a, ia, b, ib, JAX _core_bwd dW) of each conv backward's dW form:
    subm (K2: A by the map, B the identity) on the scan's level 0 and on a
    small scene, down (K6) and up (K5: A the identity, B by the coarse
    level's down map) on an up/down scene."""
    def rnd(n, c):
        return torch.as_tensor(rng.normal(size=(n, c)).astype(np.float32))

    def jx(feats, maps, dout, center):
        w = jnp.zeros((len(maps[0]), feats.shape[1], dout.shape[1]))
        res = (jnp.asarray(feats.numpy()), w,
               *(jnp.asarray(m.numpy()) for m in maps))
        return np.asarray(jx_core_bwd(center, F32, res,
                                      jnp.asarray(dout.numpy()))[1])
    if kind.startswith("subm"):
        if kind == "subm_scan":
            lv = pyr.levels[0]
            kmap, valid = lv.subm_kmap, lv.valid
        else:
            _, kmap, valid = subm_scene(rng, cin=8)
            kmap, valid = _t(kmap, torch.int32), _t(valid, torch.bool)
        n = kmap.shape[1]
        a = rnd(n, 16) * valid[:, None]
        d = rnd(n, 24) * valid[:, None]
        return a, kmap, d, None, jx(a, (kmap, kmap.flip(0)), d, 13)
    f_fine, f_coarse, dk, uk, fvalid, cvalid = updown_scene(rng, cin=16)
    dk, uk = _t(dk, torch.int32), _t(uk, torch.int32)
    if kind == "down":
        a, d = _t(f_fine), rnd(dk.shape[1], 24) * _t(cvalid, torch.bool)[:,
                                                                          None]
        return a, dk, d, None, jx(a, (dk, uk), d, None)
    a, d = _t(f_coarse), rnd(uk.shape[1], 24) * _t(fvalid, torch.bool)[:,
                                                                        None]
    return a, None, d, dk, jx(a, (uk, dk), d, None)


@pytest.mark.parametrize("kind", ["subm_scan", "subm_scene", "down", "up"])
def test_compacted_dw_order_matches_plain_and_jax(rng, scan_pyramid, kind):
    """The dW kernel's chunked, compacted, fixed-order sum (at the chunking
    dw_chunks gives the card) against the plain dW and JAX's _core_bwd dW,
    float32 both (other summation orders)."""
    a, ia, b, ib, ref = _dw_cases(rng, kind, scan_pyramid)
    idx = ia if ia is not None else ib
    rows, n_chunks = dw_chunks(idx.shape[1], idx.shape[0], a.shape[1],
                               b.shape[1])
    if kind == "subm_scan":
        assert n_chunks > 1    # the partials and their fixed-order sum
    got = compacted_dw(a, ia, b, ib, rows, n_chunks)
    np.testing.assert_allclose(got.numpy(),
                               gather_dw_plain(a, ia, b, ib).numpy(),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), ref, **XLA_TOL)
    assert np.abs(ref).max() > 0.1
