"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip (inside the fixture) where torch sees no CUDA
device, as on CPU-only machines. On a machine with an H100 and nvcc:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

Shapes come from the port's own pyramid of an 8192-point ray-cast scan;
features are zero on padding rows, as every caller keeps them (the plain
subm version takes the identity centre offset without a gather). Operands
are bf16 (K7 and K8 also float32), both sides sum in float32, so they differ by summation order
only: max|kernel - plain| <= 2e-2 * max|plain|. The backward kernels (K2,
K5, K6 and the shared dW kernel, K8) are checked per output, dfeats and dW
apart, and must repeat bit for bit: none of them sums with atomics (the
gather-GEMM's split tiles and K8's segments count arrivals, and the last to
arrive adds the partials in a fixed order). So must the K7 devoxelize and
the parent gather (K4, and K6's dfeats alone), whose rows without a parent
must come out exactly zero.
"""
import pytest
import torch

from openpcseg_torch.core.geometry import devox_table
from openpcseg_torch.data.raycast import raycast_batch
from openpcseg_torch.engine.task import SegTask, batch_to_device
from openpcseg_torch.ops import cuda_lib, devox, subm_conv, updown
from openpcseg_torch.ops.sparse_conv import _conv_apply
from openpcseg_torch.ops.voxelize import _devox_bwd

pytestmark = pytest.mark.cuda
TOL = 2e-2
# every (level, Cin, Cout) of the mk34 subm convs and (coarse level, C) of
# its down convs, as chip_smoke.py runs them
SUBM_PAIRS = [(0, 4, 32), (0, 32, 32), (1, 32, 32), (2, 32, 64), (2, 64, 64),
              (3, 64, 128), (3, 128, 128), (4, 128, 256), (4, 256, 256),
              (3, 384, 256), (3, 256, 256), (2, 192, 128), (2, 128, 128),
              (1, 128, 96), (1, 96, 96), (0, 128, 96), (0, 96, 96)]
DOWNS = [(1, 32), (2, 32), (3, 64), (4, 128)]


@pytest.fixture(scope="module")
def pyr():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfgs = {"DATA": {"VOXEL_SIZE": 0.05},
            "MODEL": {"NAME": "MinkUNet", "BLOCK": "ResBlock"},
            "TPU": {"VOXEL_CAP_PER_SCAN": 8192,
                    "VOXEL_CAP_RATIOS": [1.0, 1.0, 0.6, 0.3, 0.15]}}
    task = SegTask(cfgs, 20, device="cuda", compute_dtype=torch.bfloat16)
    _, p = task.preprocess(batch_to_device(raycast_batch(0, 1, cap=8192),
                                           "cuda"))
    return p


def _rand(*shape, gen):
    return torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)


def _feats(lv, c, gen):
    """bf16 features of a level, zero on its padding rows."""
    return torch.where(lv.valid[:, None], _rand(lv.capacity, c, gen=gen), 0)


def _close(got, ref):
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max()
    assert torch.isfinite(err) and err <= TOL * ref.float().abs().max(), err


def _twice(fn, *args, **kw):
    """Two calls, which must agree bit for bit (no atomics anywhere)."""
    got, again = fn(*args, **kw), fn(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    return got


@pytest.mark.parametrize("level,cin,cout", SUBM_PAIRS)
def test_subm_kernel(pyr, level, cin, cout):
    g = torch.Generator(device="cuda").manual_seed(0)
    lv = pyr.levels[level]
    x = _feats(lv, cin, g)
    w = _rand(27, cin, cout, gen=g)
    n = cuda_lib.LAUNCHES["subm"]
    _close(_twice(subm_conv.subm_conv, x, w, lv.subm_kmap),
           subm_conv.subm_conv_plain(x, w, lv.subm_kmap))
    assert cuda_lib.LAUNCHES["subm"] == n + 2


@pytest.mark.parametrize("level,c", DOWNS)
def test_down_kernel(pyr, level, c):
    g = torch.Generator(device="cuda").manual_seed(1)
    x = _feats(pyr.levels[level - 1], c, g)
    w = _rand(8, c, c, gen=g)
    km = pyr.levels[level].down_kmap
    _close(_twice(updown.down_conv, x, w, km),
           updown.down_conv_plain(x, w, km))


@pytest.mark.parametrize("level,c", [(0, 32), (1, 96), (3, 256)])
def test_gather_gemm_reverse_flag(pyr, level, c):
    """The reversed read of the map equals the kernel over a flipped copy,
    bit for bit, and the plain version over that copy."""
    g = torch.Generator(device="cuda").manual_seed(10)
    lv = pyr.levels[level]
    x = _feats(lv, c, g)
    w = _rand(27, c, c, gen=g)
    flipped = lv.subm_kmap.flip(0).contiguous()
    got = _twice(subm_conv.gather_gemm, x, w, lv.subm_kmap, "subm_bwd",
                 reverse=True)
    assert torch.equal(got, subm_conv.gather_gemm(x, w, flipped, "subm_bwd"))
    _close(got, _conv_apply(x, w, flipped, None, torch.bfloat16))


# ragged widths: Cin 4 and 12 (element loads), Cout 18 (element loads and
# stores), Cout 300 (element loads of W, two column blocks past 256)
@pytest.mark.parametrize("cin,cout", [(4, 32), (12, 18), (256, 300)])
def test_gather_gemm_edges(pyr, cin, cout):
    g = torch.Generator(device="cuda").manual_seed(11)
    lv = pyr.levels[1]
    x = _feats(lv, cin, g)
    w = _rand(27, cin, cout, gen=g)
    _close(_twice(subm_conv.subm_conv, x, w, lv.subm_kmap),
           subm_conv.subm_conv_plain(x, w, lv.subm_kmap))


def test_gather_gemm_all_padding_tiles(pyr):
    """Tiles without a single hit write exact zeros: a map whose last 300
    columns all miss, and a map that misses everywhere."""
    g = torch.Generator(device="cuda").manual_seed(12)
    lv = pyr.levels[1]
    x = _feats(lv, 64, g)
    w = _rand(27, 64, 96, gen=g)
    km = torch.cat([lv.subm_kmap[:, :200],
                    torch.full((27, 300), -1, dtype=torch.int32,
                               device="cuda")], 1).contiguous()
    got = _twice(subm_conv.gather_gemm, x, w, km, "subm")
    _close(got, _conv_apply(x, w, km, None, torch.bfloat16))
    assert (got[200:] == 0).all() and got[:200].abs().max() > 0
    none = torch.full_like(km, -1)
    assert (subm_conv.gather_gemm(x, w, none, "subm") == 0).all()


def _dw_check(a, ia, b, ib):
    n = cuda_lib.LAUNCHES["dw"]
    _close(_twice(subm_conv.gather_dw, a, ia, b, ib),
           subm_conv.gather_dw_plain(a, ia, b, ib))
    assert cuda_lib.LAUNCHES["dw"] == n + 2


@pytest.mark.parametrize("side", ["a", "b"])
def test_dw_identity_side(pyr, side):
    """K2's form (A gathered, B the identity) and K5's (A the identity, B
    gathered by the coarse level's down map)."""
    g = torch.Generator(device="cuda").manual_seed(13)
    fine, coarse = pyr.levels[0], pyr.levels[1]
    if side == "b":
        _dw_check(_feats(fine, 32, g), fine.subm_kmap, _feats(fine, 32, g),
                  None)
    else:
        _dw_check(_feats(coarse, 96, g), None, _feats(fine, 96, g),
                  coarse.down_kmap)


@pytest.mark.parametrize("drop", ["a", "b", "both"])
def test_dw_drops_misses_on_either_side(pyr, drop):
    """Two maps, with -1 on A's side, on B's, or on both, at other rows."""
    g = torch.Generator(device="cuda").manual_seed(14)
    lv = pyr.levels[1]
    km = lv.subm_kmap

    def holes(m):
        cut = torch.rand(m.shape, device="cuda", generator=g) < 0.3
        return torch.where(cut, torch.full_like(m, -1), m).contiguous()
    ia = holes(km) if drop in ("a", "both") else km
    ib = holes(km.flip(0)) if drop in ("b", "both") else km.flip(0)
    _dw_check(_feats(lv, 64, g), ia, _feats(lv, 96, g), ib.contiguous())


# the widest tiles and more tiles than one: 256 x 256 (two by two) and
# 384 x 256 (three by two, one chunk)
@pytest.mark.parametrize("level,ca,cb", [(4, 256, 256), (3, 384, 256)])
def test_dw_wide(pyr, level, ca, cb):
    g = torch.Generator(device="cuda").manual_seed(15)
    lv = pyr.levels[level]
    _dw_check(_feats(lv, ca, g), lv.subm_kmap, _feats(lv, cb, g), None)


def _parent_check(got, again, ref, plan):
    """The parent gather: close to its plain version, bit-identical twice,
    and exactly zero on the rows without a parent (the plan's group 8)."""
    _close(got, ref)
    assert torch.equal(got, again)
    off = plan.group_offsets.tolist()
    assert off[9] > off[8]
    assert (got[plan.dst_rows[off[8]:].long()] == 0).all()


# the four mk34 up convs (fine level, Cin, Cout): Cout 96 at levels 1 and 0
@pytest.mark.parametrize("level,cin,cout", [(3, 256, 256), (2, 256, 128),
                                            (1, 128, 96), (0, 96, 96)])
def test_up_kernel(pyr, level, cin, cout):
    g = torch.Generator(device="cuda").manual_seed(2)
    x = _feats(pyr.levels[level + 1], cin, g)
    w = _rand(8, cin, cout, gen=g)
    km = pyr.levels[level].up_kmap
    plan = pyr.levels[level + 1].parity_plan
    sizes = plan.group_offsets.diff()[:8]
    assert (sizes % plan.tile_rows != 0).any()   # ragged tiles on this path
    n = cuda_lib.LAUNCHES["up"]
    got, again = updown.up_conv(x, w, km, plan), updown.up_conv(x, w, km,
                                                                plan)
    assert cuda_lib.LAUNCHES["up"] == n + 2
    _parent_check(got, again, updown.up_conv_plain(x, w, km), plan)


# K6's data gradient alone at the four mk34 down convs (coarse level, C):
# dout [N_coarse, C] through W^T over the coarse level's plan
@pytest.mark.parametrize("level,c", [(1, 32), (2, 32), (3, 64), (4, 128)])
def test_down_dfeats_kernel(pyr, level, c):
    g = torch.Generator(device="cuda").manual_seed(8)
    d = _feats(pyr.levels[level], c, g)
    w = _rand(8, c, c, gen=g).float()
    plan = pyr.levels[level].parity_plan
    up_kmap = pyr.levels[level - 1].up_kmap
    got = updown.parent_gemm(d, w.transpose(1, 2), plan, "down_bwd")
    again = updown.parent_gemm(d, w.transpose(1, 2), plan, "down_bwd")
    ref = _conv_apply(d, w.transpose(1, 2), up_kmap, None, torch.bfloat16)
    _parent_check(got, again, ref, plan)


# ragged widths (element loads and stores) and Cout > 256 (two column
# blocks), on the level-0 up conv's plan
@pytest.mark.parametrize("cin,cout", [(12, 18), (256, 300)])
def test_parent_gemm_edges(pyr, cin, cout):
    g = torch.Generator(device="cuda").manual_seed(9)
    x = _feats(pyr.levels[1], cin, g)
    w = _rand(8, cin, cout, gen=g)
    km = pyr.levels[0].up_kmap
    plan = pyr.levels[1].parity_plan
    got, again = updown.up_conv(x, w, km, plan), updown.up_conv(x, w, km,
                                                                plan)
    _parent_check(got, again, updown.up_conv_plain(x, w, km), plan)


# the main path's (level, C), then ragged widths (element loads, two
# points a warp at 12) and a width of two channel passes (384)
DEVOX_CASES = [(4, 256), (2, 128), (2, 12), (4, 20), (4, 384)]
DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("level,c", DEVOX_CASES)
def test_devox_kernel(pyr, level, c, dtype):
    """K7: padding points (every corner missing) get zero rows."""
    g = torch.Generator(device="cuda").manual_seed(3)
    t = pyr.devox[level]
    x = _feats(pyr.levels[level], c, g).to(dtype)
    n = cuda_lib.LAUNCHES["devox"]
    got = _twice(devox.devoxelize, x, t.idx, t.weights)
    assert cuda_lib.LAUNCHES["devox"] == n + 2 and got.dtype == dtype
    _close(got, devox.devoxelize_plain(x, t.idx, t.weights))
    assert (got[~pyr.points.valid] == 0).all()


def _bwd_check(kern, plain, args, kern_extra=()):
    """Each output against the plain version, and bit-identical twice."""
    got, again = kern(*args, *kern_extra), kern(*args, *kern_extra)
    ref = plain(*args)
    for g, a, r in zip(got, again, ref):
        _close(g, r)
        assert torch.equal(g, a)


@pytest.mark.parametrize("level,cin,cout", [(0, 4, 32), (1, 96, 96),
                                            (3, 384, 256)])
def test_subm_backward_kernels(pyr, level, cin, cout):
    g = torch.Generator(device="cuda").manual_seed(4)
    lv = pyr.levels[level]
    args = (_feats(lv, cout, g).float(), _feats(lv, cin, g),
            _rand(27, cin, cout, gen=g).float(), lv.subm_kmap)
    n = dict(cuda_lib.LAUNCHES)
    _bwd_check(subm_conv.subm_conv_bwd, subm_conv.subm_conv_bwd_plain, args)
    assert cuda_lib.LAUNCHES["subm_bwd"] == n["subm_bwd"] + 2
    assert cuda_lib.LAUNCHES["dw"] == n["dw"] + 2


@pytest.mark.parametrize("level,c", [(1, 32), (4, 128)])
def test_down_backward_kernels(pyr, level, c):
    g = torch.Generator(device="cuda").manual_seed(5)
    fine, coarse = pyr.levels[level - 1], pyr.levels[level]
    args = (_feats(coarse, c, g).float(), _feats(fine, c, g),
            _rand(8, c, c, gen=g).float(), coarse.down_kmap, fine.up_kmap)
    _bwd_check(updown.down_conv_bwd, updown.down_conv_bwd_plain, args,
               (coarse.parity_plan,))


@pytest.mark.parametrize("level,cin,cout", [(3, 256, 256), (0, 96, 96)])
def test_up_backward_kernels(pyr, level, cin, cout):
    g = torch.Generator(device="cuda").manual_seed(6)
    fine, coarse = pyr.levels[level], pyr.levels[level + 1]
    args = (_feats(fine, cout, g).float(), _feats(coarse, cin, g),
            _rand(8, cin, cout, gen=g).float(), fine.up_kmap,
            coarse.down_kmap)
    _bwd_check(updown.up_conv_bwd, updown.up_conv_bwd_plain, args)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("level,c", DEVOX_CASES)
def test_devox_backward_kernel(pyr, level, c, dtype):
    """K8: padding voxels (no contributor) get zero rows."""
    g = torch.Generator(device="cuda").manual_seed(7)
    t = pyr.devox[level]
    d = _rand(t.idx.shape[1], c, gen=g).to(dtype)
    n = cuda_lib.LAUNCHES["devox_bwd"]
    got = _twice(devox.devoxelize_bwd, d, t)
    assert cuda_lib.LAUNCHES["devox_bwd"] == n + 2 and got.dtype == dtype
    _close(got, _devox_bwd(d, t.idx, t.weights, t.num_voxels))
    assert (got[~pyr.levels[level].valid] == 0).all()


def _long_voxel_table(n, v, gen, empty=False):
    """[8, n] corners on the card: corner 0 of every point hits voxel 5,
    a voxel of ceil(n / DEVOX_CHUNK) segments; the other corners hit random
    voxels below v - 2 or miss; voxels v - 2 and v - 1 are never hit; the
    last 64 points miss every corner. empty=True: every corner misses."""
    idx = torch.randint(0, v - 2, (8, n), generator=gen, device="cuda",
                        dtype=torch.int32)
    idx[0] = 5
    miss = torch.rand(8, n, generator=gen, device="cuda") < 0.3
    miss[0] = False
    miss[:, n - 64:] = True
    if empty:
        miss[:] = True
    idx = torch.where(miss, -1, idx).contiguous()
    w = torch.rand(8, n, generator=gen, device="cuda")
    return devox_table(idx, torch.where(miss, 0.0, w).contiguous(), v)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [256, 128, 20])
@pytest.mark.parametrize("empty", [False, True])
def test_devox_kernels_long_voxel_and_misses(dtype, c, empty):
    """A voxel of at least four segments (partials summed by the last warp
    to finish), voxels nobody hits, points that miss every corner, and (
    empty) a table without a single hit: K7 and K8 against their plain
    versions, bit for bit twice, zero rows where nothing is summed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(16)
    n, v = 2048, 40
    t = _long_voxel_table(n, v, g, empty)
    if not empty:
        assert int(t.seg_ptr[6] - t.seg_ptr[5]) >= 4
    x = torch.randn(v, c, device="cuda", generator=g).to(dtype)
    out = _twice(devox.devoxelize, x, t.idx, t.weights)
    assert (out[n - 64:] == 0).all()
    d = torch.randn(n, c, device="cuda", generator=g).to(dtype)
    dvox = _twice(devox.devoxelize_bwd, d, t)
    assert (dvox[v - 2:] == 0).all()
    if empty:
        assert (out == 0).all() and (dvox == 0).all()
        return
    _close(out, devox.devoxelize_plain(x, t.idx, t.weights))
    _close(dvox, _devox_bwd(d, t.idx, t.weights, v))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("level,c", [(4, 256), (2, 128), (2, 12)])
def test_voxelize_mean_kernels(dtype, level, c):
    """SPVCNN's mean-voxelize on the card: the sum (K8 over the p2v table)
    and its transpose (K7) against their plain versions (segment_sum, the
    gather), bit for bit twice, counted apart; VoxelizeMeanFn's forward and
    backward against segment_mean and autograd through it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from openpcseg_torch.ops.segment import segment_mean
    from openpcseg_torch.ops.voxelize import voxelize_mean
    cfgs = {"DATA": {"VOXEL_SIZE": 0.05},
            "MODEL": {"NAME": "SPVCNN", "BLOCK": "ResBlock"},
            "TPU": {"VOXEL_CAP_PER_SCAN": 8192,
                    "VOXEL_CAP_RATIOS": [1.0, 1.0, 0.6, 0.3, 0.15]}}
    task = SegTask(cfgs, 20, device="cuda", compute_dtype=torch.bfloat16)
    _, p = task.preprocess(batch_to_device(raycast_batch(0, 1, cap=8192),
                                           "cuda"))
    g = torch.Generator(device="cuda").manual_seed(17)
    t, lv = p.p2v[level], p.levels[level]
    z = torch.where(p.points.valid[:, None],
                    torch.randn(t.idx.shape[1], c, device="cuda",
                                generator=g), 0.0).to(dtype)
    n = dict(cuda_lib.LAUNCHES)
    s = _twice(devox.voxel_sum, z, t)
    # the plain bf16 sum (segment_sum, as JAX's) adds in bf16; K8 adds in
    # float32 and casts once: hold both types to the float32 sum
    _close(s, devox.voxel_sum_plain(z.float(), t))
    dy = _feats(lv, c, g).to(dtype)
    back = _twice(devox.point_gather, dy, t)
    _close(back, devox.point_gather_plain(dy, t))
    assert (back[~p.points.valid] == 0).all()
    assert cuda_lib.LAUNCHES["vmean"] == n["vmean"] + 2
    assert cuda_lib.LAUNCHES["vmean_bwd"] == n["vmean_bwd"] + 2
    zg = z.float().requires_grad_()
    mean = voxelize_mean(zg, t)
    _close(mean, segment_mean(z.float(), t.idx[0], t.num_voxels)[0])
    mean.backward(dy.float())
    want = zg.detach().requires_grad_()
    segment_mean(want, t.idx[0], t.num_voxels)[0].backward(dy.float())
    _close(zg.grad, want.grad)


# Cylinder3D's shapes: its anisotropic submanifold convs (K 9 and 3, and
# the 3^3) and k3 strided convs (K 27, stride (2,2,2) or (2,2,1), down and
# up) on the gather-GEMM and gather_dw, the 20-class head, the
# scatter-max and the refinement gather, on the pyramid of the
# cy480 grid over the 8192-point scan
CYL_SUBM = [((1, 3, 3), 0, 32, 32), ((3, 1, 1), 0, 64, 64),
            ((1, 3, 3), 3, 256, 256), ((3, 1, 3), 3, 256, 256),
            ((3, 3, 3), 4, 512, 512), ((3, 3, 3), 0, 128, 20),
            ((1, 3, 3), 0, 16, 32)]
CYL_STRIDED = [(1, 64), (2, 128), (4, 512)]   # coarse level, C


@pytest.fixture(scope="module")
def cyl_pyr():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import chip_smoke
    task = SegTask(chip_smoke.CYL_CFGS, 20, device="cuda",
                   compute_dtype=torch.bfloat16, voxel_cap_per_scan=8192)
    return task.preprocess(batch_to_device(raycast_batch(0, 1, cap=8192),
                                           "cuda"))


@pytest.mark.parametrize("ks,level,cin,cout", CYL_SUBM)
def test_cylinder_subm_kernels(cyl_pyr, ks, level, cin, cout):
    """An anisotropic subset of the 3^3 map on K1 and K2 (the reversed
    subset is the transposed map)."""
    g = torch.Generator(device="cuda").manual_seed(21)
    lv = cyl_pyr[1].levels[level]
    km = lv.subm_subset(ks)
    x = _feats(lv, cin, g)
    w = _rand(km.shape[0], cin, cout, gen=g).float()
    d = _feats(lv, cout, g).float()
    _close(_twice(subm_conv.subm_conv, x, w, km),
           subm_conv.subm_conv_plain(x, w, km))
    got = subm_conv.subm_conv_bwd(d, x, w, km)
    again = subm_conv.subm_conv_bwd(d, x, w, km)
    ref = subm_conv.subm_conv_bwd_plain(d.to(torch.bfloat16), x, w, km)
    for a, b, r in zip(got, again, ref):
        assert torch.equal(a, b)
        _close(a, r)


@pytest.mark.parametrize("direction", ["down", "up"])
@pytest.mark.parametrize("level,c", CYL_STRIDED)
def test_cylinder_strided_kernels(cyl_pyr, direction, level, c):
    """The k3 strided pool into `level` and the transposed conv out of it:
    forward, dfeats and dW against their plain versions, twice bit for
    bit, counted as strided / strided_bwd / strided_dw."""
    g = torch.Generator(device="cuda").manual_seed(22)
    fine, coarse = cyl_pyr[1].levels[level - 1], cyl_pyr[1].levels[level]
    src, dst = (fine, coarse) if direction == "down" else (coarse, fine)
    km, km_t = ((coarse.down_kmap, fine.up_kmap) if direction == "down"
                else (fine.up_kmap, coarse.down_kmap))
    x = _feats(src, c, g)
    w = _rand(27, c, c, gen=g).float()
    d = _feats(dst, c, g).float()
    n = dict(cuda_lib.LAUNCHES)
    _close(_twice(updown.strided_conv, x, w, km),
           updown.strided_conv_plain(x, w, km))
    got = updown.strided_conv_bwd(d, x, w, km, km_t)
    again = updown.strided_conv_bwd(d, x, w, km, km_t)
    ref = updown.strided_conv_bwd_plain(d.to(torch.bfloat16), x, w, km,
                                        km_t)
    for a, b, r in zip(got, again, ref):
        assert torch.equal(a, b)
        _close(a, r)
    assert [cuda_lib.LAUNCHES[k] - n[k] for k in (
        "strided", "strided_bwd", "strided_dw")] == [2, 2, 2]


def test_cylinder_scatter_max_and_refinement_gather(cyl_pyr):
    """segment_max on the card equals the CPU's, and its backward repeats
    bit for bit; the refinement gather (K7 over the level-0 p2v table) and
    its backward (K8) against their plain versions, twice bit for bit."""
    from openpcseg_torch.ops.devox import PointGatherFn
    from openpcseg_torch.ops.segment import segment_max
    vb, p = cyl_pyr
    g = torch.Generator(device="cuda").manual_seed(23)
    pts = torch.randn(vb.point_feats.shape[0], 256, device="cuda",
                      generator=g)
    dy = torch.randn(p.levels[0].capacity, 256, device="cuda", generator=g)
    grads = []
    for _ in range(2):
        x = pts.clone().requires_grad_()
        out = segment_max(x, p.point_to_voxel0, p.levels[0].capacity)
        out.backward(dy)
        grads.append(x.grad)
    assert torch.equal(grads[0], grads[1])
    xc = pts.cpu().requires_grad_()
    ref = segment_max(xc, p.point_to_voxel0.cpu(), p.levels[0].capacity)
    ref.backward(dy.cpu())
    assert torch.equal(out.detach().cpu(), ref.detach())
    assert torch.equal(grads[0].cpu(), xc.grad)
    up0e = _feats(p.levels[0], 128, g).float()
    dp = torch.randn(pts.shape[0], 128, device="cuda", generator=g)
    back = []
    for _ in range(2):
        v = up0e.clone().requires_grad_()
        got = PointGatherFn.apply(v, p.p2v[0])
        got.backward(dp)
        back.append(v.grad)
    assert torch.equal(back[0], back[1])
    _close(got, devox.point_gather_plain(up0e, p.p2v[0]))
    _close(back[0], devox.voxel_sum_plain(dp, p.p2v[0]))


# RPVNet's shapes: its range fusion over the range tables of the 8192-point
# scan's fusion batch (64 x 2048 image), K7 over the 4-corner bilinear
# table and K8 over its transpose, K8 over the pixel table and K7 back, at
# (scale, C) of each gate's float32 range map; and the voxel widths the
# mk34 cases never run (the 5-wide stem, 56, 224 -> 448, the 672 = 448 +
# 224 concatenation of up stage 0, 448 up)
RPV_R2P = [(1, 56), (16, 448), (4, 224), (1, 168)]
RPV_SUBM = [(0, 5, 56), (0, 56, 56), (4, 224, 448), (3, 672, 448)]


@pytest.fixture(scope="module")
def rpv_pyr():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import chip_smoke
    task = SegTask(chip_smoke.RPV_CFGS, 20, device="cuda",
                   compute_dtype=torch.bfloat16, voxel_cap_per_scan=8192)
    return task.preprocess(batch_to_device(
        chip_smoke.scan_for(chip_smoke.RPV_CFGS, 0, cap=8192), "cuda"))[1]


@pytest.mark.parametrize("scale,c", RPV_R2P)
def test_rpvnet_range_fusion_kernels(rpv_pyr, scale, c):
    """K7 with K = 4 over a bilinear table and K8 over its transpose; K8
    over the pixel table and K7 back: against their plain versions, twice
    bit for bit, each counted under its own counter; empty pixels and
    padding points get zero rows; sample / scatter_mean and their
    gradients against the direct range_to_point / point_to_range."""
    from openpcseg_torch.ops import range_fusion as rf
    g = torch.Generator(device="cuda").manual_seed(31)
    h, w = 64 // scale, 2048 // scale
    rt = rpv_pyr.range[h, w]
    valid = rpv_pyr.points.valid
    n = valid.shape[0]
    fmap = torch.randn(rt.bilinear.num_voxels, c, device="cuda",
                       generator=g)
    d = torch.where(valid[:, None], torch.randn(n, c, device="cuda",
                                                generator=g), 0.0)
    before = dict(cuda_lib.LAUNCHES)
    bil = rt.bilinear
    got = _twice(devox.devoxelize, fmap, bil.idx, bil.weights, "r2p")
    _close(got, devox.devoxelize_plain(fmap, bil.idx, bil.weights))
    assert (got[~valid] == 0).all()
    back = _twice(devox.devoxelize_bwd, d, bil, "r2p_bwd")
    _close(back, devox.devoxelize_bwd_plain(d, bil))
    s = _twice(devox.voxel_sum, d, rt.pixel, "p2r")
    _close(s, devox.voxel_sum_plain(d, rt.pixel))
    assert (s[rt.pixel.t_ptr.diff() == 0] == 0).all()
    gat = _twice(devox.point_gather, fmap, rt.pixel, "p2r_bwd")
    _close(gat, devox.point_gather_plain(fmap, rt.pixel))
    assert [cuda_lib.LAUNCHES[k] - before[k] for k in (
        "r2p", "r2p_bwd", "p2r", "p2r_bwd")] == [2, 2, 2, 2]
    # the autograd route the model takes: sample's gradient is K8 over the
    # transpose, scatter_mean the pixel sums over their counts
    x = fmap.reshape(1, h, w, c).permute(0, 3, 1, 2).requires_grad_()
    out = rf.sample(x, rt)
    out.backward(d)
    _close(out, got)
    _close(x.grad.permute(0, 2, 3, 1).reshape(-1, c), back)
    _close(rf.scatter_mean(d, rt).permute(0, 2, 3, 1).reshape(-1, c),
           s / rt.pixel.t_ptr.diff().clamp(min=1)[:, None])


@pytest.mark.parametrize("level,cin,cout", RPV_SUBM)
def test_rpvnet_subm_widths(rpv_pyr, level, cin, cout):
    """K1 and K2 (dfeats and dW) at RPVNet's ragged and widest widths."""
    g = torch.Generator(device="cuda").manual_seed(32)
    lv = rpv_pyr.levels[level]
    x = _feats(lv, cin, g)
    w = _rand(27, cin, cout, gen=g).float()
    d = _feats(lv, cout, g).float()
    km = lv.subm_kmap
    _close(_twice(subm_conv.subm_conv, x, w, km),
           subm_conv.subm_conv_plain(x, w, km))
    _bwd_check(subm_conv.subm_conv_bwd, subm_conv.subm_conv_bwd_plain,
               (d, x, w, km))


@pytest.mark.parametrize("level,cin,cout", [(3, 448, 448), (2, 448, 224)])
def test_rpvnet_updown_widths(rpv_pyr, level, cin, cout):
    """K4 / K5 up at 448 wide and K3 / K6 down at 224 (its widest down)."""
    g = torch.Generator(device="cuda").manual_seed(33)
    fine, coarse = rpv_pyr.levels[level], rpv_pyr.levels[level + 1]
    plan = coarse.parity_plan
    x = _feats(coarse, cin, g)
    w = _rand(8, cin, cout, gen=g).float()
    got, again = (updown.up_conv(x, w, fine.up_kmap, plan),
                  updown.up_conv(x, w, fine.up_kmap, plan))
    _parent_check(got, again, updown.up_conv_plain(x, w, fine.up_kmap), plan)
    _bwd_check(updown.up_conv_bwd, updown.up_conv_bwd_plain,
               (_feats(fine, cout, g).float(), x, w, fine.up_kmap,
                coarse.down_kmap))
    dfine, dcoarse = rpv_pyr.levels[3], rpv_pyr.levels[4]
    xd = _feats(dfine, 224, g)
    wd = _rand(8, 224, 224, gen=g).float()
    _close(_twice(updown.down_conv, xd, wd, dcoarse.down_kmap),
           updown.down_conv_plain(xd, wd, dcoarse.down_kmap))
    _bwd_check(updown.down_conv_bwd, updown.down_conv_bwd_plain,
               (_feats(dcoarse, 224, g).float(), xd, wd, dcoarse.down_kmap,
                dfine.up_kmap), (dcoarse.parity_plan,))


@pytest.mark.parametrize("block", ["rpvnet", "salsanext"])
def test_range_pools_backward(block):
    """The pooled range blocks' input gradient on the card against the
    CPU's float64 one, for a channels-last input (as the convs before them
    hand it over): they pool an NCHW-contiguous copy, because avg_pool2d's
    channels-last backward departs from the CPU's on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from openpcseg_torch.models.range_salsanext import SalsaResBlock
    from openpcseg_torch.models.rpvnet import RPVResBlock
    torch.manual_seed(0)
    blk = (RPVResBlock(32, 64) if block == "rpvnet"
           else SalsaResBlock(32, 64)).train()
    blk.p = 0.0
    g = torch.Generator().manual_seed(1)
    x0 = torch.randn(1, 32, 16, 64, generator=g)
    wp = torch.randn(1, 64, 8, 32, generator=g)
    wr = torch.randn(1, 64, 16, 64, generator=g)
    grads = {}
    for dev, dt in (("cuda", torch.float32), ("cpu", torch.float64)):
        torch.backends.cudnn.allow_tf32 = False
        b = blk.to(dev, dt)
        x = x0.to(dev, dt).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        p, r = b(x, None)
        ((p * wp.to(dev, dt)).sum() + (r * wr.to(dev, dt)).sum()).backward()
        grads[dev] = x.grad.double().cpu()
    err = (grads["cuda"] - grads["cpu"]).abs().max()
    assert err <= 1e-4 * grads["cpu"].abs().max(), err


# == Waymo MinkUNet mk34_cr16: the cr 1.6 widths (51-613), where every conv
# takes its kernel's ragged path (Cin or Cout not a multiple of 8), on the
# pyramid of an 8192-point ray-cast Waymo frame at 0.1 m
import chip_smoke  # noqa: E402

W_SUBM, W_DOWNS, W_UPS, W_DEVOX = chip_smoke.mink_shapes(
    chip_smoke.WAYMO_MODEL_CFG)
W_SUBM = W_SUBM + [(0, 3, 51)]          # the _xyz yaml's stem
W_DEVOX = W_DEVOX + [(2, 153)]          # the head's width


@pytest.fixture(scope="module")
def waymo_pyr():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from openpcseg_torch.data.raycast_waymo import frame_batch
    cfgs = dict(chip_smoke.WAYMO_CFGS, TPU={
        "VOXEL_CAP_PER_SCAN": 8192, "VOXEL_CAP_RATIOS": [1.0] * 5})
    task = SegTask(cfgs, 23, device="cuda", compute_dtype=torch.bfloat16)
    _, p = task.preprocess(batch_to_device(frame_batch(0, 8192), "cuda"))
    return p


@pytest.mark.parametrize("level,cin,cout", W_SUBM)
def test_waymo_subm_kernels(waymo_pyr, level, cin, cout):
    """K1, and K2's dfeats and dW, at a cr 1.6 width pair."""
    g = torch.Generator(device="cuda").manual_seed(10)
    lv = waymo_pyr.levels[level]
    x = _feats(lv, cin, g)
    w = _rand(27, cin, cout, gen=g)
    _close(_twice(subm_conv.subm_conv, x, w, lv.subm_kmap),
           subm_conv.subm_conv_plain(x, w, lv.subm_kmap))
    _bwd_check(subm_conv.subm_conv_bwd, subm_conv.subm_conv_bwd_plain,
               (_feats(lv, cout, g).float(), x, w.float(), lv.subm_kmap))


@pytest.mark.parametrize("level,c", W_DOWNS)
def test_waymo_down_kernels(waymo_pyr, level, c):
    """K3, and K6's dfeats and dW, at a cr 1.6 width."""
    g = torch.Generator(device="cuda").manual_seed(11)
    fine, coarse = waymo_pyr.levels[level - 1], waymo_pyr.levels[level]
    x, w = _feats(fine, c, g), _rand(8, c, c, gen=g)
    _close(_twice(updown.down_conv, x, w, coarse.down_kmap),
           updown.down_conv_plain(x, w, coarse.down_kmap))
    _bwd_check(updown.down_conv_bwd, updown.down_conv_bwd_plain,
               (_feats(coarse, c, g).float(), x, w.float(), coarse.down_kmap,
                fine.up_kmap), (coarse.parity_plan,))


@pytest.mark.parametrize("level,cin,cout", W_UPS)
def test_waymo_up_kernels(waymo_pyr, level, cin, cout):
    """K4, and K5's dfeats and dW, at a cr 1.6 width pair."""
    g = torch.Generator(device="cuda").manual_seed(12)
    fine, coarse = waymo_pyr.levels[level], waymo_pyr.levels[level + 1]
    x, w = _feats(coarse, cin, g), _rand(8, cin, cout, gen=g)
    plan = coarse.parity_plan
    got, again = (updown.up_conv(x, w, fine.up_kmap, plan),
                  updown.up_conv(x, w, fine.up_kmap, plan))
    _parent_check(got, again, updown.up_conv_plain(x, w, fine.up_kmap), plan)
    _bwd_check(updown.up_conv_bwd, updown.up_conv_bwd_plain,
               (_feats(fine, cout, g).float(), x, w.float(), fine.up_kmap,
                coarse.down_kmap))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("level,c", W_DEVOX)
def test_waymo_devox_kernels(waymo_pyr, level, c, dtype):
    """K7 and K8 at a cr 1.6 width (one channel a lane)."""
    g = torch.Generator(device="cuda").manual_seed(13)
    t = waymo_pyr.devox[level]
    x = _feats(waymo_pyr.levels[level], c, g).to(dtype)
    _close(_twice(devox.devoxelize, x, t.idx, t.weights),
           devox.devoxelize_plain(x, t.idx, t.weights))
    d = _rand(t.idx.shape[1], c, gen=g).to(dtype)
    _close(_twice(devox.devoxelize_bwd, d, t),
           _devox_bwd(d, t.idx, t.weights, t.num_voxels))
