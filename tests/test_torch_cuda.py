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
