"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip (inside the fixture) where torch sees no CUDA
device, as on CPU-only machines. On a machine with an H100 and nvcc:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

Shapes come from the port's own pyramid of an 8192-point ray-cast scan;
features are zero on padding rows, as every caller keeps them (the plain
subm version takes the identity centre offset without a gather). Operands
are bf16, both sides sum in float32, so they differ by summation order
only: max|kernel - plain| <= 2e-2 * max|plain|. The backward kernels (K2,
K5, K6 and the shared dW kernel, K8) are checked per output, dfeats and dW
apart, and must repeat bit for bit: none of them uses atomics.
"""
import pytest
import torch

from openpcseg_torch.data.raycast import raycast_batch
from openpcseg_torch.engine.task import SegTask, batch_to_device
from openpcseg_torch.ops import cuda_lib, devox, subm_conv, updown
from openpcseg_torch.ops.voxelize import _devox_bwd

pytestmark = pytest.mark.cuda
TOL = 2e-2


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


@pytest.mark.parametrize("level,cin,cout", [(0, 4, 32), (1, 96, 96),
                                            (3, 384, 256)])
def test_subm_kernel(pyr, level, cin, cout):
    g = torch.Generator(device="cuda").manual_seed(0)
    lv = pyr.levels[level]
    x = _feats(lv, cin, g)
    w = _rand(27, cin, cout, gen=g)
    n = cuda_lib.LAUNCHES["subm"]
    _close(subm_conv.subm_conv(x, w, lv.subm_kmap),
           subm_conv.subm_conv_plain(x, w, lv.subm_kmap))
    assert cuda_lib.LAUNCHES["subm"] == n + 1


@pytest.mark.parametrize("level,c", [(1, 32), (4, 128)])
def test_down_kernel(pyr, level, c):
    g = torch.Generator(device="cuda").manual_seed(1)
    x = _feats(pyr.levels[level - 1], c, g)
    w = _rand(8, c, c, gen=g)
    km = pyr.levels[level].down_kmap
    _close(updown.down_conv(x, w, km), updown.down_conv_plain(x, w, km))


@pytest.mark.parametrize("level,cin,cout", [(3, 256, 256), (0, 96, 96)])
def test_up_kernel(pyr, level, cin, cout):
    g = torch.Generator(device="cuda").manual_seed(2)
    x = _feats(pyr.levels[level + 1], cin, g)
    w = _rand(8, cin, cout, gen=g)
    km = pyr.levels[level].up_kmap
    _close(updown.up_conv(x, w, km), updown.up_conv_plain(x, w, km))


@pytest.mark.parametrize("level,c", [(4, 256), (2, 128)])
def test_devox_kernel(pyr, level, c):
    g = torch.Generator(device="cuda").manual_seed(3)
    t = pyr.devox[level]
    x = _feats(pyr.levels[level], c, g)
    _close(devox.devoxelize(x, t.idx, t.weights),
           devox.devoxelize_plain(x, t.idx, t.weights))


def _bwd_check(kern, plain, args):
    """Each output against the plain version, and bit-identical twice."""
    got, again, ref = kern(*args), kern(*args), plain(*args)
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
    _bwd_check(updown.down_conv_bwd, updown.down_conv_bwd_plain, args)


@pytest.mark.parametrize("level,cin,cout", [(3, 256, 256), (0, 96, 96)])
def test_up_backward_kernels(pyr, level, cin, cout):
    g = torch.Generator(device="cuda").manual_seed(6)
    fine, coarse = pyr.levels[level], pyr.levels[level + 1]
    args = (_feats(fine, cout, g).float(), _feats(coarse, cin, g),
            _rand(8, cin, cout, gen=g).float(), fine.up_kmap,
            coarse.down_kmap)
    _bwd_check(updown.up_conv_bwd, updown.up_conv_bwd_plain, args)


@pytest.mark.parametrize("level,c", [(4, 256), (2, 128)])
def test_devox_backward_kernel(pyr, level, c):
    g = torch.Generator(device="cuda").manual_seed(7)
    t = pyr.devox[level]
    d = _rand(t.idx.shape[1], c, gen=g)
    got, again = devox.devoxelize_bwd(d, t), devox.devoxelize_bwd(d, t)
    _close(got, _devox_bwd(d, t.idx, t.weights, t.num_voxels))
    assert got.dtype == d.dtype and torch.equal(got, again)
