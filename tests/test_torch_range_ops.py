"""The range models' pieces alone against the JAX package on the CPU, on
inputs with no symmetry (seeded normal draws, odd and even sizes):

- flax's "SAME" strided convs (3x3 at stride 2 and (1, 2), on even and odd
  sizes), the dilated and explicitly padded convs, RangeNet's (1, 4)
  transposed conv at stride (1, 2) with the kernel flipped as
  ``utils/convert.py`` flips it, ``pixel_shuffle``, the align-corners
  resize, SalsaNext's AvgPool (3, 2, 1, padding counted) and flax's
  BatchNorm (train: output and running statistics at momentum 0.9 and
  0.99, also on a projected scan's near-constant mask channel; eval):
  within 1e-6 of the output's largest value (the resize and the pool also
  in their gradients);
- ``knn_postprocess`` exactly, with tied ranges forced, empty pixels,
  windows past the image's edges, invalid points, and cutoff on and off;
- each range loss and its gradient (WCE and CE + dice, each with top-k 1
  and 0.5; Lovász; boundary; the whole recipe with and without aux heads):
  values at rtol 1e-5, gradients at rtol 1e-5 and atol 1e-6 of the
  largest;
- the onecycle lr and AdamW against optax over 50 steps, clip included,
  and the onecycle schedule where optax's first phase has no step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn
from torch_threads import one_torch_thread  # noqa: F401

from openpcseg_tpu.config import CfgDict as JaxCfgDict
from openpcseg_tpu.losses import range_losses as jl
from openpcseg_tpu.models.range_cenet import _resize_bilinear
from openpcseg_tpu.models.range_salsanext import pixel_shuffle as jshuffle
from openpcseg_tpu.ops.range_knn import knn_postprocess as jknn
from openpcseg_tpu.optim import build_optimizer as jbuild_optimizer
from openpcseg_torch.data.range_view import synthetic_range_batch
from openpcseg_torch.losses import range_losses as tl
from openpcseg_torch.models.range_cenet import resize_bilinear
from openpcseg_torch.models.range_layers import (BatchNorm2d, Conv2d,
                                                 ConvTranspose2d)
from openpcseg_torch.models.range_salsanext import pixel_shuffle
from openpcseg_torch.ops.range_knn import knn_postprocess
from openpcseg_torch.optim import build_optimizer, cosine_onecycle


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want, tol=1e-6):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("h,w", [(16, 128), (15, 33)])
@pytest.mark.parametrize("kernel,stride,dilation,padding", [
    (3, 2, 1, "SAME"), (3, (1, 2), 1, "SAME"), (1, 2, 1, "SAME"),
    (3, 1, 2, "SAME"), (2, 1, 2, ((1, 1), (1, 1)))])
def test_convs_match_flax(rng, h, w, kernel, stride, dilation, padding):
    x = rng.standard_normal((2, h, w, 5)).astype(np.float32)
    conv = fnn.Conv(7, (kernel, kernel), strides=stride,
                    kernel_dilation=dilation, padding=padding)
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    k = np.asarray(v["params"]["kernel"])
    b = rng.standard_normal(7).astype(np.float32)
    want = conv.apply({"params": {"kernel": k, "bias": b}}, jnp.asarray(x))
    mine = Conv2d(5, 7, kernel, stride, dilation,
                  padding=None if padding == "SAME" else padding)
    with torch.no_grad():
        mine.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()))
        mine.bias.copy_(torch.from_numpy(b))
    _close(_nhwc(mine(_nchw(x))), want)


@pytest.mark.parametrize("w", [64, 33])
def test_transposed_conv_matches_flax(rng, w):
    x = rng.standard_normal((2, 5, w, 6)).astype(np.float32)
    conv = fnn.ConvTranspose(4, (1, 4), strides=(1, 2), padding="SAME")
    v = conv.init(jax.random.PRNGKey(1), jnp.asarray(x))
    k = np.asarray(v["params"]["kernel"])
    b = rng.standard_normal(4).astype(np.float32)
    want = conv.apply({"params": {"kernel": k, "bias": b}}, jnp.asarray(x))
    mine = ConvTranspose2d(6, 4)
    with torch.no_grad():
        mine.weight.copy_(torch.from_numpy(
            k[::-1, ::-1].transpose(2, 3, 0, 1).copy()))
        mine.bias.copy_(torch.from_numpy(b))
    got = _nhwc(mine(_nchw(x)))
    assert got.shape == (2, 5, 2 * w, 4)
    _close(got, want)
    # without the flip the kernel computes another function
    with torch.no_grad():
        mine.weight.copy_(torch.from_numpy(k.transpose(2, 3, 0, 1).copy()))
    assert np.abs(_nhwc(mine(_nchw(x))) - np.asarray(want)).max() > 1e-2


def test_pixel_shuffle_matches_jax(rng):
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    np.testing.assert_array_equal(_nhwc(pixel_shuffle(_nchw(x), 2)),
                                  np.asarray(jshuffle(jnp.asarray(x), 2)))


@pytest.mark.parametrize("src,dst", [((2, 16), (16, 128)), ((5, 9), (16, 33))])
def test_resize_and_its_gradient_match_jax(rng, src, dst):
    x = rng.standard_normal((2, *src, 3)).astype(np.float32)
    g = rng.standard_normal((2, *dst, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: _resize_bilinear(a, *dst), jnp.asarray(x))
    xt = _nchw(x).requires_grad_()
    out = resize_bilinear(xt, *dst)
    out.backward(_nchw(g))
    _close(_nhwc(out), want)
    _close(_nhwc(xt.grad), vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("h,w", [(16, 128), (15, 33)])
def test_avg_pool_and_its_gradient_match_jax(rng, h, w):
    """SalsaNext's pool: JAX's reduce_window sum over 3x3 at stride 2,
    padding 1, divided by 9 (range_salsanext.py:76-84)."""
    x = rng.standard_normal((2, h, w, 4)).astype(np.float32)

    def jpool(a):
        return jax.lax.reduce_window(a, 0.0, jax.lax.add, (1, 3, 3, 1),
                                     (1, 2, 2, 1),
                                     ((0, 0), (1, 1), (1, 1), (0, 0))) / 9.0
    want, vjp = jax.vjp(jpool, jnp.asarray(x))
    g = rng.standard_normal(want.shape).astype(np.float32)
    xt = _nchw(x).requires_grad_()
    out = F.avg_pool2d(xt, 3, 2, 1, count_include_pad=True)
    out.backward(_nchw(g))
    _close(_nhwc(out), want)
    _close(_nhwc(xt.grad), vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("momentum", [0.9, 0.99])
def test_batchnorm_matches_flax(rng, momentum):
    """Train: output and running statistics, on noise and on the channels
    of a projected scan (its mask channel near-constant); eval."""
    scan = synthetic_range_batch(0, 2, h=16, w=128)["scan"]
    for x in (rng.standard_normal((2, 16, 128, 6)).astype(np.float32) * 3
              + 2, scan):
        bn = fnn.BatchNorm(use_running_average=False, momentum=momentum)
        v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
        scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
        bias = rng.standard_normal(6).astype(np.float32)
        stats = {"mean": rng.standard_normal(6).astype(np.float32),
                 "var": rng.uniform(0.5, 2, 6).astype(np.float32)}
        want, mut = bn.apply({"params": {"scale": scale, "bias": bias},
                              "batch_stats": stats}, jnp.asarray(x),
                             mutable=["batch_stats"])
        mine = BatchNorm2d(6, momentum=momentum)
        with torch.no_grad():
            mine.weight.copy_(torch.from_numpy(scale))
            mine.bias.copy_(torch.from_numpy(bias))
            mine.running_mean.copy_(torch.from_numpy(stats["mean"]))
            mine.running_var.copy_(torch.from_numpy(stats["var"]))
        mine.train()
        _close(_nhwc(mine(_nchw(x))), want)
        for k, buf in (("mean", mine.running_mean),
                       ("var", mine.running_var)):
            np.testing.assert_allclose(
                buf.numpy(), np.asarray(mut["batch_stats"][k]), rtol=1e-6,
                atol=1e-7)
        mine.eval()
        ev = fnn.BatchNorm(use_running_average=True).apply(
            {"params": {"scale": scale, "bias": bias},
             "batch_stats": mut["batch_stats"]}, jnp.asarray(x))
        _close(_nhwc(mine(_nchw(x))), ev)


@pytest.mark.parametrize("cutoff", [1.0, 0.0])
def test_knn_matches_jax_exactly_with_ties(rng, cutoff):
    b, h, w, n, nc = 2, 8, 32, 900, 7
    # ranges on a 0.25 m grid: equal distances in most windows
    proj_range = (rng.integers(4, 40, (b, h, w)) * 0.25).astype(np.float32)
    proj_range[rng.random((b, h, w)) < 0.3] = 0.0
    pred = rng.integers(0, nc, (b, h, w)).astype(np.int32)
    p_range = (rng.integers(4, 40, (b, n)) * 0.25).astype(np.float32)
    px = rng.integers(0, w, (b, n)).astype(np.int32)
    py = rng.integers(0, h, (b, n)).astype(np.int32)
    px[:, :40], py[:, :40] = 0, h - 1          # windows past the corner
    valid = rng.random((b, n)) < 0.9
    want = jax.vmap(lambda *a: jknn(*a, num_class=nc, k=5, search=5,
                                    cutoff=cutoff))(
        *map(jnp.asarray, (proj_range, pred, p_range, px, py, valid)))
    got = knn_postprocess(*map(torch.from_numpy, (
        proj_range, pred, p_range, px, py, valid)), num_class=nc, k=5,
        search=5, cutoff=cutoff)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _logits_labels(rng, c=20):
    logits = rng.standard_normal((2, 16, 24, c)).astype(np.float32) * 2
    labels = rng.integers(0, c, (2, 16, 24)).astype(np.int32)
    labels[:, :4] = 0                          # ignored pixels
    return logits, labels


def _loss_pair(jfn, tfn, logits):
    want, g = jax.value_and_grad(jfn)(jnp.asarray(logits))
    x = _nchw(logits).requires_grad_()
    got = tfn(x)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    g = np.asarray(g)
    np.testing.assert_allclose(_nhwc(x.grad), g, rtol=1e-5,
                               atol=1e-6 * np.abs(g).max())


@pytest.mark.parametrize("topk", [1.0, 0.5])
def test_ce_losses_and_gradients_match_jax(rng, topk):
    logits, labels = _logits_labels(rng)
    lt, lj = torch.from_numpy(labels), jnp.asarray(labels)
    _loss_pair(lambda x: jl.wce_image(x, lj, topk),
               lambda x: tl.wce_image(x, lt, topk), logits)
    _loss_pair(lambda x: jl.ce_dice_image(x, lj, topk),
               lambda x: tl.ce_dice_image(x, lt, topk), logits)


def test_lovasz_and_boundary_losses_match_jax(rng):
    logits, labels = _logits_labels(rng)
    logits[0, 8:, :8] = logits[0, 8, 0]        # tied pixels
    lt, lj = torch.from_numpy(labels), jnp.asarray(labels)
    _loss_pair(lambda x: jl.lovasz_image(x, lj),
               lambda x: tl.lovasz_image(x, lt), logits)
    _loss_pair(lambda x: jl.boundary_loss(jax.nn.softmax(x, -1), lj),
               lambda x: tl.boundary_loss(torch.softmax(x, 1), lt), logits)


@pytest.mark.parametrize("kind,n_aux,topk", [("wce", 0, 1.0), ("dice", 3, 1.0),
                                             ("dice", 3, 0.5)])
def test_range_seg_loss_matches_jax(rng, kind, n_aux, topk):
    heads, labels = [], None
    for _ in range(1 + n_aux):
        lg, labels = _logits_labels(np.random.default_rng(len(heads)))
        heads.append(lg)
    kw = dict(loss_kind=kind, top_k_percent=topk)
    lt, lj = torch.from_numpy(labels), jnp.asarray(labels)
    stacked = np.stack(heads)
    want, g = jax.value_and_grad(lambda s: jl.range_seg_loss(
        s[0], list(s[1:]), lj, **kw))(jnp.asarray(stacked))
    xs = [_nchw(h).requires_grad_() for h in heads]
    got = tl.range_seg_loss(xs[0], xs[1:], lt, **kw)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    g = np.asarray(g)
    for i, x in enumerate(xs):
        np.testing.assert_allclose(_nhwc(x.grad), g[i], rtol=1e-5,
                                   atol=1e-6 * np.abs(g).max())


def test_onecycle_and_adamw_match_optax_over_50_steps(rng):
    """The yaml's OPTIM block (AdamW, eps 5e-6, weight decay 0.01, clip
    10, onecycle at LEARNING_RATE 0.0025) over 50 steps of 10 an epoch:
    the lr of each step, and the parameters after each, from the same
    gradients (a third of them above the clip norm)."""
    cfg = {"OPTIMIZER": "adamw", "BETA1": 0.9, "BETA2": 0.999,
           "EPS": 5e-6, "WEIGHT_DECAY": 0.01, "GRAD_NORM_CLIP": 10,
           "LR": 0.02, "LEARNING_RATE": 0.0025, "SCHEDULER": "onecycle",
           "WARMUP_EPOCH": 10}
    tx, jlr = jbuild_optimizer(JaxCfgDict(cfg), 10, 5)
    p0 = rng.standard_normal((3, 40)).astype(np.float32)
    jp, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, tlr = build_optimizer(cfg, [tp], 10, 5)
    assert isinstance(opt, torch.optim.AdamW)
    for step in range(50):
        g = (rng.standard_normal(p0.shape) * (8 if step % 3 else 0.05)
             ).astype(np.float32)
        up, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, up)
        tp.grad = torch.from_numpy(g)
        torch.nn.utils.clip_grad_norm_([tp], cfg["GRAD_NORM_CLIP"])
        np.testing.assert_allclose(tlr(step), float(jlr(step)), rtol=1e-6,
                                   atol=1e-6 * cfg["LEARNING_RATE"])
        for group in opt.param_groups:
            group["lr"] = tlr(step)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=1e-5, atol=1e-6)
    assert tlr(0) == pytest.approx(0.0025 / 25)
    assert tlr(10) == pytest.approx(0.0025)
    assert tlr(50) == pytest.approx(0.0025 / 2500)


def test_onecycle_where_optax_has_no_first_phase():
    """Under 5 steps int(0.2 x total) is 0: optax divides 0 by 0 and gives
    NaN for every step; the port starts at the peak and decays to the end
    value at the last step."""
    want = optax.cosine_onecycle_schedule(4, 0.0025, 0.2, 25.0, 100.0)
    assert np.isnan(float(want(0)))
    lr = cosine_onecycle(4, 0.0025)
    assert lr(0) == pytest.approx(0.0025)
    assert 0.0025 / 2500 < lr(3) < lr(2) < lr(1) < lr(0)
    assert lr(4) == pytest.approx(0.0025 / 2500)
