"""Port parity for RPVNet: its range fusion, range blocks, whole network
and train step against the JAX package on the CPU.

A tiny RPVNet (PLANES [8,8,16,16,16,16,16,8,8], NUM_LAYER [1]*8, VOXEL_SIZE
0.2, 3072 voxels a scan, cap ratios [1, 1, .9, .7, .5]) on two 2500-point
ray-cast scans made fusion batches at 16 x 256 (``golden_run.to_fusion``,
the transform of JAX's golden protocol), where JAX's voxel_overflow is 0,
with the SGD block of the mk34 yaml. JAX's ``init_state`` gives the
variables, every BN leaf and bias is perturbed from a seeded numpy
generator, and both sides load them. Dropout is neutralised on both sides:
flax's ``nn.Dropout`` is the identity for the JAX runs (RPVNet's range
blocks hard-code 0.2), the port's range blocks get p = 0 and DROPOUT_P is
0. Compared, float32 both sides:

- ``range_to_point`` / ``point_to_range`` and their vjps (``jax.vjp``)
  within 1e-5 of the largest value, both the port's direct versions and
  the table route the model runs (the plain versions of K7 / K8 over the
  bilinear and pixel tables); the pixel index of every point of a
  131,072-point fusion-view scan equal to JAX's at 64 x 2048, 16 x 512 and
  4 x 128 (float32 truncation in JAX's order);
- each voxel's pxpy (its representative point's) exactly;
- ``RPVResContext``, ``RPVResBlock`` (pooled and not) and ``RPVUpBlock``
  against flax's, eval and train BN: outputs and BN statistics within
  1e-5;
- the eval logits within 1e-4 of their largest value (SPVCNN's tests hold
  1e-3);
- one float32 train step held to JAX's step in float64 (XLA's float32
  step on the CPU is the less accurate side on these mostly empty images,
  as for the range models): the loss at rtol 1e-5, every gradient at
  rtol = atol = 1e-4 and the whole gradient within 1e-4 of its norm, the
  BN running statistics at rtol = atol = 1e-5 (SPVCNN's tolerances);
- in bfloat16, the type of every module output of the eval forward
  against flax's (``capture_intermediates``);
- the converter both ways; the golden protocol's blocks and gate; the
  shipped yamls' widths; SegTask and the two CLIs on a ray-cast tree.
"""
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from test_torch_minkunet import _perturb
from test_torch_train import OPTIM, _grad_stash, _named
from range_parity import no_dropout
from test_torch_train_ref import torch_to_jax
from torch_threads import one_torch_thread  # noqa: F401

from openpcseg_tpu.config import CfgDict
from openpcseg_tpu.engine import SegTask as JaxSegTask
from openpcseg_tpu.engine import TrainState
from openpcseg_tpu.models import rpvnet as jrpv
from openpcseg_tpu.ops import range_fusion as jrf
from openpcseg_torch.cli import golden_run
from openpcseg_torch.data.raycast import raycast_batch
from openpcseg_torch.engine.task import SegTask, batch_to_device
from openpcseg_torch.models import build_segmentor
from openpcseg_torch.models import rpvnet as trpv
from openpcseg_torch.ops import range_fusion as trf
from openpcseg_torch.utils import convert
from openpcseg_torch.utils.convert import jax_params_to_torch

ROOT = Path(__file__).resolve().parents[1]
B, N_PTS, NUM_CLASS, H, W = 2, 2500, 20, 16, 256
MODEL = {"NAME": "RPVNet", "IGNORE_LABEL": 0, "IN_FEATURE_DIM": 5,
         "BLOCK": "ResBlock", "NUM_LAYER": [1] * 8,
         "PLANES": [8, 8, 16, 16, 16, 16, 16, 8, 8], "cr": 1.0,
         "DROPOUT_P": 0.0, "LABEL_SMOOTHING": 0.1}
CFGS = {"MODALITY": "fusion",
        "DATA": {"DATASET": "semantickitti", "VOXEL_SIZE": 0.2},
        "MODEL": MODEL, "OPTIM": dict(OPTIM),
        "TPU": {"VOXEL_CAP_PER_SCAN": 3072,
                "VOXEL_CAP_RATIOS": [1.0, 1.0, 0.9, 0.7, 0.5]}}
YAMLS = ("tools/cfgs/fusion/semantic_kitti/rpvnet_mk34_cr17_5.yaml",
         "tools/cfgs/fusion/semantic_kitti/rpvnet_mk18_cr10.yaml")


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-30))


def fusion_batch(seeds, h=H, w=W, cap=N_PTS):
    """Ray-cast scans as one fusion batch (numpy), each through the golden
    protocol's transform at h x w."""
    scans = [golden_run.to_fusion(raycast_batch(s, 1, cap=cap), s, h, w)
             for s in seeds]
    return {k: np.concatenate([b[k] for b in scans]) for k in scans[0]}


@pytest.fixture(scope="module")
def batch():
    return fusion_batch([0, 1])


def no_flax_dropout(mp):
    mp.setattr(fnn.Dropout, "__call__", lambda self, inputs, *a, **k: inputs)


def _port_task(dt=torch.float32, seed=1, cfgs=CFGS):
    task = SegTask(cfgs, NUM_CLASS, device="cpu", batch_per_device=B,
                   iters_per_epoch=2, compute_dtype=dt, seed=seed)
    no_dropout(task.model)
    return task


@pytest.fixture(scope="module")
def sides(batch):
    rng = np.random.default_rng(0)
    jtask = JaxSegTask(CfgDict(CFGS), num_class=NUM_CLASS,
                       batch_per_device=B, iters_per_epoch=2)
    jtask.tx = optax.chain(_grad_stash(), jtask.tx)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jtask.init_state(jax.random.PRNGKey(0), jb)
    params, stats = jax.device_get((_perturb(state.params, rng),
                                    _perturb(state.batch_stats, rng)))
    state = state.replace(params=params, batch_stats=stats,
                          opt_state=jtask.tx.init(params))

    @jax.jit
    def jax_eval(state, b):
        vb, pyr = jtask.preprocess(b)
        inputs = jtask._model_inputs(vb, b)
        logits = jtask.model.apply(
            {"params": state.params, "batch_stats": state.batch_stats},
            inputs, pyr, train=False)
        caps = jnp.asarray(jtask.caps)
        over = (jnp.maximum(vb.num_voxels - jtask.caps[0], 0)
                + jnp.sum(jnp.maximum(pyr.level_counts - caps, 0)))
        return inputs["pxpy"], logits, over

    jpxpy, jlogits, jover = jax.device_get(jax_eval(state, jb))
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        # the step in float64 (the features and the range image; the
        # pxpy and coordinates stay float32, so the tables are the same)
        no_flax_dropout(mp)
        j64 = JaxSegTask(CfgDict(CFGS), num_class=NUM_CLASS,
                         batch_per_device=B, iters_per_epoch=2,
                         compute_dtype=jnp.float64)
        j64.tx = optax.chain(_grad_stash(), j64.tx)
        p64, s64 = (jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), t)
            for t in (params, stats))
        state64 = TrainState(step=jnp.zeros((), jnp.int32), params=p64,
                             batch_stats=s64, opt_state=j64.tx.init(p64),
                             loss_state=state.loss_state)
        b64 = {k: jnp.asarray(v.astype(np.float64) if k in (
            "feats", "range_image") else v) for k, v in batch.items()}
        new, m = jax.jit(j64.train_step)(state64, b64,
                                         jax.random.PRNGKey(1))
        j = dict(jax.device_get(m), grads=jax.device_get(new.opt_state[0]),
                 stats=jax.device_get(new.batch_stats))

    task = _port_task()
    jax_params_to_torch(params, stats, task.model)
    tb = batch_to_device(batch, "cpu")
    tvb, tpyr, tlogits = task.forward(tb)
    m = task.train_step(tb)
    coef = min(1.0, OPTIM["GRAD_NORM_CLIP"] / (float(m["grad_norm"]) + 1e-6))
    t = dict(m, grads={n: g / coef for n, g in
                       _named(task.model, "grad").items()},
             stats={n: b.clone().numpy() for n, b in
                    task.model.named_buffers()})

    def as_torch(key):
        """JAX's step tree `key`, laid out as the port's named tensors."""
        twin = _port_task().model
        jax_params_to_torch(j["grads"] if key == "grads" else params,
                            j["stats"], twin)
        if key == "stats":
            return {n: b.numpy() for n, b in twin.named_buffers()}
        return _named(twin)
    return dict(jpxpy=jpxpy, jlogits=jlogits, jover=jover, tvb=tvb,
                tpyr=tpyr, tb=tb, tlogits=tlogits, j=j, t=t,
                as_torch=as_torch, variables=(params, stats), jtask=jtask)


# ------------------------------------------------------- range fusion --

@pytest.fixture(scope="module")
def full_scan():
    """One 131,072-point ray-cast scan as the golden protocol's fusion
    batch at 64 x 2048: pxpy of every point, batch 0, all valid."""
    b = fusion_batch([0], 64, 2048, cap=131072)
    pxpy = b["pxpy"][0]
    return pxpy, np.zeros(len(pxpy), np.int32), np.ones(len(pxpy), bool)


def jax_pixel_index(pxpy, bidx, valid, b, h, w):
    """The flat pixel JAX's point_to_range gives each point (jitted), read
    from the ids it hands to its segment_mean."""
    seen = {}

    def capture(data, ids, n):
        seen["ids"] = ids
        return jnp.zeros((n,) + data.shape[1:], data.dtype), None
    saved = jrf.segment_mean
    jrf.segment_mean = capture
    try:
        def f(p, bi, v):
            jrf.point_to_range(jnp.zeros((p.shape[0], 1)), p, bi, v, b, h, w)
            return seen["ids"]
        return np.asarray(jax.jit(f)(jnp.asarray(pxpy), jnp.asarray(bidx),
                                     jnp.asarray(valid)))
    finally:
        jrf.segment_mean = saved


@pytest.mark.parametrize("scale", [1, 4, 16])
def test_pixel_index_equals_jax_at_full_resolution(full_scan, scale):
    """Every point of a fusion-view scan lands in JAX's pixel at 64 x 2048,
    16 x 512 and 4 x 128, though (p + 1) / 2 (W - 1) is an integer up to
    rounding for each; and the float64 order of operations would move
    some at full resolution."""
    pxpy, bidx, valid = full_scan
    h, w = 64 // scale, 2048 // scale
    want = jax_pixel_index(pxpy, bidx, valid, 1, h, w)
    got = _np(trf.pixel_index(torch.as_tensor(pxpy), torch.as_tensor(bidx),
                              torch.as_tensor(valid), h, w))
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 100
    if scale == 1:
        x64 = ((pxpy[:, 0].astype(np.float64) + 1) / 2 * (w - 1)).astype(
            np.int32)
        assert (x64 != want % w).any()


@pytest.mark.parametrize("scale", [1, 4, 16])
def test_bilinear_at_full_resolution_matches_jax(full_scan, rng, scale):
    pxpy, bidx, valid = full_scan
    h, w = 64 // scale, 2048 // scale
    fmap = rng.normal(size=(1, h, w, 4)).astype(np.float32)
    want = jrf.range_to_point(jnp.asarray(fmap), jnp.asarray(pxpy),
                              jnp.asarray(bidx), jnp.asarray(valid))
    tbl = trf.bilinear_table(torch.as_tensor(pxpy), torch.as_tensor(bidx),
                             torch.as_tensor(valid), 1, h, w)
    got = trf.sample(torch.as_tensor(fmap).permute(0, 3, 1, 2),
                     trf.RangeTables((1, h, w), tbl, None))
    assert _rel(_np(got), want) <= 1e-5


def _fusion_inputs(sides, rng, h, w, c=6):
    """A batch's per-voxel pxpy, scan and validity (the port's) with a
    seeded range map [B, h, w, c], point features and their cotangents."""
    pyr = sides["tpyr"]
    pxpy = SegTask.voxel_pxpy(sides["tvb"], sides["tb"])
    n = pxpy.shape[0]
    return dict(pxpy=pxpy, bidx=pyr.points.batch, valid=pyr.points.valid,
                fmap=rng.normal(size=(B, h, w, c)).astype(np.float32),
                pf=rng.normal(size=(n, c)).astype(np.float32),
                dp=rng.normal(size=(n, c)).astype(np.float32),
                dr=rng.normal(size=(B, h, w, c)).astype(np.float32))


@pytest.mark.parametrize("scale", [1, 4, 16])
def test_range_fusion_and_vjps_match_jax(sides, rng, scale):
    """Both directions and their vjps: the direct versions and the table
    route (K7 / K8's plain versions over the tables SegTask built) against
    JAX's, within 1e-5 of the largest value."""
    h, w = H // scale, W // scale
    d = _fusion_inputs(sides, rng, h, w)
    args = [jnp.asarray(_np(d[k])) for k in ("pxpy", "bidx", "valid")]
    r2p, vjp = jax.vjp(lambda f: jrf.range_to_point(f, *args),
                       jnp.asarray(d["fmap"]))
    (want_df,) = vjp(jnp.asarray(d["dp"]))
    p2r, vjp = jax.vjp(lambda p: jrf.point_to_range(p, *args, B, h, w),
                       jnp.asarray(d["pf"]))
    (want_dp,) = vjp(jnp.asarray(d["dr"]))

    tables = sides["tpyr"].range[h, w]
    for route in ("direct", "tables"):
        f = torch.tensor(d["fmap"], requires_grad=True)
        p = torch.tensor(d["pf"], requires_grad=True)
        if route == "direct":
            got_r2p = trf.range_to_point(f, d["pxpy"], d["bidx"], d["valid"])
            got_p2r = trf.point_to_range(p, d["pxpy"], d["bidx"], d["valid"],
                                         B, h, w)
        else:
            got_r2p = trf.sample(f.permute(0, 3, 1, 2), tables)
            got_p2r = trf.scatter_mean(p, tables).permute(0, 2, 3, 1)
        got_r2p.backward(torch.as_tensor(d["dp"]))
        got_p2r.backward(torch.as_tensor(d["dr"]))
        for got, want in ((got_r2p, r2p), (f.grad, want_df),
                          (got_p2r, p2r), (p.grad, want_dp)):
            assert got.shape == want.shape
            assert _rel(_np(got), want) <= 1e-5, route
    # every valid voxel is sampled and lands in a pixel
    assert int((tables.bilinear.idx >= 0).sum()) == 4 * int(d["valid"].sum())
    assert int(tables.pixel.t_ptr[-1]) == int(d["valid"].sum())


def test_voxel_pxpy_and_no_overflow(sides):
    assert int(sides["jover"]) == 0
    assert int(sides["t"]["voxel_overflow"]) == 0
    np.testing.assert_array_equal(
        _np(SegTask.voxel_pxpy(sides["tvb"], sides["tb"])), sides["jpxpy"])
    assert sorted(sides["tpyr"].range) == [(1, 16), (4, 64), (16, 256)]


# -------------------------------------------------------- range blocks --

def _conv_bn_pairs(kind, tm):
    """The port block's (conv, BN) pairs in flax's creation order."""
    if kind == "context":
        return [(tm.conv1, None), (tm.conv2, tm.bn1), (tm.conv3, tm.bn2)]
    if kind == "up":
        return [(tm.conv, tm.bn)]
    return [(tm.conv1, None), (tm.conv2, tm.bn)]


def _block_pair(kind, rng):
    """A flax block and the port's with the same perturbed variables, and
    their inputs (NHWC for flax)."""
    c = 8
    x = rng.normal(size=(2, 8, 16, 4 if kind != "up" else 16)).astype(
        np.float32)
    extra = ()
    if kind == "context":
        jm, tm = jrpv.RPVResContext(c), trpv.ResContextBlock(4, c)
    elif kind in ("res", "res_nopool"):
        jm = jrpv.RPVResBlock(c, pooling=kind == "res")
        tm = trpv.RPVResBlock(4, c, pooling=kind == "res")
    else:
        skip = rng.normal(size=(2, 16, 32, 6)).astype(np.float32)
        extra = (skip,)
        jm, tm = jrpv.RPVUpBlock(c), trpv.RPVUpBlock(16, 6, c)
    v = jm.init({"params": jax.random.PRNGKey(0),
                 "dropout": jax.random.PRNGKey(1)}, jnp.asarray(x),
                *map(jnp.asarray, extra), train=False)
    v = jax.device_get({"params": _perturb(v["params"], rng),
                        "batch_stats": _perturb(v["batch_stats"], rng)})
    ld = convert._Loader(v["params"], v["batch_stats"], tm)
    ld.convs_bns(_conv_bn_pairs(kind, tm))
    convert._check(ld)
    tm.p = 0.0
    return jm, tm, v, x, extra


def _nhwc(t):
    return _np(t.permute(0, 2, 3, 1))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kind", ["context", "res", "res_nopool", "up"])
def test_range_blocks_match_flax(rng, kind, train):
    jm, tm, v, x, extra = _block_pair(kind, rng)
    with pytest.MonkeyPatch.context() as mp:
        no_flax_dropout(mp)
        out, upd = jm.apply(v, jnp.asarray(x), *map(jnp.asarray, extra),
                            train=train, mutable=["batch_stats"])
    tm.train(train)
    tx = [torch.as_tensor(a).permute(0, 3, 1, 2) for a in (x, *extra)]
    if kind == "context":
        got = (tm(*tx),)
    elif kind == "up":
        got = (tm(*tx, None),)
    else:
        got = tm(*tx, None)
    want = out if isinstance(out, tuple) else (out,)
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        assert _rel(_nhwc(g), w_) <= 1e-5
    if train:
        # the running statistics: the port's after its step against a
        # twin loaded with flax's updated ones
        _, twin, _, _, _ = _block_pair(kind, np.random.default_rng(0))
        ld = convert._Loader(v["params"], upd["batch_stats"], twin)
        ld.convs_bns(_conv_bn_pairs(kind, twin))
        want = dict(twin.named_buffers())
        for n, b in tm.named_buffers():
            np.testing.assert_allclose(_np(b), _np(want[n]), rtol=1e-5,
                                       atol=1e-5, err_msg=n)


def test_range_dropout_stays_on_in_training():
    """The range blocks drop at 0.2 while training whatever DROPOUT_P
    says, from the generator they are given; never in eval."""
    tm = trpv.RPVResBlock(4, 8, pooling=False).train()
    x = torch.randn(1, 4, 8, 16, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    out, skip = tm(x, gen)
    dropped = (out == 0) & (skip != 0)
    assert 0.1 < float(dropped.float().mean()) < 0.3
    kept = out != 0
    torch.testing.assert_close(out[kept], skip[kept] / 0.8)
    tm.eval()
    out, skip = tm(x, None)
    assert torch.equal(out, skip)


# --------------------------------------------------------- the network --

def test_eval_logits_match(sides):
    t, j = _np(sides["tlogits"]), np.asarray(sides["jlogits"])
    assert t.shape == j.shape == (B * 3072, NUM_CLASS)
    assert np.isfinite(t).all() and np.abs(t).max() > 1e-3
    assert _rel(t, j) <= 1e-4


def test_train_step_matches(sides):
    """The port's float32 step against JAX's step in float64: on these
    images (most pixels empty, so near-constant channels under the range
    BNs) XLA's float32 step on the CPU lands up to 0.11 of a tensor's
    scale from its float64 one (point_transforms.0.linear.weight), the
    port's 9e-5 (tests/range_parity.py holds the range models alike)."""
    jm, tm = sides["j"], sides["t"]
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    want, got = sides["as_torch"]("grads"), tm["grads"]
    assert set(got) == set(want)
    for prefix in ("point_transforms.", "range_stem.", "range_downs.",
                   "range_ups."):
        assert any(n.startswith(prefix) for n in want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-4, atol=1e-4,
                                   err_msg=n)
    w = np.concatenate([want[n].ravel() for n in want]).astype(np.float64)
    g = np.concatenate([got[n].ravel() for n in want]).astype(np.float64)
    assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w)
    want = sides["as_torch"]("stats")
    assert set(tm["stats"]) == set(want)
    for n in want:
        np.testing.assert_allclose(tm["stats"][n], want[n], rtol=1e-5,
                                   atol=1e-5, err_msg=n)


def test_bf16_types_match_jax(sides, batch):
    """In bfloat16 every module output has flax's type: the voxel branch
    bf16, the range branch, the point MLPs and the gates float32."""
    jtask = JaxSegTask(CfgDict(CFGS), num_class=NUM_CLASS,
                       batch_per_device=B, iters_per_epoch=2,
                       compute_dtype=jnp.bfloat16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = dict(zip(("params", "batch_stats"), sides["variables"]))

    def fwd(v, b):
        vb, pyr = jtask.preprocess(b)
        return jtask.model.apply(v, jtask._model_inputs(vb, b), pyr,
                                 train=False, capture_intermediates=True,
                                 mutable=["intermediates"])
    _, inter = jax.eval_shape(fwd, variables, jb)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            inter["intermediates"])[0]:
        keys = tuple(p.key for p in path if hasattr(p, "key"))
        if keys[-1] == "__call__" and len(keys) == 2:
            want[keys[0]] = str(leaf.dtype)

    task = _port_task(torch.bfloat16)
    jax_params_to_torch(*sides["variables"], task.model)
    got = {}
    names = {"stem": "BasicConvBlock", "range_stem": "RPVResContext",
             "point_transforms": "PointTransform",
             "range_downs": "RPVResBlock", "range_ups": "RPVUpBlock",
             "up_bns": "MaskedBatchNorm", "ups": "SparseConv"}
    hooks = []
    for attr, cls in names.items():
        for i, m in enumerate(getattr(task.model, attr)):
            def note(mod, a, out, key=f"{cls}_{i}"):
                out = out[0] if isinstance(out, tuple) else out
                got[key] = str(out.dtype).replace("torch.", "")
            hooks.append(m.register_forward_hook(note))
    try:
        logits = task.forward(batch_to_device(batch, "cpu"))[2]
    finally:
        for h in hooks:
            h.remove()
    assert logits.dtype == torch.float32
    assert len(got) == 2 + 3 + 4 + 5 + 4 + 4 + 4
    for key, dt in got.items():
        assert want[key] == dt, (key, dt, want[key])
    assert {got["BasicConvBlock_0"], got["RPVResBlock_0"],
            got["PointTransform_0"]} == {"bfloat16", "float32"}


def test_converter_both_ways(sides):
    """torch_to_jax inverts jax_params_to_torch for RPVNet (the range
    convs' HWIO kernels and BN statistics included); a leaf left over or
    a missing module raises."""
    params, stats = sides["variables"]
    model = _port_task(seed=3).model
    jax_params_to_torch(params, stats, model)
    back = torch_to_jax(model, params, stats, cfgs=CFGS)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves((params, stats))):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert params["RPVResBlock_2"]["Conv_1"]["kernel"].shape == (3, 3, 16, 16)
    extra = dict(params, RPVUpBlock_9={"Conv_0": {"kernel": np.zeros(2)}})
    with pytest.raises(ValueError, match="left unused"):
        jax_params_to_torch(extra, stats, _port_task().model)
    short = dict(params)
    del short["RPVResContext_1"]
    with pytest.raises(KeyError, match="RPVResContext_1"):
        jax_params_to_torch(short, stats, _port_task().model)


@pytest.mark.parametrize("yaml", YAMLS)
def test_shipped_yaml_widths_match_jax(yaml):
    """The shipped yamls as they stand build the port's RPVNet with JAX's
    tensor sizes (mk34 cr 1.75: widths 56-448)."""
    from openpcseg_torch.config import CfgDict as TCfgDict
    from openpcseg_torch.config import cfg_from_yaml_file
    ycfg = TCfgDict()
    cfg_from_yaml_file(str(ROOT / yaml), ycfg)
    cfgs = dict(ycfg, TPU=dict(ycfg.TPU, VOXEL_CAP_PER_SCAN=2048),
                DATA=dict(ycfg.DATA, RANGE_H=16, RANGE_W=64))
    b = fusion_batch([0], 16, 64, cap=1024)
    jtask = JaxSegTask(CfgDict(cfgs), num_class=NUM_CLASS,
                       batch_per_device=1)
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def init(b):
        vb, pyr = jtask.preprocess(b)
        key = jax.random.PRNGKey(0)
        return jtask.model.init({"params": key, "dropout": key},
                                jtask._model_inputs(vb, b), pyr, train=False)
    shapes = jax.eval_shape(init, jb)["params"]
    jsizes = sorted(int(np.prod(x.shape))
                    for x in jax.tree_util.tree_leaves(shapes))
    task = SegTask(cfgs, NUM_CLASS, device="cpu")
    assert type(task.model).__name__ == "RPVNet" and task.fusion_input
    # JAX stacks blocks 2.. of a stage of 3 or more: compare the totals
    assert sum(p.numel() for p in task.model.parameters()) == sum(jsizes)
    if "cr17_5" in yaml:
        assert [m.conv2.out_channels for m in task.model.range_downs] == [
            56, 112, 224, 448, 448]


def _jax_golden_setup():
    spec = importlib.util.spec_from_file_location(
        "jax_golden_run", ROOT / "tools/scripts/golden_run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.model_setup


def _plain(d):
    return {k: _plain(v) if hasattr(v, "items") else v for k, v in d.items()}


def test_golden_protocol_is_the_jax_scripts():
    """The golden run's RPVNet block (mk18 at cr 1.0) and its fusion
    transform are JAX golden_run.py's; the gate is the port's file's."""
    cfgs, to_fusion = _jax_golden_setup()("rpvnet", 1.0)
    assert golden_run.model_setup(1.0, 98304, "rpvnet") == _plain(cfgs)
    scan = raycast_batch(3, 1, cap=4096)
    want = to_fusion(scan, 3)
    got = golden_run.to_fusion(scan, 3)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert golden_run.accept_threshold("rpvnet") == 64.33
    assert golden_run.gate_source("rpvnet") == golden_run.GATES
    assert golden_run.accept_threshold("spvcnn") == 62.27


def test_gate_file_rederives_from_jax_runs():
    """golden_gates.json's RPVNet threshold by golden_summary.py's rule,
    written out here: per run the mean of its last 3 evals (2 decimals),
    then the lower mean less max(5, twice the half-range)."""
    gates = json.loads(golden_run.GATES.read_text())["models"]["rpvnet"]
    means = []
    for f in gates["runs"]:
        curve = json.loads((ROOT / f).read_text())["val_miou_curve"]
        means.append(round(float(np.mean([v for _, v in curve[-3:]])), 2))
    half = (max(means) - min(means)) / 2
    assert means == gates["tail_means"] == [73.63, 69.33]
    assert round(half, 2) == gates["half_range"]
    assert round(min(means) - max(5.0, 2 * half), 2) == gates[
        "accept_threshold"] == 64.33
    summary = json.loads((ROOT / golden_run.SUMMARY).read_text())
    assert "rpvnet" not in summary["models"]


def test_registry():
    model = build_segmentor(MODEL, NUM_CLASS)
    assert type(model).__name__ == "RPVNet" and model.INPUT_MODE == "fusion"
    assert model.geometry_spec()["p2v_levels"] == (4, 2)


# ---------------------------------------------------------- entry points --

def test_cli_train_resume_infer_on_a_tree(tmp_path):
    """The mk34_cr17_5 yaml through the train CLI (fusion view) for an
    epoch, a resumed second, and the infer CLI's dump, on the CPU: narrow
    (cr 0.25, one block a stage) at a 16 x 256 image."""
    from mini_trees import make_mini_kitti

    from openpcseg_tpu.data.semantickitti_meta import LEARNING_MAP_INV_LUT
    from openpcseg_torch.cli import infer, train

    root = tmp_path / "sequences"
    make_mini_kitti(root, seqs=("00",), scans_per_seq=2, n_pts=2000, seed=3)
    make_mini_kitti(root, seqs=("08",), scans_per_seq=1, n_pts=2000, seed=4)
    logs, preds = tmp_path / "logs", tmp_path / "preds"

    def argv(*extra, sets=()):
        return ["--cfg_file", str(ROOT / YAMLS[0]), "--extra_tag", "r",
                "--log_dir", str(logs), "--batch_size", "2", "--workers",
                "1", "--device", "cpu", "--log_interval", "1", *extra,
                "--set", "DATA.DATA_PATH", str(root),
                "TPU.POINT_CAP_PER_SCAN", "4096",
                "TPU.VOXEL_CAP_PER_SCAN", "4096",
                "TPU.VOXEL_CAP_RATIOS", "[1.0,1.0,1.0,1.0,1.0]",
                "MODEL.NUM_LAYER", "[1,1,1,1,1,1,1,1]", "MODEL.cr", "0.25",
                "DATA.RANGE_H", "16", "DATA.RANGE_W", "256", *sets]
    for epochs in (1, 2):
        assert train.main(argv("--epochs", str(epochs))) == 0
    exp = next(logs.glob("**/ckp")).parent
    text = "".join(p.read_text() for p in sorted(exp.glob("log_*.txt")))
    assert "resumed from epoch 0" in text
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").open()]
    steps = [r for r in recs if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["voxel_overflow"] == 0
               for r in steps)
    assert infer.main(argv("--save_pred", "--save_raw_ids",
                           sets=["DATA.OUTPUT_DIR", str(preds)])) == 0
    labels = sorted(preds.glob("sequences/08/predictions/*.label"))
    assert len(labels) == 1
    raw = np.fromfile(labels[0], dtype=np.uint32)
    assert len(raw) == 2000
    assert set(np.unique(raw).tolist()) <= set(
        np.asarray(LEARNING_MAP_INV_LUT).tolist())
