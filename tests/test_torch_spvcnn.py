"""Port parity for SPVCNN: its point-to-voxel tables, mean-voxelize, point
branch and whole train step against the JAX package on the CPU.

A tiny SPVCNN with the widths and caps of tests/test_models_e2e.py
(PLANES [8,8,16,16,16,16,16,8,8], VOXEL_SIZE 0.2, 3072 voxels a scan, cap
ratios [1, 1, .9, .7, .5]) and one stage of 3 blocks (NUM_LAYER
[1,1,3,1,1,1,1,1], so JAX stacks blocks 2..3 in StackedBlocks), the SGD
block of the mk34 yaml, on the synthetic batch of two 2500-point scans,
where JAX's voxel_overflow is 0. The port's seeded weights go to flax's
layout (``torch_to_jax``), their BN leaves are perturbed from a seeded
numpy generator, and both sides load them. Compared:

- the p2v tables of levels 4 and 2: exactly;
- ``segment_count`` / ``segment_mean`` / ``voxelize_mean`` and its
  backward (``jax.vjp``) in float32: within 1e-6, and so the arithmetic
  the card's route runs in their place (K8 over the one-corner table, then
  the division; K7 over it for the backward), in its plain versions;
- in bfloat16, the type of every module output JAX's forward has
  (``capture_intermediates``, mapped to the port's modules by the
  converter's walk), and of the mean-voxelize's input (the float
  scatter-adds of ``jax.make_jaxpr``), for SPVCNN and MinkUNet;
- the eval logits: rtol = atol = 1e-3 (tests/test_torch_minkunet.py);
- three float32 train steps: each loss at rtol 1e-5, every gradient of the
  first at rtol = atol = 1e-4 and the whole gradient within 1e-4 of its
  norm (tests/test_torch_batch.py), the BN running statistics at rtol =
  atol = 1e-5 (tests/test_torch_train.py), the parameters after 3 steps
  at rtol = atol = 1e-4 and their change within 1e-4 of its norm.

Also the converter both ways, the registry and the golden CLI's blocks.
"""
import importlib.util
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_minkunet import _perturb
from test_torch_train import OPTIM, _grad_stash, _named
from test_torch_train_ref import torch_to_jax, variable_shapes
from torch_threads import one_torch_thread  # noqa: F401

from openpcseg_tpu.config import CfgDict
from openpcseg_tpu.engine import SegTask as JaxSegTask
from openpcseg_tpu.engine import TrainState
from openpcseg_tpu.ops import segment as jseg
from openpcseg_tpu.ops.voxelize import voxelize_mean as jx_voxelize_mean
from openpcseg_torch.cli import golden_run
from openpcseg_torch.data.synthetic import synthetic_batch
from openpcseg_torch.engine.task import SegTask, batch_to_device
from openpcseg_torch.models import build_segmentor
from openpcseg_torch.models import spvcnn as tspvcnn
from openpcseg_torch.ops import devox
from openpcseg_torch.ops import segment as tseg
from openpcseg_torch.ops.voxelize import voxelize_mean
from openpcseg_torch.utils import convert
from openpcseg_torch.utils.convert import jax_params_to_torch

B, N_PTS, NUM_CLASS, STEPS = 2, 2500, 20, 3
MODEL = {"NAME": "SPVCNN", "IGNORE_LABEL": 0, "IN_FEATURE_DIM": 4,
         "BLOCK": "ResBlock", "NUM_LAYER": [1, 1, 3, 1, 1, 1, 1, 1],
         "PLANES": [8, 8, 16, 16, 16, 16, 16, 8, 8], "cr": 1.0,
         "DROPOUT_P": 0.0, "LABEL_SMOOTHING": 0.1}
CFGS = {"MODALITY": "fusion",
        "DATA": {"DATASET": "semantickitti", "VOXEL_SIZE": 0.2},
        "MODEL": MODEL, "OPTIM": dict(OPTIM),
        "TPU": {"VOXEL_CAP_PER_SCAN": 3072,
                "VOXEL_CAP_RATIOS": [1.0, 1.0, 0.9, 0.7, 0.5]}}


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


def _jax_task(cfgs=CFGS, dt=jnp.float32):
    return JaxSegTask(CfgDict(cfgs), num_class=NUM_CLASS, batch_per_device=B,
                      iters_per_epoch=2, compute_dtype=dt)


def _port_task(cfgs=CFGS, dt=torch.float32, seed=1):
    return SegTask(cfgs, NUM_CLASS, device="cpu", batch_per_device=B,
                   iters_per_epoch=2, compute_dtype=dt, seed=seed)


@pytest.fixture(scope="module")
def batch():
    return synthetic_batch(0, B, n_points=N_PTS, num_class=NUM_CLASS)


@pytest.fixture(scope="module")
def sides(batch):
    rng = np.random.default_rng(0)
    jtask = _jax_task()
    jtask.tx = optax.chain(_grad_stash(), jtask.tx)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    task = _port_task()
    assert task.caps == jtask.caps
    params, stats = torch_to_jax(task.model, *variable_shapes(jtask, jb),
                                 cfgs=CFGS)
    params, stats = _perturb(params, rng), _perturb(stats, rng)
    jax_params_to_torch(params, stats, task.model)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=jtask.tx.init(params),
                       loss_state=jtask.losses.init_state(NUM_CLASS))

    @jax.jit
    def jax_eval(state, b):
        vb, pyr = jtask.preprocess(b)
        logits = jtask.model.apply(
            {"params": state.params, "batch_stats": state.batch_stats},
            jtask._model_inputs(vb, b), pyr, train=False)
        caps = jnp.asarray(jtask.caps)
        over = (jnp.maximum(vb.num_voxels - jtask.caps[0], 0)
                + jnp.sum(jnp.maximum(pyr.level_counts - caps, 0)))
        return pyr, logits, over

    jpyr, jlogits, jover = jax.device_get(jax_eval(state, jb))
    step = jax.jit(jtask.train_step)
    j = []
    for _ in range(STEPS):
        state, m = step(state, jb, jax.random.PRNGKey(1))
        j.append(dict(jax.device_get(m), grads=jax.device_get(
            state.opt_state[0]), stats=jax.device_get(state.batch_stats),
            params=jax.device_get(state.params)))

    tb = batch_to_device(batch, "cpu")
    _, tpyr, tlogits = task.forward(tb)
    t = []
    for _ in range(STEPS):
        m = task.train_step(tb)
        coef = min(1.0, OPTIM["GRAD_NORM_CLIP"] / (float(m["grad_norm"])
                                                    + 1e-6))
        t.append(dict(m, grads={n: g / coef for n, g in
                                _named(task.model, "grad").items()},
                      stats={n: b.clone().numpy() for n, b in
                             task.model.named_buffers()},
                      params=_named(task.model)))

    def as_torch(i, key):
        """JAX step i's tree `key`, laid out as the port's named tensors."""
        twin = _port_task().model
        tree = j[i][key] if key != "stats" else j[i]["params"]
        jax_params_to_torch(tree, j[i]["stats"], twin)
        if key == "stats":
            return {n: b.numpy() for n, b in twin.named_buffers()}
        return _named(twin)
    return dict(jpyr=jpyr, jlogits=jlogits, jover=jover, tpyr=tpyr,
                tlogits=tlogits, j=j, t=t, as_torch=as_torch,
                variables=(params, stats))


def test_no_overflow_and_p2v_tables_match(sides):
    assert int(sides["jover"]) == 0
    assert all(int(s["voxel_overflow"]) == 0 for s in sides["t"])
    tpyr, jpyr = sides["tpyr"], sides["jpyr"]
    assert sorted(tpyr.p2v) == sorted(jpyr.p2v) == [2, 4]
    for level, jp2v in jpyr.p2v.items():
        tbl = tpyr.p2v[level]
        # one corner a point: N contributors, a grid of V + N / chunk
        assert tuple(tbl.idx.shape) == tuple(tbl.weights.shape) == (
            1, np.asarray(jp2v).shape[0])
        assert tbl.t_point.shape[0] == np.asarray(jp2v).shape[0]
        assert tbl.seg_voxel.shape[0] == tbl.num_voxels + -(
            -np.asarray(jp2v).shape[0] // tbl.chunk)
        np.testing.assert_array_equal(_np(tbl.idx[0]), np.asarray(jp2v))
        np.testing.assert_array_equal(_np(tbl.weights[0]),
                                      (np.asarray(jp2v) >= 0).astype(
                                          np.float32))
        # the transpose's row lengths are JAX's segment_count
        cap = tpyr.levels[level].capacity
        np.testing.assert_array_equal(
            _np(tbl.t_ptr.diff()),
            np.asarray(jseg.segment_count(jnp.asarray(jp2v), cap)))
        assert (np.asarray(jp2v) >= 0).sum() == _np(
            tpyr.points.valid).sum()


def test_segment_count_and_mean_match_jax(rng):
    ids = rng.integers(-1, 14, 500).astype(np.int32)   # -1 and >= 12 drop
    data = rng.normal(size=(500, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tseg.segment_count(torch.as_tensor(ids), 12)),
        np.asarray(jseg.segment_count(jnp.asarray(ids), 12)))
    got, cnt = tseg.segment_mean(torch.as_tensor(data), torch.as_tensor(ids),
                                 12)
    want, wcnt = jseg.segment_mean(jnp.asarray(data), jnp.asarray(ids), 12)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(_np(cnt), np.asarray(wcnt))


@pytest.mark.parametrize("level,c", [(4, 16), (2, 16)])
def test_voxelize_mean_and_its_backward_match_jax(sides, rng, level, c):
    """The port's voxelize_mean (CPU: segment_sum / count, and the gather
    of dy / count) and the card route's arithmetic in plain form (K8's and
    K7's plain versions over the one-corner table) against JAX's
    voxelize_mean and its jax.vjp, float32, within 1e-6."""
    tbl = sides["tpyr"].p2v[level]
    p2v = np.asarray(sides["jpyr"].p2v[level])
    n_vox = tbl.num_voxels
    z = rng.normal(size=(p2v.shape[0], c)).astype(np.float32)
    dy = rng.normal(size=(n_vox, c)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jx_voxelize_mean(x, jnp.asarray(p2v),
                                                   n_vox), jnp.asarray(z))
    (want_dz,) = vjp(jnp.asarray(dy))

    zt = torch.as_tensor(z).requires_grad_()
    got = voxelize_mean(zt, tbl)
    got.backward(torch.as_tensor(dy))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(_np(zt.grad), np.asarray(want_dz), rtol=1e-6,
                               atol=1e-6)

    denom = tbl.t_ptr.diff().clamp(min=1).float()[:, None]
    route = devox.devoxelize_bwd_plain(torch.as_tensor(z), tbl) / denom
    route_dz = devox.devoxelize_plain(torch.as_tensor(dy) / denom, tbl.idx,
                                      tbl.weights)
    np.testing.assert_allclose(_np(route), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(_np(route_dz), np.asarray(want_dz),
                               rtol=1e-6, atol=1e-6)


def _module_pairs(model, params, stats, cfgs):
    """(flax module path, port module name) of every module the
    converter's walk fills, with their parents, outside StackedBlocks."""
    pairs = {}

    class Recorder(convert._Loader):
        def take(self, col, path, stack):
            self.last = (path, stack)
            return super().take(col, path, stack)

        def put(self, t, value):
            path, stack = self.last
            name = self.names[id(t)].rsplit(".", 1)[0]
            if stack is None:
                mod = path[:-1]
                while mod and name:
                    pairs.setdefault(mod, name)
                    mod, name = mod[:-1], name.rpartition(".")[0]
            super().put(t, value)

    saved = convert._Loader
    convert._Loader = Recorder
    try:
        jax_params_to_torch(params, stats, model)
    finally:
        convert._Loader = saved
    return pairs


@pytest.mark.parametrize("name", ["SPVCNN", "MinkUNet"])
def test_bf16_types_match_jax(sides, batch, name):
    """Every module output of the bf16 eval forward has JAX's type, and
    the mean-voxelize reads float32 where JAX's scatter-adds do."""
    cfgs = dict(CFGS, MODEL=dict(MODEL, NAME=name))
    jtask = _jax_task(cfgs, jnp.bfloat16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    task = _port_task(cfgs, torch.bfloat16)
    params, stats = torch_to_jax(task.model, *variable_shapes(jtask, jb),
                                 cfgs=cfgs)
    variables = {"params": params, "batch_stats": stats}

    def fwd(v, b):
        vb, pyr = jtask.preprocess(b)
        return jtask.model.apply(v, vb.voxel_feats, pyr, train=False,
                                 capture_intermediates=True,
                                 mutable=["intermediates"])

    _, inter = jax.eval_shape(fwd, variables, jb)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            inter["intermediates"])[0]:
        keys = tuple(p.key for p in path if hasattr(p, "key"))
        if keys[-1] == "__call__":
            want[keys[:-1]] = str(leaf.dtype)

    got, fed = {}, []
    hooks = [m.register_forward_hook(
        lambda mod, a, out, n=n: got.__setitem__(n, str(out.dtype)
                                                 .replace("torch.", "")))
        for n, m in task.model.named_modules() if n]
    real_mean = tspvcnn.voxelize_mean

    def noting_mean(z, tbl):
        fed.append(str(z.dtype).replace("torch.", ""))
        return real_mean(z, tbl)
    tspvcnn.voxelize_mean = noting_mean
    try:
        logits = task.forward(batch_to_device(batch, "cpu"))[2]
    finally:
        tspvcnn.voxelize_mean = real_mean
        for h in hooks:
            h.remove()
    assert logits.dtype == torch.float32

    pairs = _module_pairs(task.model, params, stats, cfgs)
    compared = [(p, n) for p, n in pairs.items() if p in want and n in got]
    assert len(compared) >= 0.9 * len(pairs), (len(compared), len(pairs))
    for p, n in compared:
        assert got[n] == want[p], ("/".join(p), n, got[n], want[p])
    assert {want[p] for p, _ in compared} == {"bfloat16", "float32"}

    def scatters(v, b):
        vb, pyr = jtask.preprocess(b)
        return jax.make_jaxpr(lambda v, f, pyr: jtask.model.apply(
            v, f, pyr, train=False))(v, vb.voxel_feats, pyr)
    jaxpr = scatters(variables, jb)
    adds = [str(e.invars[2].aval.dtype) for e in jaxpr.eqns
            if e.primitive.name == "scatter-add"
            and jnp.issubdtype(e.invars[2].aval.dtype, jnp.floating)]
    assert fed == adds == (["float32"] * 2 if name == "SPVCNN" else [])


def test_eval_logits_match(sides):
    t, j = _np(sides["tlogits"]), np.asarray(sides["jlogits"])
    assert t.shape == j.shape == (B * 3072, NUM_CLASS)
    assert np.isfinite(t).all() and np.abs(t).max() > 1e-3
    np.testing.assert_allclose(t, j, rtol=1e-3, atol=1e-3)


def test_train_loss_and_gradients_match(sides):
    for jm, tm in zip(sides["j"], sides["t"]):
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
    want, got = sides["as_torch"](0, "grads"), sides["t"][0]["grads"]
    assert set(got) == set(want)
    assert any(n.startswith("point_transforms.") for n in want)
    for n in want:
        assert np.abs(want[n]).max() > 0, n
        np.testing.assert_allclose(got[n], want[n], rtol=1e-4, atol=1e-4,
                                   err_msg=n)
    w = np.concatenate([want[n].ravel() for n in want]).astype(np.float64)
    g = np.concatenate([got[n].ravel() for n in want]).astype(np.float64)
    assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w)


def test_running_statistics_match(sides):
    want, got = sides["as_torch"](0, "stats"), sides["t"][0]["stats"]
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-5, atol=1e-5,
                                   err_msg=n)


def test_parameters_after_three_steps_match(sides):
    """Elementwise at rtol = atol = 1e-4, and the change over the three
    steps within 1e-4 of its norm. The third step's gradients differ by
    7e-5 of their norm here, the first two by 5e-7: a near-tie of two
    errors in the Lovasz sort swaps at step 3 (with CE alone every
    parameter agrees within 1.6e-7 of its scale after 3 steps)."""
    want = sides["as_torch"](STEPS - 1, "params")
    got = sides["t"][-1]["params"]
    twin = _port_task().model
    jax_params_to_torch(*sides["variables"], twin)
    start = _named(twin)
    moved = 0
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-4, atol=1e-4,
                                   err_msg=n)
        moved += bool((want[n] != start[n]).any())
    assert moved == len(want)
    dw = np.concatenate([(want[n] - start[n]).ravel() for n in want])
    dg = np.concatenate([(got[n] - start[n]).ravel() for n in want])
    assert np.linalg.norm(dg - dw) <= 1e-4 * np.linalg.norm(dw)


def test_converter_both_ways(sides):
    """torch_to_jax inverts jax_params_to_torch for SPVCNN; a leaf left
    over or a tensor left unfilled raises."""
    params, stats = sides["variables"]
    model = _port_task(seed=3).model
    jax_params_to_torch(params, stats, model)
    back = torch_to_jax(model, params, stats, cfgs=CFGS)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves((params, stats))):
        np.testing.assert_array_equal(a, np.asarray(b))
    extra = dict(params, Dense_9={"kernel": np.zeros((2, 2))})
    with pytest.raises(ValueError, match="left unused"):
        jax_params_to_torch(extra, stats, _port_task().model)
    short = dict(params)
    del short["PointTransform_2"]
    with pytest.raises(KeyError, match="PointTransform_2"):
        jax_params_to_torch(short, stats, _port_task().model)
    more = _port_task().model
    more.extra = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(ValueError, match="left unfilled: \\['extra'\\]"):
        jax_params_to_torch(params, stats, more)


def test_registry_and_modalities():
    model = build_segmentor(MODEL, NUM_CLASS)
    assert type(model).__name__ == "SPVCNN"
    assert model.geometry_spec()["p2v_levels"] == (4, 2)
    for name, item in (("RPVNet", 13), ("CENet", 14), ("SalsaNext", 14)):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            build_segmentor(dict(MODEL, NAME=name), NUM_CLASS)
    for modality, item in (("range", 14),):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            SegTask(dict(CFGS, MODALITY=modality), NUM_CLASS, device="cpu")
    fan = model.point_transforms[0].linear.weight.shape[1]
    std = float(_port_task().model.point_transforms[0].linear.weight
                .detach().std())
    assert abs(std - math.sqrt(1.0 / fan)) < 0.5 * math.sqrt(1.0 / fan)


def _jax_golden_setup():
    spec = importlib.util.spec_from_file_location(
        "jax_golden_run", golden_run.ROOT / "tools/scripts/golden_run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.model_setup


def _plain(d):
    return {k: _plain(v) if hasattr(v, "items") else v for k, v in d.items()}


@pytest.mark.parametrize("model", ["minkunet", "spvcnn", "cylinder"])
def test_golden_blocks_are_the_jax_scripts(model):
    cfgs, _ = _jax_golden_setup()(model, 1.0)
    assert golden_run.model_setup(1.0, 98304, model) == _plain(cfgs)
    assert golden_run.accept_threshold(model) == {
        "minkunet": 63.48, "spvcnn": 62.27, "cylinder": 82.19}[model]
