"""Port parity for Cylinder3D: the cylindrical partition, the anisotropic
pyramid, the asymmetric and k3 strided convs, the scatter-max and the whole
network and train step against the JAX package on the CPU.

A tiny Cylinder_TS with the sizes of tests/test_models_e2e.py (INIT_SIZE 8,
grid 120 x 90 x 16 over the yaml's cylinder space, 3072 voxels a scan, cap
ratios [1, 1, .9, .7, .5]), the SGD block of the mk34 yaml, on the
synthetic batch of two 2500-point scans, where JAX's voxel_overflow is 0.
The port's seeded weights go to flax's layout (``torch_to_jax``), their BN
leaves and every bias are perturbed from a seeded numpy generator, and both
sides load them. JAX's functions compile once per module (the ``sides``
fixture). Compared:

- ``cylinder_points_batch`` (and on a full-size ray-cast scan at the
  yaml's 480 x 360 x 32 grid): every integer table exactly (cells, voxel
  coords, keys, inverse map, voxel labels), the point features within one
  float32 ulp (XLA's square root on the CPU is not correctly rounded on
  ~2% of the points: rho differs there by an ulp);
- the pyramid with down factors [1, 2, 2, (2,2,1), (2,2,1)] and k3 maps:
  every level's coords, subm, down and up maps, exactly;
- ``subm_subset_indices`` for the six kernel sizes of the model, exactly,
  and each reversed subset is its negation (so the backward's reversed
  map is the transposed map);
- ``build_down_kmap`` / ``build_up_kmap`` at strides (2,2,2) and (2,2,1),
  exactly, and each the other's transpose;
- ``segment_max`` forward and gradient, with forced ties and empty
  segments: within 1e-6;
- the asymmetric submanifold and k3 strided convs (``SubmConvFn``,
  ``StridedConvFn``, plain versions) against JAX's ``window_subm_conv`` /
  ``sparse_conv`` and their ``jax.vjp``, float32: rtol 1e-5, atol 1e-5 of
  each output's largest value;
- in bfloat16, the type of every module output against JAX's
  ``capture_intermediates``;
- the eval logits and point-refine logits: rtol = atol = 1e-3;
- three float32 train steps: each loss at rtol 1e-5, every gradient of the
  first at rtol = atol = 1e-4 and the BN running statistics at rtol = atol
  = 1e-5 (tests/test_torch_spvcnn.py's); each step's whole gradient, the
  parameters after 3 steps and their change within twice JAX's own spread
  under a one-ulp change of its inputs, never looser than SPVCNN's 1e-4
  (the scatter-max's near-ties and the ReLU gates make this network's
  steps move by more than rounding: see ``_bound``);
- the converter both ways, the registry, the golden block.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_minkunet import _perturb
from test_torch_spvcnn import _module_pairs
from test_torch_train import OPTIM, _grad_stash, _named
from test_torch_train_ref import torch_to_jax, variable_shapes
from torch_threads import one_torch_thread  # noqa: F401

from openpcseg_tpu.config import CfgDict
from openpcseg_tpu.core.batch import cylinder_points_batch as jcylinder
from openpcseg_tpu.engine import SegTask as JaxSegTask
from openpcseg_tpu.engine import TrainState
from openpcseg_tpu.ops import kmap as jkmap
from openpcseg_tpu.ops import segment as jseg
from openpcseg_tpu.ops.coords import unique_coords as junique
from openpcseg_tpu.ops.sparse_conv import sparse_conv as jsparse_conv
from openpcseg_tpu.ops.sparse_conv import window_subm_conv
from openpcseg_torch.core.batch import cylinder_points_batch
from openpcseg_torch.data.raycast import raycast_batch
from openpcseg_torch.data.synthetic import synthetic_batch
from openpcseg_torch.engine.task import SegTask, batch_to_device
from openpcseg_torch.models import build_segmentor
from openpcseg_torch.ops import kmap as tkmap
from openpcseg_torch.ops import segment as tseg
from openpcseg_torch.ops.coords import unique_coords
from openpcseg_torch.ops.subm_conv import SubmConvFn
from openpcseg_torch.ops.updown import StridedConvFn
from openpcseg_torch.utils.convert import jax_params_to_torch

B, N_PTS, NUM_CLASS, STEPS = 2, 2500, 20, 3
SPACE = {"CYLINDER_SPACE_MAX": [50, 180, 2],
         "CYLINDER_SPACE_MIN": [0, -180, -4]}
MODEL = {"NAME": "Cylinder_TS", "IGNORE_LABEL": 0, "IN_FEATURE_DIM": 9,
         "INIT_SIZE": 8, "POINT_REFINEMENT": True, "LABEL_SMOOTHING": 0.0,
         "DROPOUT_P": 0.0}
CFGS = {"MODALITY": "cylinder",
        "DATA": dict(SPACE, DATASET="semantickitti",
                     CYLINDER_GRID_SIZE=[120, 90, 16]),
        "MODEL": MODEL, "OPTIM": dict(OPTIM),
        "TPU": {"VOXEL_CAP_PER_SCAN": 3072,
                "VOXEL_CAP_RATIOS": [1.0, 1.0, 0.9, 0.7, 0.5]}}
# every kernel size of the model's asymmetric convs
KERNELS = [(1, 3, 3), (3, 1, 3), (3, 3, 3), (3, 1, 1), (1, 3, 1), (1, 1, 3)]


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


def _leaves(tree):
    return np.concatenate([np.asarray(x).ravel() for x in
                           jax.tree_util.tree_leaves(tree)]).astype(
                               np.float64)


def _spread(run, other, init):
    """How far the steps `other` lie from `run` (from the parameters
    `init`): per step the gradient's distance over its norm, then the
    final parameters' largest elementwise distance, then the distance of
    their change over the steps over its norm."""
    rel = [np.linalg.norm(_leaves(o["grads"]) - _leaves(r["grads"]))
           / np.linalg.norm(_leaves(r["grads"])) for r, o in zip(run, other)]
    p, q = _leaves(run[-1]["params"]), _leaves(other[-1]["params"])
    return rel + [np.abs(q - p).max(),
                  np.linalg.norm(q - p) / np.linalg.norm(p - init)]


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
    # copies: torch_to_jax's leaves are views of the port's tensors, which
    # its train steps update in place
    params, stats = jax.tree_util.tree_map(
        np.array, (_perturb(params, rng), _perturb(stats, rng)))
    jax_params_to_torch(params, stats, task.model)
    # JAX's BN formula on the raw point features, where the port centres
    # it (test_centred_bn_keeps_the_digits_jax_cancels holds the two)
    task.model.point_bns[0].centered = False
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=jtask.tx.init(params),
                       loss_state=jtask.losses.init_state(NUM_CLASS))

    @jax.jit
    def jax_eval(state, b):
        vb, pyr = jtask.preprocess(b)
        out = jtask.model.apply(
            {"params": state.params, "batch_stats": state.batch_stats},
            jtask._model_inputs(vb, b), pyr, train=False)
        caps = jnp.asarray(jtask.caps)
        over = (jnp.maximum(vb.num_voxels - jtask.caps[0], 0)
                + jnp.sum(jnp.maximum(pyr.level_counts - caps, 0)))
        return vb, pyr, out, over

    jvb, jpyr, jout, jover = jax.device_get(jax_eval(state, jb))
    step = jax.jit(jtask.train_step)

    def jax_steps(b):
        s, out = state, []
        for _ in range(STEPS):
            s, m = step(s, b, jax.random.PRNGKey(1))
            out.append(dict(jax.device_get(m), grads=jax.device_get(
                s.opt_state[0]), stats=jax.device_get(s.batch_stats),
                params=jax.device_get(s.params)))
        return out
    j = jax_steps(jb)
    # JAX against itself: the same steps with 5% of the intensities one
    # float32 ulp up, three draws of them: how far float32 rounding alone
    # moves this network's steps (the whole-network tests' bounds)
    spread = []
    for seed in range(3):
        feats = batch["feats"].copy()
        up = np.random.default_rng(seed).random(feats.shape[:2]) < 0.05
        feats[..., 3] = np.where(up, np.nextafter(feats[..., 3],
                                                  np.float32(9)),
                                 feats[..., 3])
        spread.append(_spread(j, jax_steps(dict(jb, feats=jnp.asarray(
            feats))), _leaves(params)))
    spread = np.max(spread, axis=0)

    tb = batch_to_device(batch, "cpu")
    tvb, tpyr = task.preprocess(tb)
    with torch.no_grad():
        task.model.eval()
        tout = task._run_model(tvb, tpyr)
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
    return dict(jvb=jvb, jpyr=jpyr, jout=jout, jover=jover, tvb=tvb,
                tpyr=tpyr, tout=tout, j=j, t=t, as_torch=as_torch,
                variables=(params, stats), spread=spread)


def _flat(tree, names):
    return np.concatenate([tree[n].ravel() for n in names]).astype(
        np.float64)


def _same_partition(t, j):
    """Integer tables exactly; the point features within one ulp."""
    for f in ("voxel_coords", "voxel_valid", "voxel_keys_hi",
              "voxel_keys_lo", "voxel_labels", "inverse_map", "point_labels",
              "point_valid", "point_batch", "num_voxels", "point_grid",
              "voxel_feats"):
        np.testing.assert_array_equal(_np(getattr(t, f)),
                                      np.asarray(getattr(j, f)), err_msg=f)
    np.testing.assert_array_max_ulp(_np(t.point_feats),
                                    np.asarray(j.point_feats), maxulp=1)


def test_cylinder_partition_matches_jax(sides):
    assert int(sides["jover"]) == 0
    assert all(int(s["voxel_overflow"]) == 0 for s in sides["t"])
    _same_partition(sides["tvb"], sides["jvb"])
    assert sides["tvb"].point_feats.shape == (B * N_PTS, 9)


def test_cylinder_partition_of_a_full_scan_matches_jax():
    """A 131,072-point ray-cast scan on the yaml's 480 x 360 x 32 grid: the
    cells of every point and every table exactly (no voxel dropped)."""
    scan = raycast_batch(1, 1, cap=131072)
    kw = dict(space_min=(0, -180, -4), space_max=(50, 180, 2),
              grid_size=(480, 360, 32), voxel_cap=98304,
              num_class=NUM_CLASS)
    j = jax.jit(lambda x, f, l, v: jcylinder(x, f[..., 3:], l, v, **kw))(
        *(jnp.asarray(scan[k]) for k in ("xyz", "feats", "labels", "valid")))
    t = cylinder_points_batch(
        torch.as_tensor(scan["xyz"]), torch.as_tensor(scan["feats"])[..., 3:],
        torch.as_tensor(scan["labels"]), torch.as_tensor(scan["valid"]), **kw)
    assert int(t.num_voxels) <= 98304
    _same_partition(t, j)


def test_pyramid_maps_match_jax(sides):
    tpyr, jpyr = sides["tpyr"], sides["jpyr"]
    np.testing.assert_array_equal(_np(tpyr.level_counts),
                                  np.asarray(jpyr.level_counts))
    for l, (tl, jl) in enumerate(zip(tpyr.levels, jpyr.levels)):
        js = jl.stride
        assert tl.stride == (js if isinstance(js, tuple) else (js,) * 3), l
        for f in ("coords", "valid", "subm_kmap", "down_kmap", "up_kmap"):
            a, b = getattr(tl, f), getattr(jl, f)
            assert (a is None) == (b is None), (l, f)
            if a is not None:
                np.testing.assert_array_equal(_np(a), np.asarray(b),
                                              err_msg=f"L{l} {f}")
        assert tl.parity_plan is None and not tl.up_one_hot
        assert tl.down_kmap is None or tl.down_kmap.shape[0] == 27
    assert [lv.stride for lv in tpyr.levels] == [
        (1, 1, 1), (2, 2, 2), (4, 4, 4), (8, 8, 4), (16, 16, 4)]
    np.testing.assert_array_equal(_np(tpyr.point_to_voxel0),
                                  np.asarray(jpyr.p2v[0]))
    np.testing.assert_array_equal(_np(tpyr.p2v[0].idx[0]),
                                  np.asarray(jpyr.p2v[0]))
    np.testing.assert_array_equal(_np(tpyr.points.coords),
                                  np.asarray(jpyr.points.coords))


@pytest.mark.parametrize("ks", KERNELS)
def test_subm_subset_indices_match_jax(ks):
    got = tkmap.subm_subset_indices(3, ks)
    np.testing.assert_array_equal(got, jkmap.subm_subset_indices(3, ks))
    offs = tkmap.kernel_offsets(3)[got]
    np.testing.assert_array_equal(offs, tkmap.kernel_offsets(ks))
    # the reversed subset is its negation: the backward's reversed map
    np.testing.assert_array_equal(offs[::-1], -offs)
    assert (offs[len(offs) // 2] == 0).all()


def test_subm_subset_is_cached_per_level(sides):
    lvl = sides["tpyr"].levels[1]
    a = lvl.subm_subset((1, 3, 3))
    assert lvl.subm_subset((1, 3, 3)) is a and a.is_contiguous()
    assert lvl.subm_subset((3, 3, 3)) is lvl.subm_kmap
    rows = torch.as_tensor(tkmap.subm_subset_indices(3, (1, 3, 3))).long()
    assert torch.equal(a, lvl.subm_kmap[rows])


def _level_pair(rng, stride, n=600, cap=640):
    """A random fine level and its downsample by `stride`, as tables of
    both packages."""
    xyz = rng.integers(0, 24, (n, 3)).astype(np.int32)
    coords = np.concatenate([rng.integers(0, 2, (n, 1)).astype(np.int32),
                             xyz], axis=1)
    valid = rng.random(n) < 0.9
    fine_t = unique_coords(torch.as_tensor(coords), torch.as_tensor(valid),
                           cap)
    coarse_t = tkmap.build_downsample(fine_t.coords, fine_t.valid, cap,
                                      stride)
    fine_j = junique(jnp.asarray(coords), jnp.asarray(valid), cap)
    coarse_j = jkmap.build_downsample(fine_j.coords, fine_j.valid, cap,
                                      stride=stride)
    for a, b in ((fine_t, fine_j), (coarse_t, coarse_j)):
        np.testing.assert_array_equal(_np(a.coords), np.asarray(b.coords))
    return fine_t, coarse_t, fine_j, coarse_j


@pytest.mark.parametrize("stride", [(2, 2, 2), (2, 2, 1), 2])
def test_strided_maps_match_jax_and_transpose(rng, stride):
    fine_t, coarse_t, fine_j, coarse_j = _level_pair(rng, stride)
    down = tkmap.build_down_kmap(fine_t.keys, coarse_t.coords,
                                 coarse_t.valid, 3, stride)
    up = tkmap.build_up_kmap(coarse_t.keys, fine_t.coords, fine_t.valid, 3,
                             stride)
    np.testing.assert_array_equal(_np(down), np.asarray(jkmap.build_down_kmap(
        fine_j.keys, True, coarse_j.coords, coarse_j.valid, 3, stride)))
    np.testing.assert_array_equal(_np(up), np.asarray(jkmap.build_up_kmap(
        coarse_j.keys, fine_j.coords, fine_j.valid, 3, stride)))
    # the same (offset, coarse, fine) pairs from both sides
    d, u = _np(down), _np(up)
    pd = {(k, c, d[k, c]) for k, c in zip(*np.nonzero(d >= 0))}
    pu = {(k, u[k, f], f) for k, f in zip(*np.nonzero(u >= 0))}
    assert pd == pu and len(pd) > 100


def test_segment_max_and_its_gradient_match_jax(rng):
    """Ties (duplicated rows and equal maxima), empty segments, dropped
    (-1) and out-of-range ids: the max, empties 0, and the gradient split
    evenly over tied rows, as jax.ops.segment_max's."""
    ids = rng.integers(-1, 14, 400).astype(np.int32)   # -1 and >= 12 drop
    ids[ids == 5] = 6                                  # segment 5 empty
    data = rng.normal(size=(400, 6)).astype(np.float32)
    ids[[0, 10, 15]] = 3                               # a three-way tie
    data[[0, 10, 15]] = 9.0
    data[30:40, 2] = 7.0                               # tied maxima in col 2
    dy = rng.normal(size=(12, 6)).astype(np.float32)
    want, vjp = jax.vjp(lambda d: jseg.segment_max(d, jnp.asarray(ids), 12),
                        jnp.asarray(data))
    (want_dd,) = vjp(jnp.asarray(dy))
    x = torch.as_tensor(data).requires_grad_()
    got = tseg.segment_max(x, torch.as_tensor(ids), 12)
    got.backward(torch.as_tensor(dy))
    assert (_np(got)[5] == 0).all()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(_np(x.grad), np.asarray(want_dd), rtol=1e-6,
                               atol=1e-6)
    tied = _np(x.grad)[[0, 10, 15]]
    assert np.allclose(tied, dy[3] / 3)


@pytest.mark.parametrize("ks", [(1, 3, 3), (3, 1, 1), (3, 3, 3)])
def test_asymmetric_subm_conv_matches_jax(sides, rng, ks):
    """SubmConvFn over a level's subset map (CPU: the plain versions)
    against JAX's window_subm_conv and its vjp, float32."""
    lvl = sides["tpyr"].levels[1]
    km = lvl.subm_subset(ks)
    k = km.shape[0]
    valid = _np(lvl.valid)
    x = rng.normal(size=(lvl.capacity, 8)).astype(np.float32) * valid[:, None]
    w = (rng.normal(size=(k, 8, 6)) / np.sqrt(8 * k)).astype(np.float32)
    dy = rng.normal(size=(lvl.capacity, 6)).astype(np.float32)
    dy *= valid[:, None]
    want, vjp = jax.vjp(lambda a, b: window_subm_conv(
        a, b, jnp.asarray(_np(km)), jnp.asarray(valid),
        tkmap.kernel_offsets(ks)), jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))
    xt = torch.as_tensor(x).requires_grad_()
    wt = torch.as_tensor(w).requires_grad_()
    got = torch.where(torch.as_tensor(valid)[:, None],
                      SubmConvFn.apply(xt, wt, km), 0.0)
    got.backward(torch.as_tensor(dy))
    for a, b in ((got, want), (xt.grad, want_dx), (wt.grad, want_dw)):
        b = np.asarray(b)
        np.testing.assert_allclose(_np(a), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("direction", ["down", "up"])
@pytest.mark.parametrize("level", [1, 3])
def test_strided_conv_matches_jax(sides, rng, direction, level):
    """StridedConvFn (CPU: the plain versions) against JAX's sparse_conv
    with center=None and its vjp, float32: the pool into `level` (down,
    over its down map with the fine level's up map as the transpose) or
    the transposed conv out of it (up)."""
    fine, coarse = sides["tpyr"].levels[level - 1], sides["tpyr"].levels[
        level]
    src, dst = (fine, coarse) if direction == "down" else (coarse, fine)
    km, km_t = ((coarse.down_kmap, fine.up_kmap) if direction == "down"
                else (fine.up_kmap, coarse.down_kmap))
    sv, dv = _np(src.valid), _np(dst.valid)
    x = rng.normal(size=(src.capacity, 8)).astype(np.float32) * sv[:, None]
    w = (rng.normal(size=(27, 8, 6)) / np.sqrt(8 * 27)).astype(np.float32)
    dy = rng.normal(size=(dst.capacity, 6)).astype(np.float32) * dv[:, None]
    want, vjp = jax.vjp(lambda a, b: jsparse_conv(
        a, b, jnp.asarray(_np(km)), jnp.asarray(dv),
        kmap_t=jnp.asarray(_np(km_t)), center=None), jnp.asarray(x),
        jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))
    xt = torch.as_tensor(x).requires_grad_()
    wt = torch.as_tensor(w).requires_grad_()
    got = torch.where(torch.as_tensor(dv)[:, None],
                      StridedConvFn.apply(xt, wt, km, km_t), 0.0)
    got.backward(torch.as_tensor(dy))
    assert np.abs(_np(got)).max() > 0
    for a, b in ((got, want), (xt.grad, want_dx), (wt.grad, want_dw)):
        b = np.asarray(b)
        np.testing.assert_allclose(_np(a), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())


def test_bf16_types_match_jax(sides, batch):
    """Every module output of the bf16 eval forward has JAX's type (all
    float32: the point MLP's promoting Dense feeds the network float32)."""
    jtask = _jax_task(CFGS, jnp.bfloat16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    task = _port_task(CFGS, torch.bfloat16)
    params, stats = torch_to_jax(task.model, *variable_shapes(jtask, jb),
                                 cfgs=CFGS)

    def fwd(v, b):
        vb, pyr = jtask.preprocess(b)
        return jtask.model.apply(v, jtask._model_inputs(vb, b), pyr,
                                 train=False, capture_intermediates=True,
                                 mutable=["intermediates"])

    _, inter = jax.eval_shape(fwd, {"params": params, "batch_stats": stats},
                              jb)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            inter["intermediates"])[0]:
        keys = tuple(p.key for p in path if hasattr(p, "key"))
        if keys[-1] == "__call__":
            want[keys[:-1]] = str(leaf.dtype)

    got = {}

    def note(n):
        def hook(mod, a, out):
            out = out[-1] if isinstance(out, tuple) else out
            got[n] = str(out.dtype).replace("torch.", "")
        return hook
    hooks = [m.register_forward_hook(note(n))
             for n, m in task.model.named_modules() if n]
    try:
        vb, pyr = task.preprocess(batch_to_device(batch, "cpu"))
        with torch.no_grad():
            task.model.eval()
            logits, aux = task._run_model(vb, pyr)
    finally:
        for h in hooks:
            h.remove()
    assert logits.dtype == aux["point_refine_logits"].dtype == torch.float32

    pairs = _module_pairs(task.model, params, stats, CFGS)
    compared = [(p, n) for p, n in pairs.items() if p in want and n in got]
    assert len(compared) >= 0.9 * len(pairs), (len(compared), len(pairs))
    for p, n in compared:
        assert got[n] == want[p], ("/".join(p), n, got[n], want[p])
    assert {want[p] for p, _ in compared} == {"float32"}


def test_eval_logits_match(sides):
    t, j = sides["tout"], sides["jout"]
    for a, b, n in ((t[0], j[0], B * 3072),
                    (t[1]["point_refine_logits"],
                     j[1]["point_refine_logits"], B * N_PTS)):
        a, b = _np(a), np.asarray(b)
        assert a.shape == b.shape == (n, NUM_CLASS)
        assert np.isfinite(a).all() and np.abs(a).max() > 1e-3
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)


# The whole-network bounds. The scatter-max sends each voxel's gradient
# to the one point at its maximum (4 of this batch's 82,944 (voxel,
# channel) maxima lie within 1e-5 of the runner-up, 62 within 1e-4), and
# each ReLU / LeakyReLU gate flips with the sign of its input, so float32
# rounding in another order moves a step by far more than its own size,
# and more with each step: JAX against itself, with 5% of the intensities
# one ulp up, moved its gradients by up to 1.5e-4, 1.2e-3 and 4.1e-2 of
# their norm over the three steps. So past the loss (rtol 1e-5) and the BN
# statistics (rtol = atol = 1e-5), the port is held to JAX within twice
# JAX's own spread (``sides["spread"]``, the largest over three draws of
# that change), and never looser than SPVCNN's 1e-4: each step's gradient
# and the parameters after three steps as a whole, and those parameters
# elementwise; the first gradient elementwise keeps SPVCNN's rtol = atol =
# 1e-4.
def _bound(spread):
    return max(1e-4, 2 * spread)


def test_train_loss_and_gradients_match(sides):
    for jm, tm in zip(sides["j"], sides["t"]):
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
    for i in range(STEPS):
        want, got = sides["as_torch"](i, "grads"), sides["t"][i]["grads"]
        assert set(got) == set(want)
        if i == 0:
            for n in want:
                assert np.abs(want[n]).max() > 0, n
                np.testing.assert_allclose(got[n], want[n], rtol=1e-4,
                                           atol=1e-4, err_msg=n)
        w, g = _flat(want, want), _flat(got, want)
        assert sides["spread"][i] < 0.1
        assert np.linalg.norm(g - w) <= _bound(sides["spread"][i]) * (
            np.linalg.norm(w)), i


def test_running_statistics_match(sides):
    want, got = sides["as_torch"](0, "stats"), sides["t"][0]["stats"]
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-5, atol=1e-5,
                                   err_msg=n)


def test_parameters_after_three_steps_match(sides):
    """Every parameter within rtol 1e-4 and an atol of twice JAX's own
    largest move (at least 1e-4); their change over the three steps
    within twice JAX's own spread of it (at least 1e-4 of its norm)."""
    want = sides["as_torch"](STEPS - 1, "params")
    got = sides["t"][-1]["params"]
    twin = _port_task().model
    jax_params_to_torch(*sides["variables"], twin)
    start = _named(twin)
    atol = _bound(sides["spread"][STEPS])
    assert atol < 1e-2
    for n in want:
        assert (want[n] != start[n]).any(), n
        np.testing.assert_allclose(got[n], want[n], rtol=1e-4, atol=atol,
                                   err_msg=n)
    dw = _flat(want, want) - _flat(start, want)
    dg = _flat(got, want) - _flat(start, want)
    assert np.linalg.norm(dg - dw) <= _bound(sides["spread"][STEPS + 1]) * (
        np.linalg.norm(dw))


def test_converter_both_ways(sides):
    """torch_to_jax inverts jax_params_to_torch for Cylinder_TS; a leaf
    left over or a tensor left unfilled raises."""
    params, stats = sides["variables"]
    model = _port_task(seed=3).model
    jax_params_to_torch(params, stats, model)
    back = torch_to_jax(model, params, stats, cfgs=CFGS)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves((params, stats))):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert "bias" in params["SparseConv_0"]
    extra = dict(params, Dense_9={"kernel": np.zeros((2, 2))})
    with pytest.raises(ValueError, match="left unused"):
        jax_params_to_torch(extra, stats, _port_task().model)
    short = dict(params)
    del short["CylUpBlock_3"]
    with pytest.raises(KeyError, match="CylUpBlock_3"):
        jax_params_to_torch(short, stats, _port_task().model)


def test_centred_bn_keeps_the_digits_jax_cancels(rng):
    """MaskedBatchNorm(centered=True), the port's BN of Cylinder3D's raw
    point features: within float32 of JAX's E[x^2] - mean^2 where the
    input is centred, and within float32 of the float64 statistics where
    that formula cancels (a channel like the ray-cast scans' cell-centre
    height: mean 2.096, sd 0.0093), which JAX's formula misses by 1e-4 and
    more."""
    from openpcseg_torch.models.layers import MaskedBatchNorm
    x = rng.normal(size=(8192, 3)).astype(np.float32)
    x[:, 1] = 2.096 + 0.0093 * x[:, 1]
    valid = torch.as_tensor(rng.random(8192) < 0.9)
    xt = torch.as_tensor(x)
    outs = {}
    for centred in (False, True):
        bn = MaskedBatchNorm(3, centered=centred).train()
        outs[centred] = bn(xt, valid)
    x64 = xt.double()[valid]
    exact = (x64 - x64.mean(0)) / torch.sqrt(x64.var(0, unbiased=False)
                                             + 1e-5)
    err = {c: (o[valid].double() - exact).abs().amax(0)
           for c, o in outs.items()}
    assert err[True].max() < 1e-5
    assert err[False][[0, 2]].max() < 1e-5 and err[False][1] > 1e-4
    assert torch.equal(outs[True][~valid], torch.zeros_like(
        outs[True][~valid]))


def test_registry_geometry_and_init():
    model = build_segmentor(MODEL, NUM_CLASS)
    assert type(model).__name__ == "Cylinder_TS"
    spec = model.geometry_spec()
    assert spec["down_factors"] == [1, 2, 2, (2, 2, 1), (2, 2, 1)]
    assert (spec["updown_kernel"], spec["p2v_levels"]) == (3, (0,))
    task = _port_task()
    assert [bn.centered for bn in task.model.point_bns] == [True] + [False] * 3
    assert not task.model.head.bias.any()
    assert task.model.head.weight.shape == (27, 32, NUM_CLASS)
    widths = [c.pool.weight.shape[1:] for c in task.model.downs]
    assert widths == [(16, 16), (32, 32), (64, 64), (128, 128)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        SegTask(CFGS, NUM_CLASS)
