"""Where ``chip_smoke.TRAIN_REF`` comes from: JAX's own bf16 train step
against its float32 one, on each draw of ``chip_smoke.train_ref_draws``.

The training-reference phase of chip_smoke.py holds one train step of the
port on the card (bf16, kernels) against the port on the CPU (float32,
plain versions): relative loss difference, cosine of the whole gradient,
worst cosine of a conv weight's gradient. It does so on the 8192-point
ray-cast scan and on copies of it whose features differ by a relative
1e-3, because one input gives one draw of bf16's rounding. Each draw is
held to JAX's reading of the same thing on that draw
(``chip_smoke.JAX_TRAIN_READING``): the same config
(chip_smoke.TRAIN_CFGS, cap 8192) and the same weights (numpy's, from
``chip_smoke.seed_weights``, carried into flax's layout by inverting
jax_params_to_torch), one jitted ``SegTask.train_step`` in bfloat16 and
one in float32 on the CPU. ``chip_smoke.TRAIN_REF_INPUTS`` is the digest
of those draws and weights, which chip_smoke checks on the card.

Taking that reading compiles JAX's full-width train step twice (about a
minute each on the CPU), so it is a ``slow`` test:

    JAX_PLATFORMS=cpu python -m pytest -m slow -s tests/test_torch_train_ref.py

prints the reading, which ``chip_smoke.JAX_TRAIN_READING`` records, and
beside it the port's own reading on the CPU (its plain versions in bf16
against float32: the card's reading without the kernels). The fast tests
hold TRAIN_REF to that record.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train import _grad_stash
from torch_threads import one_torch_thread  # noqa: F401

import chip_smoke
from openpcseg_tpu.config import CfgDict
from openpcseg_tpu.engine import SegTask as JaxSegTask
from openpcseg_tpu.engine import TrainState
from openpcseg_torch.engine.task import SegTask
from openpcseg_torch.models.layers import SparseConv
from openpcseg_torch.utils import convert
from openpcseg_torch.utils.convert import jax_params_to_torch


def torch_to_jax(model, params, batch_stats, cfgs=chip_smoke.TRAIN_CFGS):
    """The flax variables (numpy trees shaped as params / batch_stats, whose
    leaves need only a shape and a dtype) that jax_params_to_torch would
    turn into `model`'s tensors (a port MinkUNet built from `cfgs`): its
    walk is recorded once, then each put is undone (a reshape, or the
    classifier's transpose)."""
    log = []

    class Recorder(convert._Loader):
        def take(self, col, path, stack):
            self.last = ((col,) + path, stack)
            return super().take(col, path, stack)

        def put(self, t, value):
            log.append((self.last, t))
            super().put(t, value)

    def zeros(tree):
        return jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype),
                                      tree)

    trees = {"params": zeros(params), "batch_stats": zeros(batch_stats)}
    twin = SegTask(cfgs, chip_smoke.NUM_CLASS, device="cpu",
                   voxel_cap_per_scan=8192).model
    saved = convert._Loader
    convert._Loader = Recorder
    try:
        jax_params_to_torch(trees["params"], trees["batch_stats"], twin)
    finally:
        convert._Loader = saved
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    names = {id(t): n for n, t in list(twin.named_parameters())
             + list(twin.named_buffers())}
    for ((col, *path), stack), t in log:
        leaf = trees[col]
        for p in path[:-1]:
            leaf = leaf[p]
        v = tensors[names[id(t)]].detach().numpy()
        if path[-2:] == ["classifier", "kernel"]:
            v = v.T
        if stack is None:
            leaf[path[-1]] = v.reshape(leaf[path[-1]].shape)
        else:
            leaf[path[-1]][stack] = v.reshape(leaf[path[-1]][stack].shape)
    return trees["params"], trees["batch_stats"]


def variable_shapes(task, jb):
    """The shapes of the JAX model's variables, traced without a compile."""
    key = jax.random.PRNGKey(0)

    def init(b):
        vb, pyr = task.preprocess(b)
        return task.model.init({"params": key, "dropout": key},
                               task._model_inputs(vb, b), pyr, train=False)
    shapes = jax.eval_shape(init, jb)
    return shapes["params"], shapes["batch_stats"]


def _jax_task(dt):
    return JaxSegTask(CfgDict(chip_smoke.TRAIN_CFGS),
                      num_class=chip_smoke.NUM_CLASS, batch_per_device=1,
                      iters_per_epoch=chip_smoke.ITERS_PER_EPOCH,
                      compute_dtype=dt, voxel_cap_per_scan=8192)


def _cos(a, b):
    return float(a @ b / (a.norm() * b.norm()))


def _reading(loss, grads, convs):
    """(loss rel, whole-gradient cosine, worst conv cosine) of a bf16 run
    against a float32 one, from their losses and named flat gradients."""
    g, r = grads["bf16"], grads["f32"]
    return (abs(loss["bf16"] - loss["f32"]) / abs(loss["f32"]),
            _cos(torch.cat([g[n] for n in r]), torch.cat(list(r.values()))),
            min(_cos(g[n], r[n]) for n in convs))


@pytest.fixture(scope="module")
def port():
    task = SegTask(chip_smoke.TRAIN_CFGS, chip_smoke.NUM_CLASS, device="cpu",
                   voxel_cap_per_scan=8192, seed=chip_smoke.SEED)
    chip_smoke.seed_weights(task.model, chip_smoke.SEED)
    return task


@pytest.fixture(scope="module")
def draws():
    return chip_smoke.train_ref_draws()


@pytest.fixture(scope="module")
def variables(port, draws):
    """The port's seeded weights as flax variables."""
    jb = {k: jnp.asarray(v) for k, v in draws[0].items()}
    return torch_to_jax(port.model, *variable_shapes(_jax_task(jnp.float32),
                                                     jb))


def test_torch_to_jax_inverts_the_converter(port, variables):
    """The flax variables built from the port's weights load back into a
    fresh model as exactly those weights."""
    twin = SegTask(chip_smoke.TRAIN_CFGS, chip_smoke.NUM_CLASS, device="cpu",
                   voxel_cap_per_scan=8192, seed=chip_smoke.SEED + 1).model
    jax_params_to_torch(*variables, twin)
    want = port.model.state_dict()
    for n, t in twin.state_dict().items():
        assert torch.equal(t, want[n]), n


def test_train_ref_inputs_are_the_recorded_ones(port, draws):
    """The draws and weights here are those chip_smoke checks on the card
    before it holds its reading to JAX's: numpy draws both, so they do
    not depend on the machine's torch."""
    assert chip_smoke.inputs_digest(draws, port.model) == (
        chip_smoke.TRAIN_REF_INPUTS)


def test_train_ref_is_jax_bf16_against_f32():
    """Each row of TRAIN_REF is JAX's recorded reading on its draw: 3x the
    loss difference, 0.02 below each cosine, nowhere looser than
    TRAIN_GROSS: the cosines of all three draws lie within 0.02 of
    TRAIN_GROSS's, so their rows keep TRAIN_GROSS's cosines."""
    reading, ref = chip_smoke.JAX_TRAIN_READING, chip_smoke.TRAIN_REF
    assert len(reading) == len(ref) == chip_smoke.TRAIN_REF_DRAWS
    gross = (0.03, 0.95, 0.85)
    assert chip_smoke.TRAIN_GROSS == gross
    for (rel, cos_all, cos_conv), row in zip(reading, ref):
        assert row[0] == pytest.approx(min(3 * rel, gross[0]), rel=1e-12)
        assert row[1] == pytest.approx(max(cos_all - 0.02, gross[1]))
        assert row[2] == pytest.approx(max(cos_conv - 0.02, gross[2]))
    want = ((1.20669e-3, 0.95, 0.85), (6.9054e-4, 0.95, 0.85),
            (2.36616e-4, 0.95, 0.85))
    for row, w in zip(ref, want, strict=True):
        assert row == pytest.approx(w)


@pytest.mark.slow
def test_jax_train_reading_is_recorded(port, draws, variables):
    """JAX's bf16 train step against its float32 one from the port's
    weights, on each draw, equals chip_smoke.JAX_TRAIN_READING."""
    twin = SegTask(chip_smoke.TRAIN_CFGS, chip_smoke.NUM_CLASS, device="cpu",
                   voxel_cap_per_scan=8192).model
    convs = [n + ".weight" for n, mod in twin.named_modules()
             if isinstance(mod, SparseConv)]
    jdraws = [{k: jnp.asarray(v) for k, v in d.items()} for d in draws]
    loss, grads = {}, {}
    for tag, dt in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        task = _jax_task(dt)
        task.tx = optax.chain(_grad_stash(), task.tx)
        state = TrainState(step=jnp.zeros((), jnp.int32),
                           params=variables[0], batch_stats=variables[1],
                           opt_state=task.tx.init(variables[0]),
                           loss_state=task.losses.init_state(
                               chip_smoke.NUM_CLASS))
        step = jax.jit(task.train_step)
        for i, jb in enumerate(jdraws):
            new, m = step(state, jb, jax.random.PRNGKey(1))
            loss[tag, i] = float(m["loss"])
            jax_params_to_torch(jax.device_get(new.opt_state[0]),
                                variables[1], twin)
            grads[tag, i] = {n: p.detach().double().reshape(-1).clone()
                             for n, p in twin.named_parameters()}
    got = [_reading({k: loss[k, i] for k in ("bf16", "f32")},
                    {k: grads[k, i] for k in ("bf16", "f32")}, convs)
           for i in range(len(draws))]
    for i, r in enumerate(got):
        print(f"JAX bf16 vs f32, draw {i}: loss rel {r[0]:.4e}, "
              f"whole-gradient cosine {r[1]:.6f}, worst conv cosine "
              f"{r[2]:.6f}")
    for r, want in zip(got, chip_smoke.JAX_TRAIN_READING, strict=True):
        assert r[0] == pytest.approx(want[0], rel=0.01)
        assert r[1:] == pytest.approx(want[1:], abs=2e-5)


@pytest.mark.slow
def test_port_bf16_reading_on_the_draws(draws):
    """The port's plain versions on the CPU in bf16 against float32 on each
    draw: the card's reading without the kernels. The cosines are held to
    TRAIN_REF and the loss difference to TRAIN_GROSS, with its TRAIN_REF
    bound printed beside it: a miss there is a fault chip_smoke reports,
    not one that fails it."""
    from openpcseg_torch.engine.task import batch_to_device

    got = []
    for d in draws:
        loss, grads = {}, {}
        for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            t = SegTask(chip_smoke.TRAIN_CFGS, chip_smoke.NUM_CLASS,
                        device="cpu", compute_dtype=dt,
                        voxel_cap_per_scan=8192, seed=chip_smoke.SEED,
                        iters_per_epoch=chip_smoke.ITERS_PER_EPOCH)
            chip_smoke.seed_weights(t.model, chip_smoke.SEED)
            loss[tag] = float(t.train_step(batch_to_device(d, "cpu"))["loss"])
            grads[tag] = {n: p.grad.double().reshape(-1)
                          for n, p in t.model.named_parameters()}
        convs = [n + ".weight" for n, mod in t.model.named_modules()
                 if isinstance(mod, SparseConv)]
        got.append(_reading(loss, grads, convs))
    for i, (rel, cos_all, cos_conv) in enumerate(got):
        print(f"port CPU bf16 vs f32, draw {i}: loss rel {rel:.4e} (TRAIN_REF "
              f"{chip_smoke.TRAIN_REF[i][0]:.4e}), whole-gradient cosine "
              f"{cos_all:.6f}, worst conv cosine {cos_conv:.6f}")
    for (rel, cos_all, cos_conv), ref in zip(got, chip_smoke.TRAIN_REF,
                                             strict=True):
        assert rel <= chip_smoke.TRAIN_GROSS[0]
        assert cos_all >= ref[1] and cos_conv >= ref[2]
