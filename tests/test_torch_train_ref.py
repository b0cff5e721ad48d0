"""Where ``chip_smoke.TRAIN_REF`` and ``TRAIN_REF_LOSS_MEAN`` (MinkUNet) and
``SPV_TRAIN_REF`` and ``SPV_TRAIN_REF_LOSS_MEAN`` (SPVCNN) come from: JAX's
own bf16 train step against its float32 one, on each draw of
``chip_smoke.train_ref_draws`` (RPVNet: of ``rpv_train_ref_draws``, the
same scan as a fusion batch, with dropout off on both sides, since the
card's and the CPU's generators draw different masks).

The training-reference phase of chip_smoke.py holds one train step of the
port on the card (bf16, kernels) against the port on the CPU (float32,
plain versions): relative loss difference, cosine of the whole gradient,
worst cosine of a conv weight's gradient. It does so on the 8192-point
ray-cast scan and on copies of it whose features differ by a relative
1e-3, because one input gives one draw of bf16's rounding: ten draws,
held over the draws to JAX's reading of the same thing
(``chip_smoke.JAX_TRAIN_READING``, ``JAX_SPV_TRAIN_READING``; the mean
loss difference within twice JAX's, each draw's cosines within 0.02 of
JAX's): the same config (chip_smoke.TRAIN_CFGS or SPV_TRAIN_CFGS, cap
8192) and the same weights (numpy's, from
``chip_smoke.seed_weights``, carried into flax's layout by inverting
jax_params_to_torch), one jitted ``SegTask.train_step`` in bfloat16 and
one in float32 on the CPU. ``chip_smoke.TRAIN_REF_INPUTS`` (and
``SPV_TRAIN_REF_INPUTS``) is the digest of those draws and weights, which
chip_smoke checks on the card.

Taking that reading compiles JAX's full-width train step twice a model
(about a minute each on the CPU), so it is a ``slow`` test:

    JAX_PLATFORMS=cpu python -m pytest -m slow -s tests/test_torch_train_ref.py

prints the readings, which ``chip_smoke.JAX_TRAIN_READING`` and
``JAX_SPV_TRAIN_READING`` record, and the port's own readings on the CPU
(its plain versions in bf16 against float32: the card's reading without
the kernels), which ``chip_smoke.PORT_CPU_BF16_READING`` and
``PORT_CPU_SPV_BF16_READING`` record and which are held to the card's
rule. The fast tests hold the rule to JAX's record.
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


def torch_to_jax(model, params, batch_stats, cfgs=chip_smoke.TRAIN_CFGS,
                 num_class=chip_smoke.NUM_CLASS):
    """The flax variables (numpy trees shaped as params / batch_stats, whose
    leaves need only a shape and a dtype) that jax_params_to_torch would
    turn into `model`'s tensors (a port MinkUNet, SPVCNN or RPVNet built
    from `cfgs` for `num_class` classes): its walk is recorded once, then
    each put is undone (a reshape, a Dense kernel's transpose, a 2-D conv
    kernel's OIHW back to HWIO)."""
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
    twin = SegTask(cfgs, num_class, device="cpu",
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
        if path[-1] == "kernel" and (path[-2] == "classifier"
                                     or path[-2].startswith("Dense")):
            v = v.T
        elif path[-1] == "kernel" and path[-2].startswith("ConvTranspose"):
            v = v.transpose(2, 3, 0, 1)[::-1, ::-1]   # [Cin, Cout, kh, kw]
        elif path[-1] == "kernel" and path[-2].startswith("Conv"):
            v = v.transpose(2, 3, 1, 0)               # OIHW -> HWIO
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


# model -> (its chip_smoke config, digest, JAX reading, port CPU bf16
# reading, the rule's loss mean bound and cosine rows)
MODELS = {
    "minkunet": (chip_smoke.TRAIN_CFGS, chip_smoke.TRAIN_REF_INPUTS,
                 chip_smoke.JAX_TRAIN_READING,
                 chip_smoke.PORT_CPU_BF16_READING,
                 chip_smoke.TRAIN_REF_LOSS_MEAN, chip_smoke.TRAIN_REF),
    "spvcnn": (chip_smoke.SPV_TRAIN_CFGS, chip_smoke.SPV_TRAIN_REF_INPUTS,
               chip_smoke.JAX_SPV_TRAIN_READING,
               chip_smoke.PORT_CPU_SPV_BF16_READING,
               chip_smoke.SPV_TRAIN_REF_LOSS_MEAN, chip_smoke.SPV_TRAIN_REF),
    "cylinder": (chip_smoke.CYL_TRAIN_CFGS, chip_smoke.CYL_TRAIN_REF_INPUTS,
                 chip_smoke.JAX_CYL_TRAIN_READING,
                 chip_smoke.PORT_CPU_CYL_BF16_READING,
                 chip_smoke.CYL_TRAIN_REF_LOSS_MEAN,
                 chip_smoke.CYL_TRAIN_REF),
    "rpvnet": (chip_smoke.RPV_TRAIN_CFGS, chip_smoke.RPV_TRAIN_REF_INPUTS,
               chip_smoke.JAX_RPV_TRAIN_READING,
               chip_smoke.PORT_CPU_RPV_BF16_READING,
               *chip_smoke.train_ref_rule(chip_smoke.JAX_RPV_TRAIN_READING)),
    "bottleneck": (chip_smoke.BN_TRAIN_CFGS, chip_smoke.BN_TRAIN_REF_INPUTS,
                   chip_smoke.JAX_BN_TRAIN_READING,
                   chip_smoke.PORT_CPU_BN_BF16_READING,
                   *chip_smoke.train_ref_bounds("Bottleneck")[:2]),
}


def model_draws(model):
    """The numpy draws of `model`'s training reference."""
    if model == "rpvnet":
        return chip_smoke.rpv_train_ref_draws()
    return chip_smoke.train_ref_draws()


def _jax_task(dt, cfgs=chip_smoke.TRAIN_CFGS):
    return JaxSegTask(CfgDict(cfgs),
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


def _port(cfgs):
    task = SegTask(cfgs, chip_smoke.NUM_CLASS, device="cpu",
                   voxel_cap_per_scan=8192, seed=chip_smoke.SEED)
    chip_smoke.seed_weights(task.model, chip_smoke.SEED)
    return task


def _variables(port, draws, cfgs):
    """A port task's seeded weights as flax variables."""
    jb = {k: jnp.asarray(v) for k, v in draws[0].items()}
    return torch_to_jax(port.model, *variable_shapes(
        _jax_task(jnp.float32, cfgs), jb), cfgs=cfgs)


@pytest.fixture(scope="module")
def port():
    return _port(chip_smoke.TRAIN_CFGS)


@pytest.fixture(scope="module")
def draws():
    return chip_smoke.train_ref_draws()


@pytest.fixture(scope="module")
def variables(port, draws):
    """The port's seeded weights as flax variables."""
    return _variables(port, draws, chip_smoke.TRAIN_CFGS)


def test_torch_to_jax_inverts_the_converter(port, variables):
    """The flax variables built from the port's weights load back into a
    fresh model as exactly those weights."""
    twin = SegTask(chip_smoke.TRAIN_CFGS, chip_smoke.NUM_CLASS, device="cpu",
                   voxel_cap_per_scan=8192, seed=chip_smoke.SEED + 1).model
    jax_params_to_torch(*variables, twin)
    want = port.model.state_dict()
    for n, t in twin.state_dict().items():
        assert torch.equal(t, want[n]), n


@pytest.mark.parametrize("model", sorted(MODELS))
def test_train_ref_inputs_are_the_recorded_ones(draws, model):
    """The draws and weights here are those chip_smoke checks on the card
    before it holds its reading to JAX's: numpy draws both, so they do
    not depend on the machine's torch."""
    cfgs, digest = MODELS[model][:2]
    got = draws if model != "rpvnet" else model_draws(model)
    assert chip_smoke.inputs_digest(got, _port(cfgs).model) == digest


def test_train_ref_is_jax_bf16_against_f32():
    """The card's rule comes from JAX's recorded reading on the 10 draws of
    each model, uniformly: the mean loss difference at most twice JAX's
    mean, and per draw the cosines 0.02 below JAX's on that draw (the
    Bottleneck: each draw above the floor, the mean cosines 0.02 below
    JAX's means; chip_smoke.TRAIN_REF_MEAN_RULE says why). The
    floor TRAIN_GROSS comes from the spread of JAX's MinkUNet draws (their
    lowest cosines less 0.02); every row of both models lies above it, and
    JAX's own reading within every row and the floor."""
    assert chip_smoke.TRAIN_REF_DRAWS == 10
    assert chip_smoke.TRAIN_REF_MARGIN == 0.02
    mink = chip_smoke.JAX_TRAIN_READING
    gross = chip_smoke.TRAIN_GROSS
    assert gross == pytest.approx((0.03, min(r[1] for r in mink) - 0.02,
                                   min(r[2] for r in mink) - 0.02), abs=1e-12)
    assert gross[1:] == pytest.approx((0.943664, 0.822825), abs=1e-9)
    assert chip_smoke.TRAIN_REF_LOSS_MEAN == pytest.approx(3.76230e-4,
                                                           rel=1e-5)
    for name, (_, _, reading, port_cpu, loss_mean, ref) in MODELS.items():
        assert len(reading) == len(ref) == len(port_cpu) == 10
        assert loss_mean == pytest.approx(
            2 * np.mean([r[0] for r in reading]), rel=1e-12)
        # each model's own floor; MinkUNet's is TRAIN_GROSS, SPVCNN's lies
        # above it, Cylinder3D's and the Bottleneck's below (JAX's own
        # worst conv cosines 0.8184 and 0.3956)
        mean_rule = name == "bottleneck"
        # the Bottleneck's floor: JAX's lowest cosines less the widest gap
        # between JAX's and the port's CPU bf16 readings of one draw
        margin = ([max(abs(j[k] - p[k]) for j, p in zip(reading, port_cpu))
                   for k in (1, 2)] if mean_rule else [0.02, 0.02])
        floor = (chip_smoke.train_ref_bounds("Bottleneck")[2] if mean_rule
                 else chip_smoke.train_ref_floor(reading))
        assert floor == pytest.approx((0.03, min(r[1] for r in reading)
                                       - margin[0], min(r[2] for r in reading)
                                       - margin[1]), abs=1e-12)
        if name not in ("cylinder", "bottleneck"):
            assert floor[1] >= gross[1] and floor[2] >= gross[2]
        for (rel, cos_all, cos_conv), row in zip(reading, ref):
            assert row == pytest.approx(
                floor[1:] if mean_rule else (cos_all - 0.02, cos_conv - 0.02),
                abs=1e-12)
            assert rel <= floor[0] and row[0] >= floor[1]
            assert row[1] >= floor[2]
        # the port's plain versions in bf16 (no kernel) meet the rule the
        # card is held to
        assert np.mean([r[0] for r in port_cpu]) <= loss_mean
        for (rel, cos_all, cos_conv), row in zip(port_cpu, ref):
            assert rel <= floor[0] and cos_all >= row[0] and cos_conv >= row[1]
        if mean_rule:
            bounds = chip_smoke.train_ref_bounds("Bottleneck")[3]
            for readings in (reading, port_cpu):
                assert np.mean([r[1] for r in readings]) >= bounds[0]
                assert np.mean([r[2] for r in readings]) >= bounds[1]
    assert [round(r[1], 4) for r in chip_smoke.TRAIN_REF] == [
        0.8429, 0.8435, 0.846, 0.8578, 0.876, 0.846, 0.8371, 0.8228, 0.8631,
        0.8602]


@pytest.mark.slow
@pytest.mark.parametrize("model", sorted(MODELS))
def test_jax_train_reading_is_recorded(model, monkeypatch):
    """JAX's bf16 train step against its float32 one from the port's
    weights, on each draw, equals chip_smoke.JAX_TRAIN_READING (MinkUNet),
    JAX_SPV_TRAIN_READING (SPVCNN), JAX_CYL_TRAIN_READING or
    JAX_RPV_TRAIN_READING (dropout off: flax's nn.Dropout the identity)."""
    from flax import linen as fnn
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, *a, **k: inputs)
    cfgs, _, recorded = MODELS[model][:3]
    draws = model_draws(model)
    variables = _variables(_port(cfgs), draws, cfgs)
    twin = SegTask(cfgs, chip_smoke.NUM_CLASS, device="cpu",
                   voxel_cap_per_scan=8192).model
    convs = [n + ".weight" for n, mod in twin.named_modules()
             if isinstance(mod, (SparseConv, torch.nn.Conv2d))]
    jdraws = [{k: jnp.asarray(v) for k, v in d.items()} for d in draws]
    loss, grads = {}, {}
    for tag, dt in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        task = _jax_task(dt, cfgs)
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
        print(f"{model} JAX bf16 vs f32, draw {i}: loss rel {r[0]:.4e}, "
              f"whole-gradient cosine {r[1]:.6f}, worst conv cosine "
              f"{r[2]:.6f}")
    for r, want in zip(got, recorded, strict=True):
        assert r[0] == pytest.approx(want[0], rel=0.01)
        assert r[1:] == pytest.approx(want[1:], abs=2e-5)


@pytest.mark.slow
@pytest.mark.parametrize("model", sorted(MODELS))
def test_port_bf16_reading_on_the_draws(model):
    """The port's plain versions on the CPU in bf16 against float32 on each
    draw, the card's reading without the kernels, equal
    chip_smoke.PORT_CPU_BF16_READING (or PORT_CPU_SPV_BF16_READING) and are
    held to the card's rule: the mean loss difference within the model's
    loss mean bound, each draw within TRAIN_GROSS and its cosines within
    their row."""
    from openpcseg_torch.engine.task import batch_to_device

    cfgs, _, _, recorded, loss_mean, rows = MODELS[model]
    got = []
    for d in model_draws(model):
        loss, grads = {}, {}
        for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            t = SegTask(cfgs, chip_smoke.NUM_CLASS,
                        device="cpu", compute_dtype=dt,
                        voxel_cap_per_scan=8192, seed=chip_smoke.SEED,
                        iters_per_epoch=chip_smoke.ITERS_PER_EPOCH)
            chip_smoke.seed_weights(t.model, chip_smoke.SEED)
            chip_smoke.no_dropout(t.model)
            loss[tag] = float(t.train_step(batch_to_device(d, "cpu"))["loss"])
            grads[tag] = {n: p.grad.double().reshape(-1)
                          for n, p in t.model.named_parameters()}
        convs = [n + ".weight" for n, mod in t.model.named_modules()
                 if isinstance(mod, (SparseConv, torch.nn.Conv2d))]
        got.append(_reading(loss, grads, convs))
    for i, (rel, cos_all, cos_conv) in enumerate(got):
        print(f"{model} port CPU bf16 vs f32, draw {i}: loss rel "
              f"{rel:.4e}, whole-gradient cosine {cos_all:.6f} (row "
              f"{rows[i][0]:.4f}), worst conv cosine {cos_conv:.6f} (row "
              f"{rows[i][1]:.4f})")
    mean = float(np.mean([r[0] for r in got]))
    print(f"{model} port CPU bf16 vs f32: mean loss rel {mean:.4e} (bound "
          f"{loss_mean:.4e})")
    for r, want in zip(got, recorded, strict=True):
        assert r[0] == pytest.approx(want[0], rel=0.01)
        assert r[1:] == pytest.approx(want[1:], abs=2e-5)
    assert mean <= loss_mean
    for (rel, cos_all, cos_conv), row in zip(got, rows, strict=True):
        assert rel <= 0.03
        assert cos_all >= row[0] and cos_conv >= row[1]
    if model == "bottleneck":
        bounds = chip_smoke.train_ref_bounds("Bottleneck")[3]
        assert np.mean([r[1] for r in got]) >= bounds[0]
        assert np.mean([r[2] for r in got]) >= bounds[1]


def test_tf32_bounds_are_twice_the_emulation():
    """The card's range training references and RPVNet's training
    reference take their TF32 allowance from the CPU emulation
    (openpcseg_torch.cli.range_tf32 --train): twice its loss rel and
    update rel, twice its cosines' distance from 1; RPVNet's widened rule
    still holds the port's own CPU bf16 reading."""
    for name, (rel, ca, cw, upd) in chip_smoke.RANGE_TF32_TRAIN.items():
        assert chip_smoke.range_train_bounds(name) == pytest.approx(
            (2 * rel, 1 - 2 * (1 - ca), 1 - 2 * (1 - cw), 2 * upd))
        assert 0 < rel < 1e-3 and 0.9 < cw <= ca < 1 and 0 < upd < 1
    reading = chip_smoke.JAX_RPV_TRAIN_READING
    loss_mean, rows = chip_smoke.train_ref_rule(reading)
    floor = chip_smoke.train_ref_floor(reading)
    wide = chip_smoke.tf32_widened(loss_mean, rows, floor,
                                   chip_smoke.RPV_TF32_READING)
    rel, ca, cc = chip_smoke.RPV_TF32_READING
    assert wide[0] == pytest.approx(loss_mean + 2 * rel)
    for (a, c), (wa, wc) in zip(rows, wide[1]):
        assert wa == pytest.approx(a - 2 * (1 - ca))
        assert wc == pytest.approx(c - 2 * (1 - cc))
    assert wide[2] == pytest.approx((floor[0] + 2 * rel,
                                     floor[1] - 2 * (1 - ca),
                                     floor[2] - 2 * (1 - cc)))
    port = chip_smoke.PORT_CPU_RPV_BF16_READING
    assert np.mean([r[0] for r in port]) <= wide[0]
    for (r, a, c), (wa, wc) in zip(port, wide[1]):
        assert r <= wide[2][0] and a >= wa and c >= wc
