"""Shared set-up of the resume-parity tests (tests/test_torch_jax_ckpt_
<case>.py): a JAX training run carried into the port through
``tools/scripts/jax_ckpt_to_torch.py``, then one more step on each side.

JAX's ``SegTask`` takes two steps from seeded variables (numpy's draws
into flax's shapes, ``init_variables``, BN leaves perturbed) on the
8192-point ray-cast scan; the state is saved with orbax as the JAX ``Trainer``
saves it (``{"state", "epoch"}`` under ``ckp/0/default``), converted as
the script's ``convert`` does (the typed restore, ``opt_moments``,
``jax_state_to_torch``) and written as a ``.pt``, which the port's
``Trainer`` restores (``--ckp``) on a mini SemanticKITTI tree of two
train scans, so that both sides run two steps an epoch (``resume``). Then
both take step 3 on the same scan and are held to:

- the step's lr: rtol 1e-6 (optax evaluates the schedule in float32, the
  port in float64; tests/test_torch_optim_zoo.py);
- the loss: rtol 1e-5;
- every parameter, BN statistic and optimizer buffer after the step,
  against JAX's own step 3 (compiled as its users compile it): max|diff|
  <= 1e-4 max|ref| per tensor (``held="jax"``: sgd_fc, adam with CE
  alone, the CENet's adamw; sgd in tests/test_torch_jax_ckpt_sgd.py).
  JAX's buffers are found in its optax state by type and laid out for
  the port by ``jax_params_to_torch``'s walk of each moment as a params
  tree (``jax_buffers``), not through ``jax_state_to_torch``;
- the step counts, the epoch and (EQLv2) the loss state, at rtol 1e-5.

Where the two frameworks' float32 gradients of step 3 differ by more
than that, the buffers (``held="jax_params"``: EQLv2) or the buffers and
the parameters (``held="port_grad"``: adam and adam_onecycle with the
yaml's CE + Lovász loss) are held at the same bound to optax's update of
JAX's carried state by the port's own step-3 gradient (laid out for flax
by ``to_flax``): what the checkpoint carries, held apart from how the two
gradients differ. At the states these runs reach a few tensors of the up
stages are set by float32 rounding alone: JAX's own step compiled at
XLA's backend optimisation level 0 lies up to 2.9e-2 of a gradient's
scale from its default compilation (EQLv2's run; 6.7e-3 in sgd_fc's),
and the port's EQLv2 momentum lies 1.37e-4 of ups.3.weight's scale from
JAX's. Under adam_onecycle JAX's own step moves Adam's moments by up to
3.7e-4 of a tensor's scale when 5% of the intensities go one float32 ulp
up, with CE alone too; with Lovász, whose sort orders near-tied errors
either way, its first moments differ by up to 3.2e-3 of a tensor's scale
(up_bns.2.bias) and Adam's division by each moment's root mean square
carries that into the parameters (4.6e-4 of ups.2.weight's scale).
Adam with CE alone meets the first bound (tests/test_torch_jax_ckpt_
adam_ce.py).

The narrow MinkUNet is the mk34_cr10 yaml's with one block a stage, cr
0.25 and dropout 0, float32 on both sides. The narrow CENet (adamw) runs
in float64 on both sides (the checkpoint itself is the port's float32, as
every converted one), as tests/range_parity.py says why (XLA's float32
step on these mostly empty images lies 1e-3 of a tensor's scale from the
exact one). Under ``port_grad`` JAX's MinkUNet step is compiled at XLA's
backend optimisation level 0 (FAST_COMPILE), a third faster to compile.
"""
from __future__ import annotations

import argparse
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch
from flax import linen as fnn
from mini_trees import make_mini_kitti
from test_torch_minkunet import _perturb

import chip_smoke
from openpcseg_tpu.engine import TrainState
from openpcseg_torch.config import CfgDict
from openpcseg_torch.data.raycast import raycast_batch
from openpcseg_torch.engine.task import batch_to_device
from openpcseg_torch.engine.trainer import Trainer
from openpcseg_torch.utils import convert
from openpcseg_torch.utils.checkpoint import write_atomic
from openpcseg_torch.utils.convert import (jax_params_to_torch,
                                           jax_state_to_torch)

ROOT = Path(__file__).resolve().parents[1]
ITERS, EPOCHS, SEED, NUM_CLASS, CAP = 2, 6, 0, 20, 8192
# XLA's CPU backend without LLVM's optimisations: the same operations in
# the same order, compiled in two thirds of the time
FAST_COMPILE = {"xla_backend_optimization_level": 0}
NARROW = dict(chip_smoke.MODEL_CFG, NUM_LAYER=[1] * 8, cr=0.25,
              DROPOUT_P=0.0)
CE_ONLY = {"LOSS_TYPES": ["CELoss"], "LOSS_WEIGHTS": [1.0]}


def load_script():
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", ROOT / "tools/scripts/jax_ckpt_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCRIPT = load_script()


def fast_jit(jit):
    """`jit` whose functions compile, once per argument signature, at XLA's
    backend optimisation level 0 (FAST_COMPILE)."""
    def wrap(fun, **kw):
        jitted, compiled = jit(fun, **kw), {}

        def call(*args):
            leaves, tree = jax.tree_util.tree_flatten(args)
            if any(isinstance(x, jax.core.Tracer) for x in leaves):
                return jitted(*args)          # inside another trace
            key = (tree, tuple((np.shape(x), str(np.result_type(x)))
                               for x in leaves))
            if key not in compiled:
                compiled[key] = jitted.lower(*args).compile(
                    compiler_options=FAST_COMPILE)
            return compiled[key](*args)
        return call
    return wrap


def save_jax_checkpoint(path, state, epoch: int) -> None:
    """Write `state` as the JAX Trainer does, under ``path/default``."""
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(Path(path).resolve() / "default",
               {"state": jax.device_get(state), "epoch": np.asarray(epoch)})
    ckptr.wait_until_finished()


def mink_cfgs(optimizer: str, loss=None, **optim) -> dict:
    """The narrow MinkUNet under the yaml's OPTIM block with `optimizer`
    (and `optim`'s keys) at batch 1; `loss` a LOSS_CONFIG."""
    model = dict(NARROW) if loss is None else dict(NARROW, LOSS_CONFIG=loss)
    return {"MODALITY": "voxel",
            "DATA": {"DATASET": "semantickitti", "VOXEL_SIZE": 0.05},
            "MODEL": model,
            "OPTIM": dict(chip_smoke.OPTIM_CFG, OPTIMIZER=optimizer,
                          BATCH_SIZE_PER_GPU=1, **optim),
            "TPU": {"POINT_CAP_PER_SCAN": CAP, "VOXEL_CAP_PER_SCAN": CAP}}


def mini_tree(root: Path, batch: int) -> str:
    """A SemanticKITTI tree of ITERS batches of train scans and one val
    scan."""
    seqs = root / "sequences"
    make_mini_kitti(seqs, seqs=("00",), scans_per_seq=ITERS * batch,
                    n_pts=3000, seed=3)
    make_mini_kitti(seqs, seqs=("08",), scans_per_seq=1, n_pts=3000,
                    seed=4)
    return str(seqs)


def scan_batch(cfgs) -> dict:
    """The 8192-point ray-cast scan of SEED as `cfgs`'s model reads it."""
    if cfgs["MODALITY"] == "range":
        from range_parity import projected_batch
        b = projected_batch(SEED)
        n = int(cfgs["OPTIM"]["BATCH_SIZE_PER_GPU"])
        return {k: b[k][:n] for k in ("scan", "label", "mask")}
    return raycast_batch(SEED, 1, cap=CAP)


def init_variables(jt, jb, cfgs, tmpl, rng):
    """Seeded starting variables with their BN leaves perturbed: a range
    model's from JAX's init_state; a voxel model's drawn by numpy into the
    shapes of JAX's `tmpl` (the script's ``template``): each kernel a
    normal over the square root of its fan-in, BN scale 1 and bias 0, the
    statistics 0 and 1."""
    if cfgs["MODALITY"] == "range":
        st = jt.init_state(jax.random.PRNGKey(SEED), jb)
        params, stats = jax.device_get((st.params, st.batch_stats))
    else:
        def draw(path, s):
            name = getattr(path[-1], "key", "")
            if name == "kernel":
                fan_in = int(np.prod(s.shape[:-1]))
                return (rng.standard_normal(s.shape)
                        / np.sqrt(fan_in)).astype(s.dtype)
            full = 1.0 if name in ("scale", "var") else 0.0
            return np.full(s.shape, full, s.dtype)
        params, stats = (jax.tree_util.tree_map_with_path(draw, t)
                         for t in (tmpl.params, tmpl.batch_stats))
    return _perturb(params, rng), _perturb(stats, rng)


def _as_torch(twin, tree, stats):
    jax_params_to_torch(jax.device_get(tree), jax.device_get(stats), twin)
    return {n: t.detach().clone() for n, t in
            list(twin.named_parameters()) + list(twin.named_buffers())}


def moment_state(opt_state):
    """The one TraceState or ScaleByAdamState of an optax state of the JAX
    package's chains, found by type."""
    kinds = (optax.TraceState, optax.ScaleByAdamState)
    found = [x for x in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, kinds))
        if isinstance(x, kinds)]
    assert len(found) == 1, found
    return found[0]


def jax_buffers(opt_state, stats, twin) -> dict:
    """{parameter name: {torch optimizer key: tensor}} of a JAX optax
    state (moment_state), each moment laid out as the port's parameters
    by the walk that fills them (jax_params_to_torch on `twin`); Adam's
    count as each parameter's float ``step``."""
    s = moment_state(opt_state)
    keys = ({"momentum_buffer": s.trace} if isinstance(s, optax.TraceState)
            else {"exp_avg": s.mu, "exp_avg_sq": s.nu})
    names = [n for n, _ in twin.named_parameters()]
    out = {n: {} for n in names}
    for k, tree in keys.items():
        moved = _as_torch(twin, tree, stats)
        for n in names:
            out[n][k] = moved[n]
    if isinstance(s, optax.ScaleByAdamState):
        for n in names:
            out[n]["step"] = torch.tensor(float(s.count))
    return out


def to_flax(params, batch_stats, model, values, scan_blocks=True,
            layout=None):
    """The port's tensors `values` ({id(tensor): tensor} over `model`'s
    parameters and buffers, or some of them) laid out as the flax trees
    shaped as `params` and `batch_stats`; a leaf no tensor reaches is
    None. The converter's walk moves, once, each leaf's number with the
    high part of each value's flat index within its leaf and, once, the
    low part (each exact in float32), which says where every value of a
    tensor came from; pass the same dict as `layout` to walk once for
    several calls on one model."""
    trees = (params, batch_stats)
    flat = [jax.tree_util.tree_flatten(t) for t in trees]
    n0 = len(flat[0][0])

    def walk(fill):
        leaves = [[fill(c * n0 + i, x) for i, x in enumerate(f[0])]
                  for c, f in enumerate(flat)]
        ld = convert._Loader(*(jax.tree_util.tree_unflatten(f[1], v)
                               for f, v in zip(flat, leaves)), model,
                             sink={})
        convert._walk(ld, model, scan_blocks)
        return ld.sink
    lo = 4096
    hi = max(-(-int(np.prod(np.shape(x))) // lo) for f in flat
             for x in f[0])
    assert (len(flat[0][0]) + len(flat[1][0])) * hi < 2 ** 24

    def index(i, x):
        return np.arange(np.prod(np.shape(x))).reshape(np.shape(x))
    if layout is None:
        layout = {}
    if not layout:
        layout["high"] = walk(lambda i, x: (i * hi + index(i, x) // lo)
                              .astype(np.float32))
        layout["low"] = walk(lambda i, x: (index(i, x) % lo)
                             .astype(np.float32))
    high, low = layout["high"], layout["low"]
    out = [[None] * len(f[0]) for f in flat]
    for key, v in values.items():
        h = high[key].long().reshape(-1)
        i = int(h[0]) // hi               # each tensor is one leaf's
        assert bool((h // hi == i).all())
        c, k = (1, i - n0) if i >= n0 else (0, i)
        if out[c][k] is None:
            src = flat[c][0][k]
            out[c][k] = np.full(int(np.prod(np.shape(src))), np.nan,
                                np.dtype(src.dtype))
        idx = (h % hi) * lo + low[key].long().reshape(-1)
        out[c][k][idx.numpy()] = v.detach().reshape(-1).numpy()
    return tuple(jax.tree_util.tree_unflatten(f[1], [
        None if o is None else o.reshape(np.shape(x))
        for o, x in zip(leaves, f[0])]) for f, leaves in zip(flat, out))


def resume(cfgs, tmp: Path, tmpl, batch, f64: bool = False,
           epochs: int = EPOCHS) -> dict:
    """The port's side: the JAX checkpoint at ``tmp/ckp/0`` read by the
    script (its typed restore against `tmpl`, its reading of optax's
    state) and converted (jax_state_to_torch) into ``tmp/x.pt``, which the
    port's Trainer restores (``--ckp``) on a mini tree of two steps an
    epoch; then one train step on `batch`. Returns its readings."""
    bpd = int(cfgs["OPTIM"]["BATCH_SIZE_PER_GPU"])
    cfgs = dict(cfgs, DATA=dict(cfgs["DATA"],
                                DATA_PATH=mini_tree(tmp / "kitti", bpd)))
    args = argparse.Namespace(
        log_dir=str(tmp / "logs"), extra_tag="t", batch_size=bpd, workers=1,
        seed=SEED, epochs=epochs, device="cpu", max_ckp_save_num=2,
        log_interval=1, ckp=str(tmp / "x.pt"))
    saved, epoch = SCRIPT.read_checkpoint(tmp / "ckp" / "0", tmpl)
    payload = jax_state_to_torch(saved, SCRIPT.port_task(cfgs, SEED), epoch,
                                 SEED)
    write_atomic(payload, tmp / "x.pt")
    trainer = Trainer(args, CfgDict(cfgs))
    chip_smoke.no_dropout(trainer.task.model)
    if f64:     # a range model computes in its parameters' type
        trainer.task.model.double()
    trainer.init_or_resume()
    task = trainer.task
    t = dict(restored=dict(step=task.step, start_epoch=trainer.start_epoch,
                           payload=payload))
    mt = task.train_step(batch_to_device(batch, "cpu"))
    named = list(task.model.named_parameters())
    t.update(loss=float(mt["loss"]), lr=float(mt["lr"]), step=task.step,
             loss_state=task.loss_state, grad_norm=float(mt["grad_norm"]),
             grads={n: p.grad.detach().clone() for n, p in named},
             tensors={n: x.detach().clone() for n, x in
                      named + list(task.model.named_buffers())},
             buffers={n: {k: v.detach().clone() for k, v in
                          task.optimizer.state[p].items()}
                      for n, p in named})
    trainer.close()
    return t


def run_case(cfgs, tmp: Path, f64: bool = False, held: str = "jax") -> dict:
    """JAX: two steps, the checkpoint, step 3; the port: ``resume``. What
    the port's step is `held` to: "jax", JAX's own step; "jax_params",
    JAX's own parameters and BN statistics, and for the optimizer's
    buffers optax's update of JAX's carried state by the port's step-3
    gradient; "port_grad", that update for the parameters too. Returns
    both sides' readings."""
    batch = scan_batch(cfgs)
    nb = {k: v.astype(np.float64) if f64 and v.dtype == np.float32 else v
          for k, v in batch.items()}
    dt = np.float64 if f64 else np.float32
    bpd = int(cfgs["OPTIM"]["BATCH_SIZE_PER_GPU"])
    kw = dict(batch_per_device=bpd, iters_per_epoch=ITERS,
              total_epochs=EPOCHS)
    if cfgs["MODALITY"] != "range":
        kw["voxel_cap_per_scan"] = CAP
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(f64):
        mp.setattr(fnn.Dropout, "__call__",
                   lambda self, inputs, *a, **k: inputs)
        jb = {k: jnp.asarray(v) for k, v in nb.items()}
        jt = SCRIPT.jax_task(cfgs, compute_dtype=jnp.dtype(dt), **kw)
        tmpl = SCRIPT.template(jt, jb)
        params, stats = (jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, dt)), t) for t in
            init_variables(jt, jb, cfgs, tmpl, np.random.default_rng(SEED)))
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=stats, opt_state=jt.tx.init(params),
                           loss_state=jt.losses.init_state(NUM_CLASS))
        key = jax.random.PRNGKey(1)
        # JAX's own step as its users compile it where its parameters are
        # the reference; a range model's dense convs run slowly unoptimised
        step = jax.jit(jt.train_step).lower(state, jb, key).compile(
            compiler_options=(FAST_COMPILE if held == "port_grad" and cfgs[
                "MODALITY"] != "range" else None))
        for _ in range(ITERS):
            state, _ = step(state, jb, key)
        state = jax.device_get(state)
        save_jax_checkpoint(tmp / "ckp" / "0", state, 0)
        new, m = jax.device_get(step(state, jb, key))
    twin = SCRIPT.port_task(cfgs, SEED, **kw).model
    if f64:
        twin.double()
    t = resume(cfgs, tmp, tmpl, nb, f64)
    j = dict(loss=float(m["loss"]), lr=float(m["lr"]), step=int(new.step),
             loss_state=new.loss_state,
             tensors=_as_torch(twin, new.params, new.batch_stats),
             buffers=jax_buffers(new.opt_state, new.batch_stats, twin))
    if held != "jax":
        clip = cfgs["OPTIM"]["GRAD_NORM_CLIP"]
        coef = min(1.0, clip / (t["grad_norm"] + 1e-6))
        named = dict(twin.named_parameters())
        with jax.enable_x64(f64):
            grads = to_flax(state.params, state.batch_stats, twin, {
                id(named[n]): g / coef for n, g in t["grads"].items()})[0]
            grads = jax.tree_util.tree_map(jnp.asarray, grads)
            upd, opt = jax.jit(jt.tx.update).lower(
                grads, state.opt_state, state.params).compile(
                    compiler_options=FAST_COMPILE)(grads, state.opt_state,
                                                   state.params)
            upd, opt = jax.device_get((optax.apply_updates(state.params, upd),
                                       opt))
        if held == "port_grad":
            j["tensors"].update({n: v for n, v in _as_torch(
                twin, upd, new.batch_stats).items() if n in named})
        j["buffers"] = jax_buffers(opt, new.batch_stats, twin)
    return dict(j=j, t=t)


def _close(got, want, what) -> None:
    got = torch.as_tensor(got).double()
    want = torch.as_tensor(want).double()
    assert got.shape == want.shape, what
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= 1e-4 * scale or err == 0.0, (what, err, scale)


def check(sides) -> None:
    """The bounds of the module docstring."""
    j, t = sides["j"], sides["t"]
    assert t["restored"]["step"] == ITERS and t["restored"][
        "start_epoch"] == 1
    assert t["step"] == j["step"] == ITERS + 1
    np.testing.assert_allclose(t["lr"], j["lr"], rtol=1e-6)
    np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-5)
    assert set(t["tensors"]) == set(j["tensors"])
    for n, want in j["tensors"].items():
        _close(t["tensors"][n], want, n)
    assert set(t["buffers"]) == set(j["buffers"]) == set(t["grads"])
    for n, want in j["buffers"].items():
        assert set(t["buffers"][n]) == set(want), n
        for k in want:
            _close(t["buffers"][n][k], want[k], f"{n} {k}")
    flat = jax.tree_util.tree_leaves_with_path(j["loss_state"])
    assert len(flat) == len(jax.tree_util.tree_leaves(t["loss_state"]))
    for path, v in flat:
        name = [getattr(k, "key") for k in path]
        got = t["loss_state"]
        for k in name:
            got = got[k]
        np.testing.assert_allclose(got.numpy(), np.asarray(v), rtol=1e-5,
                                   err_msg=str(name))


@pytest.fixture(scope="module")
def tmp_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("jax_ckpt")


def full_width_case(yaml, tmp: Path, monkeypatch, scanned: bool) -> dict:
    """A full-width JAX checkpoint of `yaml` (every leaf seeded numpy in
    the shapes of JAX's init_state at small caps; integers 7, the epoch 3)
    saved, restored and converted; its tensors read back into flax's
    layout (to_flax) and compared with the saved leaves."""
    from openpcseg_torch.cli.golden_run import to_fusion
    if not scanned:
        monkeypatch.setenv("OPENPCSEG_SCAN_BLOCKS", "0")
    cfgs = SCRIPT.load_cfgs(ROOT / yaml)
    cfgs.TPU.POINT_CAP_PER_SCAN = 1024
    fusion = cfgs.MODEL.NAME == "RPVNet"
    batch = raycast_batch(SEED, 1, cap=1024)
    if fusion:
        cfgs.DATA.RANGE_H, cfgs.DATA.RANGE_W = 16, 64
        batch = to_fusion(batch, SEED, 16, 64)
    jt = SCRIPT.jax_task(cfgs, batch_per_device=1, voxel_cap_per_scan=2048)
    tmpl = SCRIPT.template(jt, batch)
    rng = np.random.default_rng(SEED)
    state = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape, np.float32).astype(s.dtype)
                   if jnp.issubdtype(s.dtype, jnp.floating)
                   else np.full(s.shape, 7, s.dtype)), tmpl)
    save_jax_checkpoint(tmp / "ckp" / "3", state, 3)
    saved, epoch = SCRIPT.read_checkpoint(tmp / "ckp" / "3", tmpl)
    task = SCRIPT.port_task(cfgs, SEED, voxel_cap_per_scan=2048)
    payload = jax_state_to_torch(saved, task, epoch, SEED, scanned)
    assert (payload["step"], payload["epoch"]) == (7, 3)
    named = (list(task.model.named_parameters())
             + list(task.model.named_buffers()))
    layout = {}
    got = to_flax(state.params, state.batch_stats, task.model,
                  {id(t): payload["model"][n] for n, t in named}, scanned,
                  layout)
    order = [p for g in task.optimizer.param_groups for p in g["params"]]
    trace = to_flax(state.params, state.batch_stats, task.model, {
        id(order[i]): s["momentum_buffer"]
        for i, s in payload["optimizer"]["state"].items()}, scanned,
        layout)[0]
    pairs = {"params": (got[0], state.params),
             "batch_stats": (got[1], state.batch_stats),
             "trace": (trace, moment_state(state.opt_state).trace)}
    exact, mismatched = [], []
    for col, (a, b) in pairs.items():
        for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(
                a, is_leaf=lambda v: v is None),
                jax.tree_util.tree_leaves(b)):
            ok = x is not None and np.array_equal(x, np.asarray(y))
            exact.append(ok)
            if not ok:
                mismatched.append(col + jax.tree_util.keystr(path))
    return dict(paths=list(state.params), exact=exact, mismatched=mismatched,
                parameters=sum(p.numel() for p in task.model.parameters()),
                flax_parameters=sum(int(np.size(x)) for x in
                                    jax.tree_util.tree_leaves(state.params)))
