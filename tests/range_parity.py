"""Shared set-up of the range-model parity tests (tests/test_torch_range_
<model>.py): one network against the JAX package on the CPU.

The sizes of tests/test_range_models.py: a 16 x 128 image, batch 2, 20
classes. The inputs are two real projected scans: ray-cast scans of up to
131,072 points (``data/raycast.py``) through ``range_project`` +
``pack_scan_tensor``, so the mask channel, the empty pixels and the
z-buffer's choices are those of a real range image (the surrogate's
sensor sits at z = 0, so 88% of these pixels are empty and most points
land in the top row, as in the golden runs). The MODEL block is the
shipped yaml's (CENet's dice loss and aux heads, the others' WCE) with
narrower stages where noted; the OPTIM block is the yaml's AdamW +
onecycle over 10 steps (2 an epoch, 5 epochs), so three steps see the
climb and its peak.

JAX's ``init_state`` gives the variables; every BN leaf and every bias is
perturbed from a seeded numpy generator (``test_torch_minkunet._perturb``)
so that the converter's BN and bias paths carry real values; both sides
load them (``jax_params_to_torch``). JAX's jitted train step runs with a
gradient stash at the head of its optax chain (``test_torch_train.
_grad_stash``), and with flax's ``nn.Dropout`` made the identity for the
duration (SalsaNext and RangeNet hard-code their rates); the port runs its
dropout at p = 0.

On these images float32 alone moves a training step far: the batch
statistics of channels that are constant over the empty pixels, and the
LeakyReLU gates near them, make the gradient ill-conditioned, and XLA's
float32 on the CPU lands farther from the exact step than the port's
does. So a train step is read in float32 and in float64 on both sides
(JAX under ``jax.enable_x64``; both losses still cast the logits to
float32, as written): the port's float32 step is held to JAX's float64
reading (``check_train_step``), and the three AdamW + onecycle steps are
held in float64 (``check_three_steps``). Each side compiles or runs once
per module (``make_sides``)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from test_torch_minkunet import _perturb
from test_torch_train import _grad_stash, _named

from openpcseg_tpu.config import CfgDict as JaxCfgDict
from openpcseg_tpu.engine import SegTask as JaxSegTask
from openpcseg_tpu.engine import TrainState
from openpcseg_torch.config import CfgDict, cfg_from_yaml_file
from openpcseg_torch.data.range_view import pack_scan_tensor, range_project
from openpcseg_torch.data.raycast import raycast_batch
from openpcseg_torch.engine.task import SegTask, batch_to_device
from openpcseg_torch.models import build_segmentor
from openpcseg_torch.utils.convert import jax_params_to_torch

H, W, B, NUM_CLASS = 16, 128, 2, 20
ITERS_PER_EPOCH, EPOCHS, STEPS = 2, 5, 3
YAML = "tools/cfgs/range/semantic_kitti/{}_64x2048.yaml"


def range_cfgs(name: str, **model) -> dict:
    """The shipped yaml's MODEL and OPTIM blocks (MODEL updated by
    `model`) at H x W."""
    ycfg = CfgDict()
    cfg_from_yaml_file(YAML.format(name.lower()), ycfg)
    return {"MODALITY": "range",
            "DATA": {"DATASET": "semantickitti", "H": H, "W": W},
            "MODEL": dict(ycfg.MODEL, **model),
            "OPTIM": dict(ycfg.OPTIM, BATCH_SIZE_PER_GPU=B)}


def projected_batch(seed: int, n_points: int = 8192) -> dict:
    """B ray-cast scans projected to H x W (numpy), with each scan's
    points (p_label, p_px, p_py, p_range over n_points, p_valid) as the
    eval view carries them."""
    out = {k: [] for k in ("scan", "label", "mask", "p_label", "p_px",
                           "p_py", "p_range", "p_valid")}
    for i in range(B):
        b = raycast_batch(seed + i, 1)
        v = b["valid"][0]
        s = range_project(b["xyz"][0][v], b["feats"][0][v, 3],
                          b["labels"][0][v], H, W)
        scan, label, mask = pack_scan_tensor(s)
        keep = np.random.default_rng(seed + i).permutation(int(v.sum()))[
            :n_points]
        out["scan"].append(scan)
        out["label"].append(label)
        out["mask"].append(mask)
        out["p_label"].append(b["labels"][0][v][keep])
        out["p_px"].append(s["proj_x"][keep])
        out["p_py"].append(s["proj_y"][keep])
        out["p_range"].append(s["unproj_range"][keep])
        out["p_valid"].append(np.arange(n_points) < n_points - 100 * i)
    return {k: np.stack(v) for k, v in out.items()}


def no_dropout(model: torch.nn.Module) -> None:
    """p = 0 for every dropout of a range model (SalsaNext's blocks and
    RangeNet hold theirs as ``p``)."""
    for m in model.modules():
        if hasattr(m, "p") and isinstance(m.p, float):
            m.p = 0.0


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)


def make_sides(name: str, batch: dict, **model) -> dict:
    """JAX's and the port's readings of one network on the same variables
    and `batch`: in float32 the eval logits, the eval hists (per point,
    KNN) and one train step (loss, raw gradients, BN statistics); in
    float64 (JAX under ``jax.enable_x64``, the port's model ``.double()``;
    both losses still take float32 logits, as written) STEPS train steps
    (loss, lr, raw gradients, BN statistics and parameters after each)."""
    cfgs = range_cfgs(name, **model)
    train = {k: batch[k] for k in ("scan", "label", "mask")}
    rng = np.random.default_rng(0)

    jtask = JaxSegTask(JaxCfgDict(cfgs), num_class=NUM_CLASS,
                       batch_per_device=B, iters_per_epoch=ITERS_PER_EPOCH,
                       total_epochs=EPOCHS)
    jtask.tx = optax.chain(_grad_stash(), jtask.tx)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jtask.init_state(jax.random.PRNGKey(0), jb)
    params0, stats0 = jax.device_get((_perturb(state.params, rng),
                                      _perturb(state.batch_stats, rng)))
    state = state.replace(params=params0, batch_stats=stats0)
    logits = jax.jit(lambda s, x: jtask.model.apply(
        {"params": s.params, "batch_stats": s.batch_stats}, x,
        train=False)[0])
    j = dict(logits=np.asarray(logits(state, jb["scan"])),
             hist=np.asarray(jax.jit(jtask.eval_step)(state, jb)["hist"]))

    def jax_steps(state, b, n):
        step, out = jax.jit(jtask.train_step), []
        for _ in range(n):
            state, m = step(state, b, jax.random.PRNGKey(1))
            out.append(dict(loss=float(m["loss"]), lr=float(m["lr"]),
                            grads=jax.device_get(state.opt_state[0]),
                            stats=jax.device_get(state.batch_stats),
                            params=jax.device_get(state.params)))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__",
                   lambda self, inputs, *a, **k: inputs)
        j["f32"] = jax_steps(state, {k: jb[k] for k in train}, 1)
        with jax.enable_x64(True):
            p64, s64 = _f64(params0), _f64(stats0)
            state64 = TrainState(step=jnp.zeros((), jnp.int32), params=p64,
                                 batch_stats=s64, opt_state=jtask.tx.init(p64),
                                 loss_state=state.loss_state)
            b64 = {k: jnp.asarray(v.astype(np.float64) if k == "scan"
                                  else v) for k, v in train.items()}
            j["f64"] = jax_steps(state64, b64, STEPS)

    clip = cfgs["OPTIM"]["GRAD_NORM_CLIP"]

    def port_steps(task, b, n):
        out = []
        for _ in range(n):
            m = task.train_step(b)
            coef = min(1.0, clip / (float(m["grad_norm"]) + 1e-6))
            out.append(dict(
                loss=float(m["loss"]), lr=m["lr"],
                grads={n: g / coef for n, g in
                       _named(task.model, "grad").items()},
                stats={n: b.clone().numpy()
                       for n, b in task.model.named_buffers()},
                params=_named(task.model)))
        return out

    def port_task(dtype):
        task = SegTask(cfgs, NUM_CLASS, device="cpu", batch_per_device=B,
                       iters_per_epoch=ITERS_PER_EPOCH, total_epochs=EPOCHS)
        jax_params_to_torch(params0, stats0, task.model)
        no_dropout(task.model)
        task.model.to(dtype)
        return task

    task = port_task(torch.float32)
    tb = batch_to_device(batch, "cpu")
    t = dict(logits=task.range_logits(tb).permute(0, 2, 3, 1).numpy(),
             hist=task.eval_step(tb)["hist"].numpy())
    t["f32"] = port_steps(task, batch_to_device(train, "cpu"), 1)
    t["f64"] = port_steps(port_task(torch.float64), batch_to_device(
        dict(train, scan=train["scan"].astype(np.float64)), "cpu"), STEPS)

    twin = build_segmentor(cfgs["MODEL"], NUM_CLASS).double()

    def as_torch(run, i, key):
        """JAX's run (f32 / f64) step i tree `key`, laid out as the port's
        named tensors (float64 numpy copies)."""
        st = j[run][i]
        jax_params_to_torch(st["params"] if key == "stats" else st[key],
                            st["stats"], twin)
        if key == "stats":
            return {n: b.clone().numpy() for n, b in twin.named_buffers()}
        return _named(twin)
    return dict(j=j, t=t, as_torch=as_torch, cfgs=cfgs)


# ------------------------------------------------------------- checks --

def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def check_eval(sides, bound: float = 1e-4) -> None:
    """Eval logits within `bound` of the largest |logit| of JAX's; the
    per-point KNN hists equal."""
    want, got = sides["j"]["logits"], sides["t"]["logits"]
    assert got.shape == want.shape == (B, H, W, NUM_CLASS)
    assert _rel(got, want) <= bound
    np.testing.assert_array_equal(sides["t"]["hist"], sides["j"]["hist"])


def check_train_step(sides) -> None:
    """The float32 step against JAX's float64 reading of the same step:
    the loss at rtol 1e-5; the BN running statistics at rtol = atol =
    1e-5; every raw gradient at rtol 1e-4 and an atol of 1e-4 or, where
    JAX's own float32 step lies farther from its float64 one, twice that
    distance on that tensor (the test modules say why)."""
    t32 = sides["t"]["f32"][0]
    np.testing.assert_allclose(t32["loss"], sides["j"]["f64"][0]["loss"],
                               rtol=1e-5)
    want = sides["as_torch"]("f64", 0, "grads")
    jax32 = sides["as_torch"]("f32", 0, "grads")
    assert set(t32["grads"]) == set(want)
    for n in want:
        atol = max(1e-4, 2 * float(np.abs(jax32[n] - want[n]).max()))
        np.testing.assert_allclose(t32["grads"][n], want[n], rtol=1e-4,
                                   atol=atol, err_msg=n)
    want = sides["as_torch"]("f64", 0, "stats")
    assert set(t32["stats"]) == set(want)
    for n in want:
        np.testing.assert_allclose(t32["stats"][n], want[n], rtol=1e-5,
                                   atol=1e-5, err_msg=n)


def jax_float32_error(sides) -> float:
    """The largest distance of a raw gradient of JAX's float32 step from
    its float64 one, over that tensor's largest |value|."""
    want = sides["as_torch"]("f64", 0, "grads")
    got = sides["as_torch"]("f32", 0, "grads")
    return max(_rel(got[n], want[n]) for n in want)


def check_three_steps(sides) -> None:
    """STEPS AdamW + onecycle steps in float64: each loss at rtol 1e-6,
    each lr within 1e-6 of the peak, every parameter after them at rtol =
    atol = 1e-6 (each moved), the BN statistics at rtol = atol = 1e-6."""
    peak = sides["cfgs"]["OPTIM"]["LEARNING_RATE"]
    for jm, tm in zip(sides["j"]["f64"], sides["t"]["f64"]):
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-6)
        np.testing.assert_allclose(tm["lr"], jm["lr"], rtol=1e-6,
                                   atol=1e-6 * peak)
    last = sides["t"]["f64"][-1]
    for key in ("params", "stats"):
        want = sides["as_torch"]("f64", STEPS - 1, key)
        for n in want:
            np.testing.assert_allclose(last[key][n], want[n], rtol=1e-6,
                                       atol=1e-6, err_msg=n)
    first = sides["as_torch"]("f64", 0, "params")
    assert all(not np.array_equal(last["params"][n], first[n])
               for n in first)


def check_shipped_width(name: str) -> None:
    """The port's network from the shipped yaml has JAX's parameter count
    and the same multiset of tensor sizes, and ``build_segmentor`` /
    ``SegTask`` take the yaml as it stands."""
    ycfg = CfgDict()
    cfg_from_yaml_file(YAML.format(name.lower()), ycfg)
    jcfg = JaxCfgDict(dict(ycfg))
    from openpcseg_tpu.models import build_segmentor as jbuild
    jmodel = jbuild(jcfg.MODEL, NUM_CLASS)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        jnp.zeros((1, H, W, 6)), train=False))
    jsizes = sorted(int(np.prod(x.shape)) for x in
                    jax.tree_util.tree_leaves(shapes["params"]))
    model = build_segmentor(ycfg.MODEL, NUM_CLASS)
    tsizes = sorted(p.numel() for p in model.parameters())
    assert tsizes == jsizes
    task = SegTask(dict(ycfg), NUM_CLASS, device="cpu")
    assert task.is_range and task.optimizer is not None
