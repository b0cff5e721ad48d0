"""The fixture of chip_smoke.py's jax_ckpt phase, made from a JAX run on
the CPU: the card has no JAX, so JAX's numbers travel as a file.

A narrow MinkUNet (the entry yaml under chip_smoke.JAX_CKPT_SETS) takes
two float32 SGD steps in JAX on the 8192-point ray-cast scan of
chip_smoke.SEED, is saved with orbax as the JAX Trainer saves it and
converted by tools/scripts/jax_ckpt_to_torch.py (``jax_ckpt_mk_narrow.pt``);
``jax_ckpt_mk_narrow_expect.npz`` holds the scan's digest, JAX's float32
eval logits on that scan from that state, its third step's loss, lr, raw
gradient and parameters, and JAX's own bf16 step against its float32 one
from that state on chip_smoke.train_ref_draws (the scan and nine
feature-perturbed copies): the reading the card's bf16 step is held to.
Remake both files (~3 min) with

    JAX_PLATFORMS=cpu python tests/jax_ckpt_fixture.py [OUT_DIR]

(OUT_DIR: openpcseg_torch/tools/fixtures), then run
tests/test_torch_jax_ckpt_sgd.py, tests/test_torch_jax_ckpt_fixture*.py
and, with ``-m slow``, the reading's rebuild.
"""
from __future__ import annotations

import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
from jax_ckpt_parity import SCRIPT, save_jax_checkpoint  # noqa: E402
from test_torch_train import _grad_stash  # noqa: E402

import chip_smoke  # noqa: E402
from openpcseg_torch.config import (CfgDict, cfg_from_list,  # noqa: E402
                                    cfg_from_yaml_file)
from openpcseg_torch.utils.checkpoint import write_atomic  # noqa: E402
from openpcseg_torch.utils.convert import jax_params_to_torch  # noqa: E402

FIXTURE = ROOT / chip_smoke.JAX_CKPT_FIXTURE
ITERS = 2           # steps an epoch: the two saved steps are epoch 0
SEED = chip_smoke.SEED
KW = dict(batch_per_device=1, iters_per_epoch=ITERS,
          voxel_cap_per_scan=chip_smoke.JAX_CKPT_CAP)


def fixture_cfgs(tree=None):
    """The fixture's config: the entry yaml under JAX_CKPT_SETS at the
    phase's cap."""
    cfgs = CfgDict()
    cfg_from_yaml_file(str(ROOT / chip_smoke.ENTRY_CFG), cfgs)
    cfg_from_list([*chip_smoke.JAX_CKPT_SETS, "TPU.VOXEL_CAP_PER_SCAN",
                   str(chip_smoke.JAX_CKPT_CAP)], cfgs)
    if tree is not None:
        cfgs.DATA.DATA_PATH = tree
    return cfgs


def _as_port(tree, batch_stats, twin):
    """A params-shaped JAX tree laid out as the port's named parameters."""
    jax_params_to_torch(jax.device_get(tree), batch_stats, twin)
    return {n: p.detach().numpy().copy() for n, p in
            twin.named_parameters()}


def _cos(a, b) -> float:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def fixture_scan() -> dict:
    """The fixture's scan: chip_smoke.py's, whose draws its reading takes
    (train_ref_draws)."""
    return chip_smoke.scan_for(chip_smoke.CFGS, SEED,
                               cap=chip_smoke.JAX_CKPT_CAP)


def fixture_steps(cfgs) -> tuple:
    """JAX's run of the fixture on the CPU: init_state, two float32 steps
    on the scan (the state saved), then the third. Returns (the scan, the
    saved TrainState, the expectations of the third step, the TrainState
    after it)."""
    scan = fixture_scan()
    jb = {k: jnp.asarray(v) for k, v in scan.items()}
    task = SCRIPT.jax_task(cfgs, **KW)
    task.tx = optax.chain(_grad_stash(), task.tx)
    state = task.init_state(jax.random.PRNGKey(SEED), jb)
    step = jax.jit(task.train_step)
    key = jax.random.PRNGKey(SEED + 1)
    for _ in range(ITERS):
        state, _ = step(state, jb, key)
    saved = jax.device_get(state.replace(opt_state=state.opt_state[1]))
    state3, m3 = jax.device_get(step(state, jb, key))
    twin = SCRIPT.port_task(cfgs, SEED, **KW).model
    expect = dict(
        valid=scan["valid"][0],
        scan_digest=np.str_(chip_smoke.inputs_digest([scan],
                                                     torch.nn.Module())),
        loss3=np.float64(m3["loss"]), lr3=np.float64(m3["lr"]),
        step=np.int64(ITERS), epoch=np.int64(0),
        grads3=_as_port(state3.opt_state[0], saved.batch_stats, twin),
        params3=_as_port(state3.params, state3.batch_stats, twin))
    return scan, saved, expect, state3.replace(
        opt_state=state3.opt_state[1])


def fixture_logits(cfgs, state, scan) -> np.ndarray:
    """JAX's float32 eval logits of `state` (params, batch_stats) on the
    scan."""
    task = SCRIPT.jax_task(cfgs, **KW)

    @jax.jit
    def logits(params, stats, b):
        vb, pyr = task.preprocess(b)
        return task.model.apply({"params": params, "batch_stats": stats},
                                task._model_inputs(vb, b), pyr, train=False)
    return np.asarray(logits(state.params, state.batch_stats,
                             {k: jnp.asarray(v) for k, v in scan.items()}))


def jax_reading(cfgs, state) -> np.ndarray:
    """JAX's bf16 train step against its float32 one from `state` (a
    TrainState) on each of chip_smoke.train_ref_draws() (the fixture's
    scan and nine feature-perturbed copies): rows of (loss rel,
    whole-gradient cosine, worst conv-weight cosine), chip_smoke's
    reading."""
    from openpcseg_torch.models.layers import SparseConv
    twin = SCRIPT.port_task(cfgs, SEED, **KW).model
    convs = [n + ".weight" for n, mod in twin.named_modules()
             if isinstance(mod, SparseConv)]
    stats = jax.device_get(state.batch_stats)
    runs = {}
    for tag, dt in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        t = SCRIPT.jax_task(cfgs, compute_dtype=dt, **KW)
        t.tx = optax.chain(_grad_stash(), t.tx)
        s = state.replace(opt_state=t.tx.init(state.params))
        step = jax.jit(t.train_step)
        runs[tag] = []
        for d in chip_smoke.train_ref_draws():
            new, m = step(s, {k: jnp.asarray(v) for k, v in d.items()},
                          jax.random.PRNGKey(1))
            runs[tag].append((float(m["loss"]),
                              _as_port(new.opt_state[0], stats, twin)))
    rows = []
    for (lb, gb), (lf, gf) in zip(runs["bf16"], runs["f32"]):
        rows.append((abs(lb - lf) / abs(lf),
                     _cos(np.concatenate([gb[n].ravel() for n in gf]),
                          np.concatenate([v.ravel() for v in gf.values()])),
                     min(_cos(gb[n].ravel(), gf[n].ravel()) for n in convs)))
    return np.asarray(rows)


def make_fixture(out_dir) -> dict:
    """Writes ``<out_dir>/jax_ckpt_mk_narrow.pt`` and ``..._expect.npz``
    (module docstring); returns the expectations."""
    cfgs = fixture_cfgs()
    scan, saved, expect, _ = fixture_steps(cfgs)
    expect["logits"] = fixture_logits(cfgs, saved, scan)
    expect["reading"] = jax_reading(cfgs, saved)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as d:
        save_jax_checkpoint(Path(d) / "ckp" / "0", saved, 0)
        payload = SCRIPT.convert(cfgs, Path(d) / "ckp" / "0", SEED, scan)
    write_atomic(payload, out / f"{FIXTURE.name}.pt")
    flat = {k: v for k, v in expect.items() if k not in ("grads3", "params3")}
    for k in ("grads3", "params3"):
        flat.update({f"{k}/{n}": v for n, v in expect[k].items()})
    np.savez_compressed(out / f"{FIXTURE.name}_expect.npz", **flat)
    return expect


if __name__ == "__main__":
    out_dir = sys.argv[1] if len(sys.argv) > 1 else FIXTURE.parent
    torch.set_num_threads(8)
    make_fixture(out_dir)
    print(f"wrote {FIXTURE.name}.pt and {FIXTURE.name}_expect.npz to "
          f"{out_dir}")
