"""Carry a JAX training run's checkpoint into the PyTorch / CUDA port.

Where JAX, flax, optax and orbax are installed (a CPU build of PyTorch is
enough), with the config the run was trained with:

    python tools/scripts/jax_ckpt_to_torch.py \\
        --cfg_file tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10.yaml \\
        --ckp logs/<exp>/ckp/<epoch> --out x.pt [--seed 42] [--set K V ...]

then on the card, through the port's CLIs:

    python -m openpcseg_torch.cli.train --cfg_file <same yaml> --ckp x.pt
    python -m openpcseg_torch.cli.infer --cfg_file <same yaml> --ckp x.pt

The JAX ``Trainer`` writes orbax checkpoints to ``ckp/<epoch>/default``
holding ``{"state": TrainState(step, params, batch_stats, opt_state,
loss_state), "epoch"}``; ``--ckp`` takes ``ckp/<epoch>`` or its
``default/``. The checkpoint is restored typed, against a template of the
JAX task's ``init_state`` made with ``jax.eval_shape`` (nothing is
compiled; an untyped restore would flatten optax's NamedTuples): the
task's batch shapes come from the first val batch of the config's dataset
(``--set DATA.DATA_PATH <root>`` where it moved), as the JAX CLIs restore.
The optax state is read by type (``optim/__init__.py`` of the JAX
package builds the chains): ``TraceState`` (sgd, sgd_fc, whose 10x head is
a stateless partition after the trace), ``ScaleByAdamState`` (adam,
adamw), and the one inside adam_onecycle's inject-hyperparams state (its
b1 is the schedule's, which the port sets again each step); clip, decay
and schedule states hold no moments. A state replicated over a mesh is
restored as one copy.

``openpcseg_torch.utils.convert.jax_state_to_torch`` then fills the
port's ``SegTask`` (built on the CPU from the same config) and returns the
port's checkpoint payload, written with ``utils/checkpoint.py
write_atomic``: the weights, BN statistics, SGD momentum or Adam moments,
the step (and so the LR schedule's position), the epoch and EQLv2's loss
state carry across. The JAX PRNG key does not: the port seeds its
generator with ``--seed`` (the JAX CLIs' default, 42, unless given).
OPENPCSEG_SCAN_BLOCKS=0 is read as the JAX package reads it.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import orbax.checkpoint as ocp  # noqa: E402
import torch  # noqa: E402

from openpcseg_tpu.config import CfgDict  # noqa: E402
from openpcseg_tpu.engine import SegTask as JaxSegTask  # noqa: E402
from openpcseg_torch.config import CfgDict as TorchCfgDict  # noqa: E402
from openpcseg_torch.config import (cfg_from_list,  # noqa: E402
                                    cfg_from_yaml_file)
from openpcseg_torch.data import num_classes_for  # noqa: E402
from openpcseg_torch.engine.task import SegTask  # noqa: E402
from openpcseg_torch.utils.checkpoint import write_atomic  # noqa: E402
from openpcseg_torch.utils.convert import jax_state_to_torch  # noqa: E402

# optax states that hold no moments: clip, decay, the schedules, sgd_fc's
# 10x partition (its masked parts are stateless)
_EMPTY = {"EmptyState", "ScaleByScheduleState", "WrappedScheduleState",
          "ClipByGlobalNormState", "AddDecayedWeightsState", "ScaleState",
          "IdentityState", "MaskedNode"}
_PARTITION = {"PartitionState", "MultiTransformState"}
_INJECT = {"InjectHyperparamsState", "InjectStatefulHyperparamsState"}


def scan_blocks() -> bool:
    """JAX's own switch (models/layers.py repeated_blocks)."""
    return os.environ.get("OPENPCSEG_SCAN_BLOCKS", "1") != "0"


def load_cfgs(cfg_file, sets=()):
    """The yaml at `cfg_file` with the --set pairs `sets`."""
    cfgs = TorchCfgDict()
    cfg_from_yaml_file(str(cfg_file), cfgs)
    if sets:
        cfg_from_list(list(sets), cfgs)
    return cfgs


def opt_moments(opt_state) -> dict:
    """The moments of an optax state of the JAX package's chains, as the
    neutral dict ``jax_state_to_torch`` takes: {"kind": "trace", "trace"}
    or {"kind": "adam", "count", "mu", "nu"}. Exactly one moment-bearing
    state must be found; a state of an unknown type raises."""
    found = []

    def walk(s, path):
        name = type(s).__name__
        if name == "TraceState":
            found.append((path, {"kind": "trace", "trace": s.trace}))
        elif name == "ScaleByAdamState":
            found.append((path, {"kind": "adam", "count": int(s.count),
                                 "mu": s.mu, "nu": s.nu}))
        elif name in _INJECT:
            walk(s.inner_state, path + "/inner_state")
        elif name in _PARTITION:
            for k, v in s.inner_states.items():
                walk(v, f"{path}/{k}")
        elif name == "MaskedState":
            walk(s.inner_state, path + "/inner_state")
        elif name in _EMPTY:
            pass
        elif isinstance(s, (tuple, list)) and not hasattr(s, "_fields"):
            for i, v in enumerate(s):
                walk(v, f"{path}/{i}")
        else:
            raise ValueError(f"opt_state{path}: optax state {name} is not "
                             "one the JAX package's optimizers build")
    walk(opt_state, "")
    if len(found) != 1:
        raise ValueError(f"opt_state: {len(found)} moment-bearing states "
                         f"({[p for p, _ in found]}), want one")
    return found[0][1]


def jax_task(cfgs, **kw):
    """The JAX package's SegTask of `cfgs` (one device, float32)."""
    kw.setdefault("batch_per_device",
                  int(cfgs["OPTIM"].get("BATCH_SIZE_PER_GPU", 1)))
    return JaxSegTask(CfgDict(dict(cfgs)),
                      num_class=num_classes_for(cfgs["DATA"]["DATASET"]),
                      **kw)


def first_batch(cfgs):
    """The first val batch of the config's dataset (numpy), as the JAX
    CLIs build their state from."""
    from openpcseg_tpu.data import build_dataloader
    jcfg = CfgDict(dict(cfgs))
    _, loader = build_dataloader(
        jcfg.DATA, jcfg.get("MODALITY", "voxel"),
        int(jcfg.OPTIM.get("BATCH_SIZE_PER_GPU", 1)), training=False,
        point_cap=jcfg.get("TPU", {}).get("POINT_CAP_PER_SCAN", 131072),
        num_workers=1, seed=0)
    return {k: v for k, v in next(iter(loader)).items() if k != "name"}


def _item_dir(path) -> Path:
    p = Path(path).resolve()
    return p / "default" if (p / "default").is_dir() else p


def template(task, batch):
    """The shapes and types of `task`'s ``init_state`` on `batch`'s shapes
    (``jax.eval_shape``: traced, not compiled)."""
    spec = {k: jax.ShapeDtypeStruct(np.shape(v), np.asarray(v).dtype)
            for k, v in batch.items()}
    return jax.eval_shape(task.init_state, jax.random.PRNGKey(0), spec)


def read_checkpoint(path, tmpl) -> tuple:
    """(state, epoch) of the JAX checkpoint at `path` (``ckp/<epoch>`` or
    its ``default/``): `state` the numpy dict ``jax_state_to_torch``
    takes. Restored typed against `tmpl` (``template``); a leaf whose path
    or shape differs from it raises and names it."""
    shard = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    tmpl = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=shard),
        {"state": tmpl, "epoch": jax.ShapeDtypeStruct((), jnp.int32)})
    item = _item_dir(path)
    _check_against(item, tmpl)
    payload = jax.device_get(ocp.StandardCheckpointer().restore(item, tmpl))
    st = payload["state"]
    state = {"params": st.params, "batch_stats": st.batch_stats,
             "step": int(st.step), "loss_state": st.loss_state,
             "opt": opt_moments(st.opt_state)}
    return state, int(payload["epoch"])


def _check_against(item, tmpl) -> None:
    """The saved tree's leaves against the template's: a path missing on
    either side, or whose shape differs, raises, naming the first (the
    missing ones, then the extra ones, then the shapes; params first)."""
    meta = ocp.StandardCheckpointer().metadata(item)
    meta = getattr(meta, "item_metadata", meta)
    want = {_key(p): tuple(s.shape) for p, s in
            jax.tree_util.tree_flatten_with_path(tmpl)[0]}
    got = {_key(p): tuple(getattr(m, "shape", ())) for p, m in
           jax.tree_util.tree_flatten_with_path(
               dict(meta), is_leaf=lambda x: hasattr(x, "shape"))[0]}
    diffs = ([f"{k} is not in the checkpoint" for k in sorted(want)
              if k not in got]
             + [f"{k} is not in this config's model" for k in sorted(got)
                if k not in want]
             + [f"{k} has shape {got[k]}, this config's model {want[k]}"
                for k in sorted(set(got) & set(want)) if got[k] != want[k]])
    if diffs:
        diffs.sort(key=lambda d: not d.startswith("state/params/"))
        raise ValueError(
            f"--ckp {item}: {len(diffs)} leaves differ from this config's "
            f"model (another yaml, NUM_LAYER or width?), first {diffs[0]}")


def _key(path) -> str:
    """A tree path as orbax names it: NamedTuple fields and sequence
    indices both as plain keys."""
    out = []
    for k in path:
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                out.append(str(getattr(k, attr)))
                break
    return "/".join(out)


def port_task(cfgs, seed: int = 0, **kw):
    """The port's SegTask of `cfgs` on the CPU."""
    kw.setdefault("batch_per_device",
                  int(cfgs["OPTIM"].get("BATCH_SIZE_PER_GPU", 1)))
    return SegTask(dict(cfgs), num_classes_for(cfgs["DATA"]["DATASET"]),
                   device="cpu", seed=seed, **kw)


def convert(cfgs, ckp, seed: int, batch=None) -> dict:
    """The port's checkpoint payload of the JAX checkpoint `ckp` of a run
    of `cfgs` (the template's batch: `batch`, else first_batch)."""
    if batch is None:
        batch = first_batch(cfgs)
    state, epoch = read_checkpoint(ckp, template(jax_task(cfgs), batch))
    return jax_state_to_torch(state, port_task(cfgs, seed), epoch, seed,
                              scan_blocks())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cfg_file", required=True)
    ap.add_argument("--ckp", required=True,
                    help="the JAX run's ckp/<epoch> (or its default/)")
    ap.add_argument("--out", required=True,
                    help="the port's checkpoint file to write")
    ap.add_argument("--seed", type=int, default=42,
                    help="the port's generator seed (the JAX CLIs' "
                    "default)")
    ap.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER,
                    default=None, help="dotted-key config overrides")
    args = ap.parse_args(argv)
    cfgs = load_cfgs(args.cfg_file, args.set_cfgs or ())
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    payload = convert(cfgs, args.ckp, args.seed)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    write_atomic(payload, out)
    print(f"{args.ckp} (epoch {payload['epoch']}, step {payload['step']}) "
          f"-> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
