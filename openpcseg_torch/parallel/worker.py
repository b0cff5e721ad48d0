"""A data-parallel run in several processes, and its one-process yardstick.

    python -m openpcseg_torch.parallel.worker <spec.json> <rank>

Each process is one rank: it joins the process group through the spec's
``init`` (a ``file://`` store, so no port is taken), builds a ``SegTask``
over the group from the spec's config and weights, takes the spec's train
steps on its own batch through ``shard_train_step`` and evaluates that
batch (the histogram summed over the ranks, and a voxel model's own);
over the spec's dataset it evaluates the val loader, whose tail is padded
to the global batch, and runs test-time augmentation, the scans split
between the ranks; it saves what it saw to ``<out>/rank<r>.pt``. ``run_ranks`` starts the ranks and
gathers their results; ``exact_train_step`` is the one-process equivalent
of one data-parallel step. The module imports torch and the port only, so
the CPU tests and ``chip_smoke.py`` on the card share it.

The spec (JSON): ``cfgs`` (SegTask's config, with OPTIM), ``num_class``,
``device`` ("cpu" or "cuda"; every rank of a card shares it, over gloo),
``compute_dtype`` ("float32" or "bfloat16"), ``world``, ``init``,
``weights`` (a state_dict file or null), ``batches`` (one ``.npz`` a rank,
or null), ``steps``, ``iters_per_epoch``, ``seed``, ``threads`` (torch's
intra-op threads, or null), ``data`` (null, or ``data``: a DATA block,
``modality``, ``point_cap`` and ``voting``, 0 for no test-time
augmentation) and ``out``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..engine.task import SegTask, batch_to_device
from ..losses.ce import cross_entropy
from ..ops import cuda_lib
from ..utils.metrics import confusion_matrix
from .ddp import init_distributed, shard_train_step

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def load_batch(path, device) -> dict:
    with np.load(path) as z:
        return batch_to_device({k: z[k] for k in z.files}, device)


def make_task(spec, device, **kw) -> SegTask:
    """SegTask of the spec's config on `device`, holding its weights."""
    task = SegTask(spec["cfgs"], spec["num_class"], device=device,
                   compute_dtype=DTYPES[spec["compute_dtype"]],
                   seed=spec["seed"], iters_per_epoch=spec["iters_per_epoch"],
                   **kw)
    if spec.get("weights"):
        task.model.load_state_dict(torch.load(spec["weights"],
                                              map_location=device,
                                              weights_only=True))
    return task


def _host(metrics) -> dict:
    return {k: (v.item() if torch.is_tensor(v) else v)
            for k, v in metrics.items()}


def rank_main(spec, rank: int) -> None:
    import torch.distributed as dist

    from ..data import build_dataloader
    from ..engine.trainer import tta_histogram

    if spec.get("threads"):
        torch.set_num_threads(spec["threads"])
    world = spec["world"]
    _, _, dev = init_distributed(spec["device"], init_method=spec["init"],
                                 rank=rank, world_size=world)
    task = make_task(spec, dev, batch_per_device=1, num_devices=world,
                     group=dist.group.WORLD)
    step = shard_train_step(task)
    out = {"steps": []}
    if spec.get("batches"):
        out.update(_batch_run(task, step, spec["steps"],
                              load_batch(spec["batches"][rank], dev)))
    data = spec.get("data")
    if data:
        from ..config import CfgDict
        dataset, loader = build_dataloader(
            CfgDict(data["data"]), data["modality"], world, training=False,
            point_cap=data["point_cap"], num_workers=1, seed=spec["seed"])
        hist = 0
        for b in loader:
            hist = hist + task.eval_step(batch_to_device(
                {k: v for k, v in b.items() if k != "name"}, dev))["hist"]
        out["eval_hist"] = hist.cpu()
        if data["voting"]:
            tta_task = SegTask(
                {k: v for k, v in spec["cfgs"].items() if k != "OPTIM"},
                spec["num_class"], device=dev,
                compute_dtype=task.compute_dtype,
                batch_per_device=data["voting"], model=task.model)
            out["tta_hist"] = torch.as_tensor(tta_histogram(
                tta_task, dataset, data["voting"], rank, world))
    torch.save(out, Path(spec["out"]) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def _batch_run(task, step, steps: int, batch) -> dict:
    """`steps` train steps of this rank on `batch`, each with its launch
    counts and wall ms (ended by reading its metrics), the first step's
    clipped gradients, the state and the loss state (EQLv2's buffers)
    after them, and the eval of `batch`."""
    out = {"steps": []}
    for i in range(steps):
        cuda_lib.reset_counts()
        t0 = time.perf_counter()
        m = _host(step(batch))
        m["wall_ms"] = (time.perf_counter() - t0) * 1e3
        m["launches"] = dict(cuda_lib.LAUNCHES)
        m["plain_on_cuda"] = dict(cuda_lib.PLAIN_ON_CUDA)
        out["steps"].append(m)
        if i == 0:      # the clipped gradients of the first step
            out["grads"] = {n: p.grad.detach().cpu().clone()
                            for n, p in task.model.named_parameters()
                            if p.grad is not None}
    out["state"] = {k: v.detach().cpu().clone()
                    for k, v in task.model.state_dict().items()}
    out["loss_state"] = {k: {n: t.cpu() for n, t in v.items()}
                         for k, v in task.loss_state.items()}
    out["hist"] = task.eval_step(batch)["hist"].cpu()
    if not task.is_range:       # this rank's own histogram
        out["local_hist"] = confusion_matrix(
            task.predict_step(batch).reshape(-1),
            batch["labels"].reshape(-1), batch["valid"].reshape(-1),
            task.num_class).cpu()
    return out


def run_ranks(spec: dict, workdir, timeout: float = 900.0) -> list:
    """Write `spec` (its ``init`` and ``out`` under `workdir`), run
    ``spec["world"]`` ranks as processes of this Python, wait for them
    and return each rank's results. A rank that fails raises here with its
    output."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    store = workdir / "store"
    if store.exists():
        store.unlink()
    spec = dict(spec, init=f"file://{store}", out=str(workdir))
    path = workdir / "spec.json"
    path.write_text(json.dumps(spec))
    root = Path(__file__).resolve().parents[2]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "openpcseg_torch.parallel.worker", str(path),
         str(r)], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for r in range(spec["world"])]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"data-parallel ranks {bad} failed:\n"
                           + "\n".join(logs))
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(spec["world"])]


def exact_train_step(task: SegTask, batches) -> dict:
    """One process's exact equivalent of a data-parallel train step over
    len(`batches`) ranks, one batch a rank, for a voxel-input model:
    the concatenated batch's forward (MaskedBatchNorm over every valid row
    is the statistic summed over the ranks), each scan's loss over its own
    voxels (CE and Lovász, as each rank takes them; Cylinder3D's
    point-refinement CE over its own points), their mean, then backward,
    clip and the optimizer step. `task` holds the batch of all
    ranks (``batch_per_device=len(batches)``) and the same LR; returns the
    step's metrics, the clipped gradients stay in ``.grad``."""
    batch = {k: torch.cat([b[k] for b in batches]) for k in batches[0]}
    task.model.train()
    vb, pyr = task.preprocess(batch)
    task.optimizer.zero_grad(set_to_none=True)
    logits, aux = task._run_model(vb, pyr, batch, generator=task.generator)
    scan = vb.voxel_coords[:, 0]
    per_scan = []
    for b in range(len(batches)):
        loss = task.losses(logits, vb.voxel_labels,
                           vb.voxel_valid & (scan == b))
        if "point_refine_logits" in aux:
            loss = loss + cross_entropy(
                aux["point_refine_logits"], vb.point_labels,
                vb.point_valid & (vb.point_batch == b),
                ignore_index=task.losses.ignore_index,
                label_smoothing=task.losses.label_smoothing)
        per_scan.append(loss)
    loss = torch.stack(per_scan).mean()
    lr, grad_norm = task._update(loss)
    return {"loss": loss.detach(), "lr": lr, "num_voxels": vb.num_voxels,
            "voxel_overflow": task.voxel_overflow(vb, pyr),
            "grad_norm": grad_norm}


if __name__ == "__main__":
    rank_main(json.loads(Path(sys.argv[1]).read_text()), int(sys.argv[2]))
