"""Training traffic: ``SegTask.train_step`` over batches of the pool's
scans, each step's scans moved by transforms of their own (the mix's
``augment``: the yaml's rotation, scale, flip and translation), so no two
steps send the same points; the host-to-device copy is inside each step.

Set-up builds one task and drives it through its first ``check_steps``
steps, on the first batches of the pool, which are all distinct scans;
those steps are the warm-up (the first one builds the kernels) and what
the reference follows. The same task then runs the window: steps back to
back, with no synchronize of its own (each step's host-to-device copy
waits for the card), until the window's time is up; one synchronize
closes it. A step fails where it raises, overflows its voxel caps, runs a
plain version of a kernel on the card, or yields a non-finite loss, all
read after the window.
"""
from __future__ import annotations

import json
import math
import time

import torch

from ..lib import checks, program
from ..reference import geometry as G, minkunet as R


# the numbers held to the limits (benchmark/limits/<cell>.json)
COMPARED = ("loss_gap", "grad_gap", "change_gap")


def _fault_batch(ctx, b):
    """Half of the batch left out, the mean taken over the rest (a planted
    fault)."""
    if ctx.fault != "half":
        return b
    b = dict(b, valid=b["valid"].copy())
    b["valid"][b["valid"].shape[0] // 2:] = False
    return b


def _plant(ctx, task):
    """The planted faults of the step itself: a step that leaves its state
    as it was, BN's scales and shifts not updated, or an answer altered
    where it is produced (every 3x3x3 conv's output loses every eighth
    row, as a K1 that skips a tile)."""
    if ctx.fault == "unchanged":
        task.optimizer.step = lambda *a, **k: None
    elif ctx.fault == "bn_grad":
        # BN's scales and shifts left out of the update (for the tests)
        kinds = {n: k for n, _, _, k in R.param_spec(
            ctx.config["MODEL"], ctx.config["num_class"])}
        bn = [p for n, p in task.model.named_parameters()
              if kinds.get(n) in ("bn_w", "bn_b")]
        step = task.optimizer.step

        def without_bn(*a, **k):
            for p in bn:
                p.grad.zero_()
            return step(*a, **k)
        task.optimizer.step = without_bn
    elif ctx.fault == "altered":
        from openpcseg_torch.models.layers import SparseConv

        def drop(module, inputs, out):
            out = out.clone()
            out[::8] = 0
            return out
        for m in task.model.modules():
            if isinstance(m, SparseConv) and m.kind == "subm":
                m.register_forward_hook(drop)


def run(ctx):
    from openpcseg_torch.engine.task import batch_to_device
    from openpcseg_torch.ops import cuda_lib

    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    bsz, n_check = traffic["batch"], traffic["check_steps"]
    p0 = ctx.make_weights(None)
    task = program.build_task(cfg, p0, dev, bsz, True, ctx.seed)
    _plant(ctx, task)
    ctx.phase("weights and task built")
    batches = ctx.pool.batches(bsz)
    feed = ctx.feed(batches)
    ctx.phase("scan pool ready")
    if len(batches) < n_check:
        raise ValueError("the pool holds fewer batches than the checked steps")

    def step(b):
        return task.train_step(batch_to_device(_fault_batch(ctx, b), dev))

    losses, grads1 = [], None
    for s in range(n_check):
        out = step(feed(s))
        losses.append(out["loss"])
        if s == 0:
            grads1 = {n: p.grad.detach().float().clone()
                      for n, p in task.model.named_parameters()}
    ctx.sync()
    ctx.phase(f"{n_check} checked steps")
    prog_losses = [float(v) for v in losses]
    delta = {n: p.detach().float() - p0[n]
             for n, p in task.model.named_parameters()}
    ctx.mark_setup()

    cuda_lib.reset_counts()
    outs, errors = [], 0

    def window(n_steps=None, seconds=None):
        nonlocal errors
        t_end = time.perf_counter() + (seconds or 0.0)
        i = n_check
        while True:
            try:
                outs.append(step(feed(i)))
            except RuntimeError as exc:           # counted, the run goes on
                errors += 1
                ctx.log(f"step {i} raised: {exc}")
            i += 1
            done = i - n_check
            if (done >= n_steps) if n_steps else time.perf_counter() >= t_end:
                break
        ctx.sync()
        return done

    rec = ctx.run_window(window, lambda: feed.prime(n_check))
    feed.close()
    ctx.phase("window")
    steps, attempted = rec["steps"], len(outs) + errors
    launches = dict(cuda_lib.LAUNCHES)
    plain = sum(cuda_lib.PLAIN_ON_CUDA.values())
    bad = 0
    if outs:
        loss = torch.stack([o["loss"] for o in outs]).float().cpu()
        over = torch.stack([o["voxel_overflow"] for o in outs]).cpu()
        bad = int(((~torch.isfinite(loss)) | (over > 0)).sum())
    failed = attempted if plain else min(attempted, bad + errors)
    rec.update(mode="train", scans=max(0, steps - failed) * bsz,
               attempted=attempted, failed=failed, launches_per_step={
                   k: v / max(attempted, 1) for k, v in launches.items()
                   if v})
    ctx.read_memory()
    del task, outs, losses
    ctx.free()

    # the reference: the same weights and batches, float32
    geos = [G.build(*ctx.tensors(feed.make(s)), voxel_size=cfg["DATA"]
                    ["VOXEL_SIZE"]) for s in range(n_check)]
    if ctx.trace:
        ctx.count_work(rec, feed, n_check, True)
    ref_losses, ref_grads, ref_p = R.train_steps(
        p0, geos, cfg["MODEL"], cfg["OPTIM"], bsz,
        cfg["train_scans"] // bsz)
    ref_delta = {n: ref_p[n] - p0[n] for n in ref_p}
    ctx.phase("reference")
    read = checks.train_readings(prog_losses, ref_losses, grads1, ref_grads,
                                 delta, ref_delta)
    ctx.log(f"losses program {prog_losses} reference {ref_losses}")
    ctx.log(f"worst leaves (not compared): gradient {read['grad_leaf']} "
            f"{read['grad_worst']!r}, change {read['change_leaf']} "
            f"{read['change_worst']!r}; left out (reference gradient under "
            f"{checks.TINY_LEAF} of the median leaf's): {read['left_out']}")
    if ctx.dump:
        with open(ctx.dump, "a") as f:
            f.write(json.dumps(dict(seed=ctx.seed, fault=ctx.fault,
                                    leaves=checks.leaf_table(
                                        grads1, ref_grads, delta, ref_delta)))
                    + "\n")
    ctx.log("readings: " + json.dumps(
        {k: v for k, v in read.items() if k != "left_out"}))
    if not all(math.isfinite(v) for v in prog_losses):
        read["loss_gap"] = float("inf")
    return rec, {k: read[k] for k in COMPARED}
