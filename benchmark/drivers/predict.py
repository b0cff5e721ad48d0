"""Serving and evaluation traffic: ``SegTask.predict_step`` in a closed
loop with one client. Request i hands the port a numpy batch of ``batch``
scans, pool batch i % n with each scan turned by a transform of its own
(the mix's ``augment``, a heading drawn from the seed), so no two requests
send the same points; it ends when its per-point labels are on the host,
and the next request leaves then. Each request is timed by the host's
clock from the hand-over to the labels' arrival.

Set-up builds the task and sends ``warmup`` requests (the first builds
the kernels). After the window, the labels last served for each pool
batch are kept with the request that served them; ``check_requests`` of
those, drawn from the seed with the one holding the most points always
among them, are compared with the reference's logits of the same
request. A request fails where it raises or runs a plain version of a
kernel on the card, or where its batch overflows the voxel caps (counted
by the reference's voxelize of every request sent).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..lib import checks, program
from ..reference import geometry as G, minkunet as R


def _fault(ctx, b, labels=None):
    """The planted faults: half of a batch left out (half its points where
    it holds one scan), or 1% of the served labels altered."""
    if labels is not None:
        if ctx.fault == "altered":
            flat = labels.reshape(-1)
            pick = np.arange(0, flat.size, 100)
            flat[pick] = (flat[pick] + 1) % ctx.config["num_class"]
        return labels
    if ctx.fault == "half":
        b = dict(b, valid=b["valid"].copy())
        n, np_ = b["valid"].shape
        if n > 1:
            b["valid"][n // 2:] = False
        else:
            b["valid"][:, np_ // 4:] = False
    return b


def _plant(ctx, task):
    """Planted faults of BN in evaluation, for the benchmark's tests: BN
    that ignores its running statistics (``bn_stats``) or its scale and
    shift (``bn_affine``)."""
    if ctx.fault not in ("bn_stats", "bn_affine"):
        return
    kinds = {n: k for n, _, _, k in R.param_spec(ctx.config["MODEL"],
                                                  ctx.config["num_class"])}
    fill = ({"bn_mean": 0.0, "bn_var": 1.0} if ctx.fault == "bn_stats"
            else {"bn_w": 1.0, "bn_b": 0.0})
    with torch.no_grad():
        for n, t in task.model.state_dict().items():
            if kinds.get(n) in fill:
                t.fill_(fill[kinds[n]])


def overflowed(counts, caps) -> bool:
    """Whether a batch's true voxel counts exceed the task's caps."""
    return any(c > cap for c, cap in zip(counts, caps))


def run(ctx):
    from openpcseg_torch.engine.task import batch_to_device
    from openpcseg_torch.ops import cuda_lib

    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    bsz = traffic["batch"]
    batches = ctx.pool.batches(bsz)
    feed = ctx.feed(batches)
    ctx.phase("scan pool ready")
    p0 = ctx.make_weights(batches)
    task = program.build_task(cfg, p0, dev, bsz, False, ctx.seed)
    _plant(ctx, task)
    ctx.phase("weights and task built")
    nb = len(batches)
    caps = list(task.caps)

    def request(i):
        b = feed(i)
        t = time.perf_counter()
        labels = task.predict_step(batch_to_device(_fault(ctx, b), dev))
        labels = _fault(ctx, None, labels.cpu().numpy())
        return labels, (time.perf_counter() - t) * 1e3

    n_warm = traffic["warmup"]
    for i in range(n_warm):
        request(i)
    ctx.sync()
    ctx.phase(f"{n_warm} warm-up requests")
    ctx.mark_setup()

    cuda_lib.reset_counts()
    served, sent, lat, errors = {}, [], [], 0

    def window(n_steps=None, seconds=None):
        nonlocal errors
        t_end = time.perf_counter() + (seconds or 0.0)
        i = n_warm
        while True:
            try:
                labels, ms = request(i)
                served[i % nb] = (i, labels)
                sent.append(i)
                lat.append(ms)
            except RuntimeError as exc:           # counted, the run goes on
                errors += 1
                ctx.log(f"request {i} raised: {exc}")
            i += 1
            done = i - n_warm
            if (done >= n_steps) if n_steps else time.perf_counter() >= t_end:
                break
        ctx.sync()
        return done

    rec = ctx.run_window(window, lambda: feed.prime(n_warm))
    feed.close()
    ctx.phase("window")
    steps, attempted = rec["steps"], len(sent) + errors
    plain = sum(cuda_lib.PLAIN_ON_CUDA.values())
    launches = dict(cuda_lib.LAUNCHES)
    ctx.read_memory()
    del task
    ctx.free()

    # the reference: the voxels of every request sent, then the logits
    # of the sample
    vs = cfg["DATA"]["VOXEL_SIZE"]
    over = set()
    for i in sorted(set(sent)):
        b = feed.make(i)
        counts = G.level_counts(ctx.tensor(b["xyz"]), ctx.tensor(b["valid"]),
                                voxel_size=vs, num_levels=len(caps))
        if overflowed(counts, caps):
            over.add(i)
    n_over = sum(1 for i in sent if i in over)
    failed = attempted if plain else min(attempted, errors + n_over)
    rec.update(mode=traffic["mode"], attempted=attempted, failed=failed,
               scans=max(0, steps - failed) * bsz, latencies_ms=lat,
               launches_per_step={k: v / max(attempted, 1)
                                  for k, v in launches.items() if v})
    if ctx.trace:
        ctx.count_work(rec, feed, n_warm, False)
    ctx.phase("voxel counts of every request")

    points = {j: int(batches[j]["valid"].sum()) for j in served}
    longest = max(points, key=points.get) if points else None
    rng = np.random.default_rng([ctx.seed, 1])
    rest = [j for j in sorted(served) if j != longest]
    k = max(0, min(len(rest), traffic["check_requests"] - 1))
    sample = ([longest] if longest is not None else []) + sorted(
        rng.choice(rest, size=k, replace=False).tolist() if k else [])
    gap = 0.0 if sample else float("inf")
    for j in sample:
        i, labels = served[j]
        geo = G.build(*ctx.tensors(feed.make(i)), voxel_size=vs)
        ref = R.eval_logits(p0, geo, cfg["MODEL"])
        labels = torch.as_tensor(labels).reshape(-1).to(ref.device)
        pv = geo.point_voxel
        hit = pv >= 0
        gap = max(gap, checks.label_gap(ref[pv[hit]], labels[hit]))
    ctx.phase("reference")
    ctx.log(f"compared {len(sample)} requests (requests "
            f"{[served[j][0] for j in sample]}; {points.get(longest, 0)} "
            f"points in the longest)")
    return rec, {"label_gap": gap}
