#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--report PATH]

The main paths are the voxel-modality eval step and train step of MinkUNet
mk34_cr10 at full width (the MODEL and OPTIM blocks of tools/cfgs/voxel/
semantic_kitti/minkunet_mk34_cr10.yaml, weights drawn from a seeded
torch.Generator) on 131,072-point ray-cast scans, computing in bfloat16
through eight hand-written CUDA kernels (openpcseg_torch/csrc):

  K1 subm gather-GEMM   K3 down gather-GEMM   K4 up parent gather
  K7 trilinear devoxelize                     (forward, eval and train)
  K2 subm backward      K6 down backward      K5 up backward
  K8 devoxelize transpose                     (backward, train)

Phases, in order (any failure exits non-zero and prints no result line):
  1. the card's name and power limit; TF32 off for matmuls and cuDNN;
  2. build the kernels with nvcc (sm_90a) from the checkout's sources;
  3. kernel phase: the device time of the parity plans (K4's and K6's
     tiling) and of the whole voxelize + geometry pass under
     torch.profiler; then each forward kernel against its plain PyTorch
     version on the card, at the shapes a real pyramid of ray-cast scan 0
     gives it, twice, bit for bit (K4: parentless rows exactly 0);
  4. serving phase: SegTask answers REQUESTS requests (eval_step +
     predict_step each), with voxel_overflow 0, hist summing to the valid
     point count, every forward kernel launched and no plain version run
     on a CUDA tensor; p50 latency per scan after a warm-up;
  5. reference phase: the same weights on an 8192-point scan, GPU (bf16,
     kernels) against CPU (float32, plain versions);
  6. a torch.profiler window over one request (device time per kernel);
  7. backward-kernel phase: each backward kernel against its plain version
     on the card, dfeats and dW apart, at the same pyramid's shapes, and
     twice, bit for bit; K6's dfeats pass (the parent gather) also alone;
  8. training phase: TRAIN_STEPS SegTask.train_steps on the repeated scan
     of seed 1, each with a finite loss and gradient norm, voxel_overflow
     0, every forward and backward kernel launched and no plain version on
     a CUDA tensor; the last loss below the first; scans/s per card;
  9. training-reference phase: one train_step of the same seeded weights
     on an 8192-point scan, GPU (bf16, kernels) against CPU (float32,
     plain versions): loss and gradient cosines;
 10. a torch.profiler window over one train_step (device time per kernel,
     device idle share);
then the kernel JSON line, the card line and the result line.
The full report (every kernel case, request, step and profiler row) goes
to --report, by default build/openpcseg_torch/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# == the MODEL block of tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10.yaml
MODEL_CFG = {
    "NAME": "MinkUNet",
    "IGNORE_LABEL": 0,
    "IN_FEATURE_DIM": 4,
    "BLOCK": "ResBlock",
    "NUM_LAYER": [2, 3, 4, 6, 2, 2, 2, 2],
    "PLANES": [32, 32, 64, 128, 256, 256, 128, 96, 96],
    "cr": 1.0,
    "DROPOUT_P": 0.0,
    "LABEL_SMOOTHING": 0.1,
    "IF_DIST": True,
}
# == the OPTIM block of the same yaml
OPTIM_CFG = {
    "BATCH_SIZE_PER_GPU": 12,
    "NUM_EPOCHS": 36,
    "OPTIMIZER": "sgd",
    "LR_PER_SAMPLE": 0.02,
    "WEIGHT_DECAY": 0.0001,
    "MOMENTUM": 0.9,
    "NESTEROV": True,
    "GRAD_NORM_CLIP": 10,
    "SCHEDULER": "linear_warmup_with_cosdecay",
    "WARMUP_EPOCH": 1,
}
CFGS = {
    "MODALITY": "voxel",
    "DATA": {"DATASET": "semantickitti", "VOXEL_SIZE": 0.05},
    "MODEL": MODEL_CFG,
    "TPU": {"POINT_CAP_PER_SCAN": 131072, "VOXEL_CAP_PER_SCAN": 98304},
}
TRAIN_CFGS = dict(CFGS, OPTIM=OPTIM_CFG)
NUM_CLASS = 20
N_POINTS = 131072
SEED = 0
REQUESTS = 6          # timed requests, after one warm-up request
KERNEL_REPS = 20      # launches per timing of a kernel or its plain version
# kernel vs plain on the card: both take the same bf16 operands and sum in
# float32, so they differ by summation order only (K4's plain version also
# rounds its per-offset products to bf16, as JAX's _up2_fwd_impl does)
KERNEL_TOL = 2e-2     # max|kernel - plain| <= KERNEL_TOL * max|plain|
TRAIN_STEPS = 10      # on one repeated scan, batch 1 (LR = 0.02 x 1 x 1)
ITERS_PER_EPOCH = 4   # so the one-epoch warm-up ends at step 4 of the run
# training reference: one step from the same weights on an 8192-point
# scan, GPU bf16 kernels against the CPU float32 plain versions, bounded
# by (max |loss_gpu - loss_cpu| / |loss_cpu|, min cosine of the whole
# gradient vector, min cosine of any conv weight's gradient). Fixed before
# the first card run at (0.03, 0.98, 0.90), which measured (1.6e-4,
# 0.9715, 0.903). The cause is bf16 itself, not the kernels: the plain
# versions in bf16 against float32 on the CPU read (2.1e-4, 0.9711,
# 0.879), and at bf16 this step at random init is so sensitive that a
# 1e-6 relative change of the subm conv outputs (another summation order)
# alone reads (2.2e-5, 0.9777, 0.913), with CE or Lovász alone as well.
# So the bounds moved to (0.03, 0.95, 0.85): a wrong map or operand in any
# conv's backward still drops its cosine far below. The kernels are held
# to their plain versions one by one in the backward-kernel phase.
TRAIN_REF = (0.03, 0.95, 0.85)
FWD_COUNTERS = ("subm", "down", "up", "devox")

KERNELS = {
    "K1_subm_conv": dict(
        route="cuda", source="openpcseg_torch/csrc/gather_gemm.cu",
        replaces="openpcseg_tpu/ops/pallas_conv.py:364", counter="subm"),
    "K3_down_conv": dict(
        route="cuda", source="openpcseg_torch/csrc/gather_gemm.cu",
        replaces="openpcseg_tpu/ops/pallas_updown.py:144", counter="down"),
    "K4_up_conv": dict(
        route="cuda", source="openpcseg_torch/csrc/parent_gemm.cu",
        replaces="openpcseg_tpu/ops/pallas_updown.py:219", counter="up"),
    "K7_devoxelize": dict(
        route="cuda", source="openpcseg_torch/csrc/devox.cu",
        replaces="openpcseg_tpu/ops/pallas_devox.py:109", counter="devox"),
    # backward kernels: dW of K2 / K5 / K6 is csrc/gather_dw.cu; their
    # dfeats passes run gather_gemm.cu (K2, K5) and parent_gemm.cu (K6)
    "K2_subm_conv_bwd": dict(
        route="cuda", source="openpcseg_torch/csrc/gather_dw.cu",
        dfeats_source="openpcseg_torch/csrc/gather_gemm.cu",
        replaces="openpcseg_tpu/ops/pallas_conv.py:459", counter="subm_bwd"),
    "K5_up_conv_bwd": dict(
        route="cuda", source="openpcseg_torch/csrc/gather_dw.cu",
        dfeats_source="openpcseg_torch/csrc/gather_gemm.cu",
        replaces="openpcseg_tpu/ops/pallas_updown.py:144", counter="up_bwd"),
    "K6_down_conv_bwd": dict(
        route="cuda", source="openpcseg_torch/csrc/gather_dw.cu",
        dfeats_source="openpcseg_torch/csrc/parent_gemm.cu",
        replaces="openpcseg_tpu/ops/pallas_updown.py:219",
        counter="down_bwd"),
    "K8_devoxelize_bwd": dict(
        route="cuda", source="openpcseg_torch/csrc/devox.cu",
        replaces="openpcseg_tpu/ops/pallas_devox.py:277",
        counter="devox_bwd"),
}
SUBM_PAIRS = [(0, 4, 32), (0, 32, 32), (1, 32, 32), (2, 32, 64), (2, 64, 64),
              (3, 64, 128), (3, 128, 128), (4, 128, 256), (4, 256, 256),
              (3, 384, 256), (3, 256, 256), (2, 192, 128), (2, 128, 128),
              (1, 128, 96), (1, 96, 96), (0, 128, 96), (0, 96, 96)]
DOWNS = [(1, 32), (2, 32), (3, 64), (4, 128)]          # (coarse level, C)
UPS = [(3, 256, 256), (2, 256, 128), (1, 128, 96), (0, 96, 96)]  # fine lvl
DEVOX = [(4, 256), (2, 128)]


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def parentless_rows(plan):
    """Fine rows without a parent (the plan's group 8): the parent gather
    must write exact zeros there."""
    return plan.dst_rows[int(plan.group_offsets[8]):].long()


def kernel_cases(pyr, gen):
    """(kernel, label, wrapper, plain, args, zero_rows) at main-path
    shapes: every channel pair the mk34 forward gives each kernel, on the
    levels where it gives it, with seeded bf16 features (zero on padding
    rows). zero_rows: output rows that must be exactly 0, or None."""
    from openpcseg_torch.ops import devox, subm_conv, updown

    def up_plain(x, w, km, plan):
        return updown.up_conv_plain(x, w, km)

    def feats(level, c):
        lv = pyr.levels[level]
        x = torch.randn(lv.capacity, c, device="cuda", generator=gen)
        return torch.where(lv.valid[:, None], x, 0.0).to(torch.bfloat16)

    def weight(k, cin, cout):
        return (torch.randn(k, cin, cout, device="cuda", generator=gen)
                / (k * cin) ** 0.5).to(torch.bfloat16)

    cases = []
    for level, cin, cout in SUBM_PAIRS:
        args = (feats(level, cin), weight(27, cin, cout),
                pyr.levels[level].subm_kmap)
        cases.append(("K1_subm_conv", f"L{level} {cin}->{cout}",
                      subm_conv.subm_conv, subm_conv.subm_conv_plain, args,
                      None))
    for level, c in DOWNS:
        args = (feats(level - 1, c), weight(8, c, c),
                pyr.levels[level].down_kmap)
        cases.append(("K3_down_conv", f"L{level - 1}->L{level} {c}->{c}",
                      updown.down_conv, updown.down_conv_plain, args, None))
    for level, cin, cout in UPS:
        plan = pyr.levels[level + 1].parity_plan
        args = (feats(level + 1, cin), weight(8, cin, cout),
                pyr.levels[level].up_kmap, plan)
        cases.append(("K4_up_conv", f"L{level + 1}->L{level} {cin}->{cout}",
                      updown.up_conv, up_plain, args, parentless_rows(plan)))
    for level, c in DEVOX:
        tbl = pyr.devox[level]
        args = (feats(level, c), tbl.idx, tbl.weights)
        cases.append(("K7_devoxelize", f"L{level} C={c}",
                      devox.devoxelize, devox.devoxelize_plain, args, None))
    return cases


def times(kern, plain, args, on_device: bool) -> dict:
    """CUDA-event ms per call of the kernel's wrapper and of its plain
    version; with on_device (the parent gather, whose wrapper's host time
    can exceed its kernel's) also their device ms under the profiler."""
    t = dict(ms=cuda_ms(lambda: kern(*args), KERNEL_REPS),
             plain_ms=cuda_ms(lambda: plain(*args), KERNEL_REPS))
    if on_device:
        t.update(device_ms=device_ms(lambda: kern(*args), KERNEL_REPS),
                 plain_device_ms=device_ms(lambda: plain(*args),
                                           KERNEL_REPS))
    return t


def times_text(row) -> str:
    text = f"kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms"
    if "device_ms" in row:
        text += (f" (device {row['device_ms']:.4f} ms plain "
                 f"{row['plain_device_ms']:.4f} ms)")
    return text


def kernel_phase(task, gen, report):
    from openpcseg_torch.data.raycast import raycast_batch
    from openpcseg_torch.engine.task import batch_to_device

    b = batch_to_device(raycast_batch(SEED, 1, cap=N_POINTS), "cuda")
    vb, pyr = task.preprocess(b)
    counts = pyr.level_counts.tolist()
    log(f"[kernels] pyramid of scan {SEED}: voxels per level {counts}, "
        f"caps {task.caps}")
    plan_phase(task, b, pyr, report)
    rows = []
    for name, label, kern, plain, args, zero_rows in kernel_cases(pyr, gen):
        got, again = kern(*args), kern(*args)
        ref = plain(*args).float()
        torch.cuda.synchronize()
        same = bool(torch.equal(got, again))
        got = got.float()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        zeros = zero_rows is None or bool((got[zero_rows] == 0).all())
        ok = (bool(np.isfinite(err)) and err <= KERNEL_TOL * max(scale, 1e-6)
              and same and zeros)
        row = dict(kernel=name, shape=label, max_abs_err=err,
                   max_abs_ref=scale, bit_identical=same,
                   parentless_zero=zeros, ok=ok,
                   **times(kern, plain, args, zero_rows is not None))
        rows.append(row)
        log(f"[kernels] {name:14s} {label:18s} max|err| {err:.3e} "
            f"(max|ref| {scale:.3e}) repeat "
            f"{'bit-identical' if same else 'DIFFERS'}"
            f"{'' if zeros else ' NONZERO parentless rows'} "
            f"{times_text(row)} {'ok' if ok else 'MISMATCH'}")
    report["kernel_cases"] = rows
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"kernel phase: {len(bad)} case(s) disagree with "
                         f"their plain versions or do not repeat: {bad}")
    return rows


def plan_phase(task, b, pyr, report):
    """Device time of the parity plans (K4's and K6's tiling), which
    build_pyramid builds once per step and the kernel times below leave
    out, beside that of the whole voxelize + geometry pass."""
    from openpcseg_torch.core.geometry import build_parity_plan

    def plans():
        return [build_parity_plan(pyr.levels[l].down_kmap,
                                  pyr.levels[l - 1].capacity)
                for l in range(1, len(pyr.levels))]
    plan_ms = profile_window("parity_plans", plans, report)
    call_ms = cuda_ms(plans, KERNEL_REPS)
    pre_ms = profile_window("preprocess", lambda: task.preprocess(b), report)
    groups = [lv.parity_plan.group_offsets.tolist() for lv in pyr.levels[1:]]
    log(f"[plans] parity plans of levels 1-4: {plan_ms:.4f} ms of device "
        f"time ({call_ms:.4f} ms per call by CUDA events, host enqueue "
        f"included), of {pre_ms:.4f} ms for voxelize + geometry; group "
        f"offsets per level {groups}")
    report.update(parity_plan_device_ms=plan_ms, parity_plan_call_ms=call_ms,
                  preprocess_device_ms=pre_ms, parity_plan_groups=groups)


def serving_phase(task, report):
    from openpcseg_torch.data.raycast import raycast_batch
    from openpcseg_torch.engine.task import batch_to_device
    from openpcseg_torch.ops import cuda_lib

    scans = [raycast_batch(SEED + 1 + i, 1, cap=N_POINTS)
             for i in range(REQUESTS + 1)]
    cuda_lib.reset_counts()
    lat = []
    reqs = []
    for i, scan in enumerate(scans):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = task.eval_step(batch_to_device(scan, "cuda"))
        hist = out["hist"].cpu()
        ms = (time.perf_counter() - t0) * 1e3
        pred = task.predict_step(batch_to_device(scan, "cuda")).cpu()
        n_valid = int(scan["valid"].sum())
        over = int(out["voxel_overflow"])
        counts = out["level_counts"].tolist()
        log(f"[serve] request {i}{' (warm-up)' if i == 0 else ''}: "
            f"{n_valid} points, voxels per level {counts}, voxel_overflow "
            f"{over}, hist sum {int(hist.sum())} == valid points "
            f"{int(hist.sum()) == n_valid}, eval_step {ms:.2f} ms, "
            f"pred {tuple(pred.shape)}")
        if over != 0 or int(hist.sum()) != n_valid:
            raise SystemExit("serving: overflow or hist/point-count mismatch")
        if tuple(pred.shape) != (1, N_POINTS) or int(pred.min()) < 0 or int(
                pred.max()) >= NUM_CLASS:
            raise SystemExit(f"serving: bad predictions {tuple(pred.shape)}")
        if i > 0:
            lat.append(ms)
        reqs.append(dict(points=n_valid, level_counts=counts,
                         voxel_overflow=over, eval_ms=ms))
    launches = dict(cuda_lib.LAUNCHES)
    plain_on_cuda = dict(cuda_lib.PLAIN_ON_CUDA)
    log(f"[serve] kernel launches {launches}; plain versions on CUDA "
        f"tensors {plain_on_cuda}")
    missing = [k for k in FWD_COUNTERS if launches[k] == 0]
    if missing or any(plain_on_cuda.values()):
        raise SystemExit(f"serving: kernels never launched {missing} or a "
                         f"plain version ran on the card {plain_on_cuda}")
    p50 = statistics.median(lat)
    log(f"[serve] p50 eval_step latency per scan: {p50:.3f} ms over "
        f"{len(lat)} requests (min {min(lat):.3f}, max {max(lat):.3f})")
    report.update(requests=reqs, p50_ms=p50, latencies_ms=lat,
                  launches=launches)
    return launches


def reference_phase(report):
    """Same seeded weights, 8192-point scan: kernels (bf16) on the card
    against the plain versions (float32) on the CPU."""
    from openpcseg_torch.data.raycast import raycast_batch
    from openpcseg_torch.engine.task import SegTask, batch_to_device

    scan = raycast_batch(SEED, 1, cap=8192)
    logits = {}
    for dev, dt in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        t = SegTask(CFGS, NUM_CLASS, device=dev, compute_dtype=dt,
                    voxel_cap_per_scan=8192, seed=SEED)
        _, _, lg = t.forward(batch_to_device(scan, dev))
        logits[dev] = lg.float().cpu()
    g, r = logits["cuda"], logits["cpu"]
    valid = torch.as_tensor(scan["valid"][0])
    err = float((g - r).abs().max() / r.abs().max())
    agree = float((g.argmax(-1) == r.argmax(-1))[valid].float().mean())
    finite = bool(torch.isfinite(g).all())
    log(f"[reference] 8192-point scan, GPU bf16 kernels vs CPU f32 plain: "
        f"logits {tuple(g.shape)} finite {finite}, max|diff|/max|ref| "
        f"{err:.4f}, argmax agreement {agree:.4f}")
    report.update(reference=dict(rel_max_err=err, argmax_agree=agree))
    # bf16 activations over ~40 layers against float32: a few percent of
    # the logit range, and most argmaxes unchanged
    if not finite or err > 0.1 or agree < 0.9:
        raise SystemExit("reference phase: GPU output disagrees with the "
                         "CPU float32 reference")


def _device_rows(prof):
    """(kernel, launches, device ms) of every device kernel in a profile.
    Only device events count, and no annotation: the host-side ranges
    (autograd Functions, aten ops) and the device-side copies of annotated
    ranges (the optimizer step) carry the time of their kernels again."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0.0)
        if (e.device_type == DeviceType.CUDA and dev_us > 0
                and not getattr(e, "is_user_annotation", False)):
            rows.append((e.key, e.count, dev_us / 1e3))
    return rows


def _profiled(fn, calls):
    """torch.profiler over `calls` calls of fn(), after one unprofiled
    call; returns the profile."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return prof


def device_ms(fn, reps: int) -> float:
    """Device kernel time per call of fn() under torch.profiler. CUDA
    events time a call from its first enqueue to its last kernel's end, so
    where the host's enqueue takes longer than the kernels, as for the
    parent gather, they read the host."""
    return sum(r[2] for r in _device_rows(_profiled(fn, reps))) / reps


def profile_window(label, step, report):
    """Device time per kernel over one call of step() under torch.profiler
    (after one unprofiled call); returns the total device kernel ms."""
    rows = _device_rows(_profiled(step, 1))
    if not rows:
        raise SystemExit(f"profiler: no device time recorded for {label}")
    rows.sort(key=lambda r: -r[2])
    total = sum(r[2] for r in rows)
    log(f"[profile] device kernel time of one {label}: {total:.3f} ms "
        f"over {sum(r[1] for r in rows)} kernels; top 12:")
    for k, n, ms in rows[:12]:
        log(f"[profile]   {ms:9.3f} ms  x{n:<5d} {k[:90]}")
    report[f"profile_{label}"] = [dict(kernel=k, count=n, ms=ms)
                                  for k, n, ms in rows]
    report[f"profile_{label}_total_device_ms"] = total
    return total


def profile_phase(task, report):
    from openpcseg_torch.data.raycast import raycast_batch
    from openpcseg_torch.engine.task import batch_to_device

    b = batch_to_device(raycast_batch(SEED + 1, 1, cap=N_POINTS), "cuda")
    profile_window("eval_step", lambda: task.eval_step(b), report)


def backward_cases(pyr, gen):
    """(kernel, label, wrapper, plain, args, zero_rows) of each backward
    kernel at the shapes the mk34 training step gives it: upstream
    gradients in float32 (zero on padding rows, as the masked forward
    leaves them), saved bf16 activations, float32 weights. K6 also runs its
    dfeats pass alone (label "... dfeats"), the parent gather with W^T
    against the plain dfeats."""
    from openpcseg_torch.ops import devox, subm_conv, updown
    from openpcseg_torch.ops.sparse_conv import _conv_apply

    def down_bwd_plain(dout, feats, w, kmap, up_kmap, plan):
        return updown.down_conv_bwd_plain(dout, feats, w, kmap, up_kmap)

    def dfeats(dout, w, up_kmap, plan):
        return (updown.parent_gemm(dout.to(torch.bfloat16).contiguous(),
                                   w.transpose(1, 2), plan, "down_bwd"),)

    def dfeats_plain(dout, w, up_kmap, plan):
        return (_conv_apply(dout, w.transpose(1, 2), up_kmap, None,
                            torch.bfloat16),)

    def rand(level, c, dtype):
        lv = pyr.levels[level]
        x = torch.randn(lv.capacity, c, device="cuda", generator=gen)
        return torch.where(lv.valid[:, None], x, 0.0).to(dtype)

    def weight(k, cin, cout):
        return torch.randn(k, cin, cout, device="cuda",
                           generator=gen) / (k * cin) ** 0.5

    bf, f32 = torch.bfloat16, torch.float32
    cases = []
    for level, cin, cout in SUBM_PAIRS:
        lv = pyr.levels[level]
        args = (rand(level, cout, f32), rand(level, cin, bf),
                weight(27, cin, cout), lv.subm_kmap)
        cases.append(("K2_subm_conv_bwd", f"L{level} {cin}->{cout}",
                      subm_conv.subm_conv_bwd, subm_conv.subm_conv_bwd_plain,
                      args, None))
    for level, c in DOWNS:
        fine, coarse = pyr.levels[level - 1], pyr.levels[level]
        plan = coarse.parity_plan
        d, w = rand(level, c, f32), weight(8, c, c)
        label = f"L{level - 1}->L{level} {c}->{c}"
        args = (d, rand(level - 1, c, bf), w, coarse.down_kmap, fine.up_kmap,
                plan)
        cases.append(("K6_down_conv_bwd", label, updown.down_conv_bwd,
                      down_bwd_plain, args, None))
        cases.append(("K6_down_conv_bwd", label + " dfeats", dfeats,
                      dfeats_plain, (d, w, fine.up_kmap, plan),
                      parentless_rows(plan)))
    for level, cin, cout in UPS:
        fine, coarse = pyr.levels[level], pyr.levels[level + 1]
        args = (rand(level, cout, f32), rand(level + 1, cin, bf),
                weight(8, cin, cout), fine.up_kmap, coarse.down_kmap)
        cases.append(("K5_up_conv_bwd", f"L{level + 1}->L{level} "
                      f"{cin}->{cout}", updown.up_conv_bwd,
                      updown.up_conv_bwd_plain, args, None))
    for level, c in DEVOX:
        tbl = pyr.devox[level]
        d = torch.randn(tbl.idx.shape[1], c, device="cuda", generator=gen)
        d = torch.where(pyr.points.valid[:, None], d, 0.0).to(bf)
        cases.append(("K8_devoxelize_bwd", f"L{level} C={c}",
                      lambda *a: (devox.devoxelize_bwd(*a),),
                      lambda *a: (devox.devoxelize_bwd_plain(*a),),
                      (d, tbl), None))
    return cases


def backward_kernel_phase(task, gen, report):
    """Each backward kernel against its plain version, per output, and a
    bit-identical repeat; CUDA-event times of the whole backward (and of
    K6's dfeats pass alone)."""
    from openpcseg_torch.data.raycast import raycast_batch
    from openpcseg_torch.engine.task import batch_to_device

    b = batch_to_device(raycast_batch(SEED, 1, cap=N_POINTS), "cuda")
    _, pyr = task.preprocess(b)
    rows = []
    for name, label, kern, plain, args, zero_rows in backward_cases(pyr,
                                                                    gen):
        got, again, ref = kern(*args), kern(*args), plain(*args)
        torch.cuda.synchronize()
        errs, scales, same = [], [], True
        for g, a, r in zip(got, again, ref):
            errs.append(float((g.float() - r.float()).abs().max()))
            scales.append(float(r.float().abs().max()))
            same = same and bool(torch.equal(g, a))
        zeros = zero_rows is None or bool((got[0][zero_rows] == 0).all())
        ok = same and zeros and all(
            np.isfinite(e) and e <= KERNEL_TOL * max(sc, 1e-6)
            for e, sc in zip(errs, scales))
        row = dict(kernel=name, shape=label, max_abs_err=max(errs),
                   errs=errs, max_abs_ref=scales,
                   max_rel_err=max(e / max(sc, 1e-30)
                                   for e, sc in zip(errs, scales)),
                   bit_identical=same, parentless_zero=zeros, ok=ok,
                   **times(kern, plain, args, zero_rows is not None))
        rows.append(row)
        outs = " ".join(f"{o} {e:.3e}/{sc:.3e}" for o, e, sc in
                        zip(("dvox",) if name.startswith("K8") else
                            ("dfeats", "dW"), errs, scales))
        log(f"[bwd] {name:17s} {label:25s} max|err|/max|ref| {outs} "
            f"repeat {'bit-identical' if same else 'DIFFERS'}"
            f"{'' if zeros else ' NONZERO parentless rows'} "
            f"{times_text(row)} {'ok' if ok else 'MISMATCH'}")
    report["backward_cases"] = rows
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"backward-kernel phase: {len(bad)} case(s) "
                         f"disagree with their plain versions or do not "
                         f"repeat: {bad}")
    return rows


def training_phase(report):
    """TRAIN_STEPS full-width train steps on the repeated scan of seed 1,
    every counter read per step."""
    from openpcseg_torch.data.raycast import raycast_batch
    from openpcseg_torch.engine.task import SegTask, batch_to_device
    from openpcseg_torch.ops import cuda_lib

    task = SegTask(TRAIN_CFGS, NUM_CLASS, device="cuda",
                   compute_dtype=torch.bfloat16, seed=SEED,
                   iters_per_epoch=ITERS_PER_EPOCH)
    scan = raycast_batch(SEED + 1, 1, cap=N_POINTS)
    steps, totals = [], dict.fromkeys(cuda_lib.COUNTERS, 0)
    for i in range(TRAIN_STEPS):
        cuda_lib.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = task.train_step(batch_to_device(scan, "cuda"))
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(cuda_lib.LAUNCHES)
        plain_on_cuda = dict(cuda_lib.PLAIN_ON_CUDA)
        over = int(m["voxel_overflow"])
        log(f"[train] step {i}: loss {loss:.5f} grad_norm {gnorm:.4f} lr "
            f"{m['lr']:.6f} voxels {int(m['num_voxels'])} voxel_overflow "
            f"{over} wall {ms:.2f} ms launches {launches}")
        if not (np.isfinite(loss) and np.isfinite(gnorm)) or over != 0:
            raise SystemExit(f"training: step {i} loss {loss} grad norm "
                             f"{gnorm} voxel_overflow {over}")
        missing = [k for k, v in launches.items() if v == 0]
        if missing or any(plain_on_cuda.values()):
            raise SystemExit(f"training: step {i} never launched {missing} "
                             f"or ran a plain version on the card "
                             f"{plain_on_cuda}")
        for k, v in launches.items():
            totals[k] += v
        steps.append(dict(loss=loss, grad_norm=gnorm, lr=m["lr"],
                          voxel_overflow=over, wall_ms=ms,
                          launches=launches))
    if not steps[-1]["loss"] < steps[0]["loss"]:
        raise SystemExit(f"training: the last loss {steps[-1]['loss']} is "
                         f"not below the first {steps[0]['loss']}")
    med = statistics.median(s["wall_ms"] for s in steps[1:])
    log(f"[train] median train_step {med:.3f} ms over steps 1..{len(steps)-1}"
        f" = {1e3 / med:.3f} scans/s per card (batch 1); loss "
        f"{steps[0]['loss']:.5f} -> {steps[-1]['loss']:.5f}; launches over "
        f"the phase {totals}")
    report.update(train_steps=steps, train_median_ms=med,
                  train_scans_per_s=1e3 / med, train_launches=totals)
    b = batch_to_device(scan, "cuda")
    device_ms = profile_window("train_step", lambda: task.train_step(b),
                               report)
    idle = 1.0 - device_ms / med
    log(f"[profile] train_step device idle share {idle:.4f} (device "
        f"{device_ms:.3f} ms of the {med:.3f} ms median step)")
    report["train_idle_share"] = idle
    return totals


def train_reference_phase(report):
    """One train_step from the same seeded weights on an 8192-point scan:
    GPU (bf16, kernels) against CPU (float32, plain versions); bounds in
    TRAIN_REF."""
    from openpcseg_torch.data.raycast import raycast_batch
    from openpcseg_torch.engine.task import SegTask, batch_to_device
    from openpcseg_torch.models.layers import SparseConv

    scan = raycast_batch(SEED, 1, cap=8192)
    loss, grads, convs = {}, {}, None
    for dev, dt in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        t = SegTask(TRAIN_CFGS, NUM_CLASS, device=dev, compute_dtype=dt,
                    voxel_cap_per_scan=8192, seed=SEED,
                    iters_per_epoch=ITERS_PER_EPOCH)
        m = t.train_step(batch_to_device(scan, dev))
        loss[dev] = float(m["loss"])
        # the clipped gradients stay in .grad; a cosine ignores the scale
        grads[dev] = {n: p.grad.double().cpu().reshape(-1)
                      for n, p in t.model.named_parameters()}
        convs = [n + ".weight" for n, mod in t.model.named_modules()
                 if isinstance(mod, SparseConv)]

    def cos(a, b):
        return float(a @ b / (a.norm() * b.norm()).clamp(min=1e-300))
    g, r = grads["cuda"], grads["cpu"]
    max_rel, min_all, min_conv = TRAIN_REF
    cos_all = cos(torch.cat([g[n] for n in r]), torch.cat(list(r.values())))
    cos_conv = {n: cos(g[n], r[n]) for n in convs}
    worst = min(cos_conv, key=cos_conv.get)
    rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    log(f"[train-ref] 8192-point scan, one train_step, GPU bf16 kernels vs "
        f"CPU f32 plain: loss {loss['cuda']:.6f} vs {loss['cpu']:.6f} "
        f"(rel {rel:.3e} <= {max_rel}); whole-gradient cosine "
        f"{cos_all:.6f} (>= {min_all}); conv weight gradient cosines over "
        f"{len(convs)} convs: min {cos_conv[worst]:.6f} at {worst} "
        f"(>= {min_conv}), median "
        f"{statistics.median(cos_conv.values()):.6f}")
    report.update(train_reference=dict(
        loss_gpu=loss["cuda"], loss_cpu=loss["cpu"], loss_rel=rel,
        cos_all=cos_all, cos_conv=cos_conv))
    if not (rel <= max_rel and cos_all >= min_all
            and cos_conv[worst] >= min_conv):
        raise SystemExit("training-reference phase: GPU step disagrees with "
                         "the CPU float32 reference")


def kernel_report(rows, launches):
    """The kernels JSON line: per kernel its launches on the main path and
    the case with the slowest plain version; K6 also its dfeats pass alone
    (the parent gather), K4 and that pass their device times too."""
    kernels = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        whole = [r for r in mine if not r["shape"].endswith(" dfeats")]
        heavy = max(whole, key=lambda r: r["plain_ms"])
        row = dict(
            name=name, route=meta["route"], source=meta["source"],
            replaces=meta["replaces"], launches=launches[meta["counter"]],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=heavy["ms"], plain_ms=heavy["plain_ms"], shape=heavy["shape"])
        row.update({k: heavy[k] for k in ("device_ms", "plain_device_ms")
                    if k in heavy})
        if "dfeats_source" in meta:
            row.update(dfeats_source=meta["dfeats_source"],
                       dw_launches=launches["dw"])
        part = [r for r in mine if r["shape"].endswith(" dfeats")]
        if part:   # K6: its dfeats pass (the parent gather) alone
            h = max(part, key=lambda r: r["plain_ms"])
            row.update(dfeats_ms=h["ms"], dfeats_plain_ms=h["plain_ms"],
                       dfeats_device_ms=h["device_ms"],
                       dfeats_plain_device_ms=h["plain_device_ms"],
                       dfeats_shape=h["shape"])
        kernels.append(row)
    return kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--report", type=Path,
                    default=ROOT / "build" / "openpcseg_torch" /
                    "chip_smoke.json", help="where the full JSON report goes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from openpcseg_torch.engine.task import SegTask
    from openpcseg_torch.ops import cuda_lib

    card = card_line()
    log(f"[card] {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    report = {"card": card, "torch": torch.__version__}

    t0 = time.perf_counter()
    cuda_lib.lib()
    log(f"[build] nvcc sm_90a build of {cuda_lib.CSRC.name}/*.cu: "
        f"{time.perf_counter() - t0:.2f} s (nvcc {cuda_lib.BUILD_INFO['seconds']:.2f} s, "
        f"cached {cuda_lib.BUILD_INFO['cached']}) -> {cuda_lib.BUILD_INFO['path']}")
    for line in cuda_lib.BUILD_INFO.get("ptxas", "").splitlines():
        if "registers" in line:
            log(f"[build] ptxas:{line.split(':', 1)[1]}")
    report["build_s"] = cuda_lib.BUILD_INFO["seconds"]

    task = SegTask(CFGS, NUM_CLASS, device="cuda",
                   compute_dtype=torch.bfloat16, seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = kernel_phase(task, gen, report)
    launches = serving_phase(task, report)
    reference_phase(report)
    profile_phase(task, report)
    rows += backward_kernel_phase(task, gen, report)
    del task
    launches.update({k: v for k, v in training_phase(report).items()
                     if k not in FWD_COUNTERS})
    train_reference_phase(report)

    kernels = kernel_report(rows, launches)
    args.report.parent.mkdir(parents=True, exist_ok=True)
    args.report.write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
