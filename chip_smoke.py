#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--report PATH]

The main path is the voxel-modality eval step of MinkUNet mk34_cr10 at full
width (the MODEL block of tools/cfgs/voxel/semantic_kitti/
minkunet_mk34_cr10.yaml, weights drawn from a seeded torch.Generator) on
131,072-point ray-cast scans, computing in bfloat16 through four
hand-written CUDA kernels (openpcseg_torch/csrc):

  K1 subm gather-GEMM   K3 down gather-GEMM   K4 up parent gather
  K7 trilinear devoxelize

Phases, in order (any failure exits non-zero and prints no result line):
  1. the card's name and power limit; TF32 off for matmuls and cuDNN;
  2. build the kernels with nvcc (sm_90a) from the checkout's sources;
  3. kernel phase: each kernel against its plain PyTorch version on the
     card, at the shapes a real pyramid of ray-cast scan 0 gives it;
  4. serving phase: SegTask answers REQUESTS requests (eval_step +
     predict_step each), with voxel_overflow 0, hist summing to the valid
     point count, every kernel launched and no plain version run on a CUDA
     tensor; p50 latency per scan after a warm-up;
  5. reference phase: the same weights on an 8192-point scan, GPU (bf16,
     kernels) against CPU (float32, plain versions);
  6. a torch.profiler window over one request (device time per kernel);
then the kernel JSON line, the card line and the result line.
The full report (every kernel case, request and profiler row) goes to
--report, by default build/openpcseg_torch/chip_smoke.json.
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
CFGS = {
    "MODALITY": "voxel",
    "DATA": {"DATASET": "semantickitti", "VOXEL_SIZE": 0.05},
    "MODEL": MODEL_CFG,
    "TPU": {"POINT_CAP_PER_SCAN": 131072, "VOXEL_CAP_PER_SCAN": 98304},
}
NUM_CLASS = 20
N_POINTS = 131072
SEED = 0
REQUESTS = 6          # timed requests, after one warm-up request
KERNEL_REPS = 20      # launches per timing of a kernel or its plain version
# kernel vs plain on the card: both take the same bf16 operands and sum in
# float32, so they differ by summation order only (K4's plain version also
# rounds its per-offset products to bf16, as JAX's _up2_fwd_impl does)
KERNEL_TOL = 2e-2     # max|kernel - plain| <= KERNEL_TOL * max|plain|

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
}


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


def kernel_cases(pyr, gen):
    """(kernel, label, wrapper, plain, args) at main-path shapes: every
    channel pair the mk34 forward gives each kernel, on the levels where it
    gives it, with seeded bf16 features (zero on padding rows)."""
    from openpcseg_torch.ops import devox, subm_conv, updown

    def feats(level, c):
        lv = pyr.levels[level]
        x = torch.randn(lv.capacity, c, device="cuda", generator=gen)
        return torch.where(lv.valid[:, None], x, 0.0).to(torch.bfloat16)

    def weight(k, cin, cout):
        return (torch.randn(k, cin, cout, device="cuda", generator=gen)
                / (k * cin) ** 0.5).to(torch.bfloat16)

    cases = []
    for level, cin, cout in [(0, 4, 32), (0, 32, 32), (1, 32, 32),
                             (2, 32, 64), (2, 64, 64), (3, 64, 128),
                             (3, 128, 128), (4, 128, 256), (4, 256, 256),
                             (3, 384, 256), (3, 256, 256), (2, 192, 128),
                             (2, 128, 128), (1, 128, 96), (1, 96, 96),
                             (0, 128, 96), (0, 96, 96)]:
        args = (feats(level, cin), weight(27, cin, cout),
                pyr.levels[level].subm_kmap)
        cases.append(("K1_subm_conv", f"L{level} {cin}->{cout}",
                      subm_conv.subm_conv, subm_conv.subm_conv_plain, args))
    for level, c in [(1, 32), (2, 32), (3, 64), (4, 128)]:
        args = (feats(level - 1, c), weight(8, c, c),
                pyr.levels[level].down_kmap)
        cases.append(("K3_down_conv", f"L{level - 1}->L{level} {c}->{c}",
                      updown.down_conv, updown.down_conv_plain, args))
    for level, cin, cout in [(3, 256, 256), (2, 256, 128), (1, 128, 96),
                             (0, 96, 96)]:
        args = (feats(level + 1, cin), weight(8, cin, cout),
                pyr.levels[level].up_kmap)
        cases.append(("K4_up_conv", f"L{level + 1}->L{level} {cin}->{cout}",
                      updown.up_conv, updown.up_conv_plain, args))
    for level, c in [(4, 256), (2, 128)]:
        tbl = pyr.devox[level]
        args = (feats(level, c), tbl.idx, tbl.weights)
        cases.append(("K7_devoxelize", f"L{level} C={c}",
                      devox.devoxelize, devox.devoxelize_plain, args))
    return cases


def kernel_phase(task, gen, report):
    from openpcseg_torch.data.raycast import raycast_batch
    from openpcseg_torch.engine.task import batch_to_device

    b = batch_to_device(raycast_batch(SEED, 1, cap=N_POINTS), "cuda")
    vb, pyr = task.preprocess(b)
    counts = pyr.level_counts.tolist()
    log(f"[kernels] pyramid of scan {SEED}: voxels per level {counts}, "
        f"caps {task.caps}")
    rows = []
    for name, label, kern, plain, args in kernel_cases(pyr, gen):
        got = kern(*args).float()
        ref = plain(*args).float()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        ok = bool(np.isfinite(err)) and err <= KERNEL_TOL * max(scale, 1e-6)
        ms = cuda_ms(lambda: kern(*args), KERNEL_REPS)
        plain_ms = cuda_ms(lambda: plain(*args), KERNEL_REPS)
        rows.append(dict(kernel=name, shape=label, max_abs_err=err,
                         max_abs_ref=scale, ms=ms, plain_ms=plain_ms, ok=ok))
        log(f"[kernels] {name:14s} {label:18s} max|err| {err:.3e} "
            f"(max|ref| {scale:.3e}) kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms {'ok' if ok else 'MISMATCH'}")
    report["kernel_cases"] = rows
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"kernel phase: {len(bad)} case(s) disagree with "
                         f"their plain versions: {bad}")
    return rows


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
    missing = [k for k, v in launches.items() if v == 0]
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


def profile_phase(task, report):
    from openpcseg_torch.data.raycast import raycast_batch
    from openpcseg_torch.engine.task import batch_to_device
    from torch.profiler import ProfilerActivity, profile

    b = batch_to_device(raycast_batch(SEED + 1, 1, cap=N_POINTS), "cuda")
    task.eval_step(b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        task.eval_step(b)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0.0)
        if dev_us > 0 and e.key and not e.key.startswith("aten::"):
            rows.append((e.key, e.count, dev_us / 1e3))
    rows.sort(key=lambda r: -r[2])
    total = sum(r[2] for r in rows)
    log(f"[profile] device kernel time of one eval_step: {total:.3f} ms "
        f"over {sum(r[1] for r in rows)} kernels; top 12:")
    for k, n, ms in rows[:12]:
        log(f"[profile]   {ms:9.3f} ms  x{n:<5d} {k[:90]}")
    report["profile"] = [dict(kernel=k, count=n, ms=ms) for k, n, ms in rows]
    report["profile_total_device_ms"] = total


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

    kernels = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        heavy = max(mine, key=lambda r: r["plain_ms"])
        kernels.append(dict(
            name=name, route=meta["route"], source=meta["source"],
            replaces=meta["replaces"], launches=launches[meta["counter"]],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=heavy["ms"], plain_ms=heavy["plain_ms"], shape=heavy["shape"]))
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
