#!/usr/bin/env python3
"""Where the gather-GEMM's time goes, on one NVIDIA GPU (H100).

    python3 tools/scripts/torch_gather_gemm_breakdown.py [--out PATH]

Builds openpcseg_torch/csrc/gather_gemm.cu four times, each from a copy of
the source with parts of the pipeline's steady state taken out, and times
each build at the main-path shapes of the mk34_cr10 subm convs on ray-cast
scan 0 (131,072 points), with the wrapper's own split rule:

  full      the kernel as it is;
  no_loads  no cp.async after the ring's first stages (the MMAs run on
            stale shared memory): the tensor cores, their fragment reads
            and the barriers;
  no_mma    no fragment reads and no MMAs: the loads and the barriers;
  skeleton  neither: the index slice, the barriers and the epilogue.

The variants compute wrong sums on purpose; only their times mean
anything. Times are CUDA-event means over 20 launches after one warm-up
(each variant's launches back to back, as the kernel runs in a step).
Prints one line per shape and writes the table as JSON to --out.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
SHAPES = [(0, 96, 96), (0, 128, 96), (1, 96, 96), (0, 32, 32), (2, 128, 128),
          (2, 192, 128), (3, 256, 256), (3, 384, 256), (4, 256, 256)]
REPS = 20

# (text in the source, text put in its place) per part taken out
CUT_LOADS = ("    if (nxt < steps) load(nxt, nxt % STAGES);\n", "")
CUT_MMA = ("#pragma unroll\n    for (int kk = 0; kk < BK; kk += 16) {\n",
           "    continue;\n#pragma unroll\n    for (int kk = 0; kk < BK; "
           "kk += 16) {\n")
VARIANTS = {"full": (), "no_loads": (CUT_LOADS,), "no_mma": (CUT_MMA,),
            "skeleton": (CUT_LOADS, CUT_MMA)}


def build(name: str, cuts, out_dir: Path) -> Path:
    from openpcseg_torch.ops import cuda_lib
    src = (cuda_lib.CSRC / "gather_gemm.cu").read_text()
    for old, new in cuts:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: the source no longer has one {old!r}")
        src = src.replace(old, new)
    cu = out_dir / f"gather_gemm_{name}.cu"
    cu.write_text(src)
    so = out_dir / f"gather_gemm_{name}.so"
    flags = [f for f in cuda_lib.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([cuda_lib._find_nvcc(), *flags, "-shared", "-I",
                    str(cuda_lib.CSRC), "-o", str(so), str(cu)], check=True,
                   capture_output=True)
    return so


def entry(so: Path):
    fn = ctypes.CDLL(str(so)).opcs_gather_gemm_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def event_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=ROOT / "build" /
                    "gather_gemm_breakdown.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from openpcseg_torch.data.raycast import raycast_batch
    from openpcseg_torch.engine.task import SegTask, batch_to_device
    from openpcseg_torch.ops.subm_conv import gemm_splits

    out_dir = ROOT / "build" / "gather_gemm_breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        sos = dict(zip(VARIANTS, pool.map(
            lambda kv: build(kv[0], kv[1], out_dir), VARIANTS.items())))
    fns = {name: entry(so) for name, so in sos.items()}
    print(chip_smoke.card_line(), flush=True)

    task = SegTask(chip_smoke.CFGS, chip_smoke.NUM_CLASS, device="cuda",
                   compute_dtype=torch.bfloat16)
    _, pyr = task.preprocess(batch_to_device(
        raycast_batch(chip_smoke.SEED, 1, cap=chip_smoke.N_POINTS), "cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    table = []
    for level, cin, cout in SHAPES:
        lv = pyr.levels[level]
        x = torch.where(lv.valid[:, None], torch.randn(
            lv.capacity, cin, device="cuda", generator=gen), 0.0).to(
                torch.bfloat16)
        w = (torch.randn(27, cin, cout, device="cuda", generator=gen)
             / (27 * cin) ** 0.5).to(torch.bfloat16)
        km = lv.subm_kmap
        n = km.shape[1]
        splits = gemm_splits(n, 27, cin)
        out = torch.empty(n, cout, device="cuda")
        part = torch.empty(splits, n, cout, device="cuda")
        counters = torch.zeros(math.ceil(n / 64) * math.ceil(cout / 32),
                               dtype=torch.int32, device="cuda")
        row = dict(level=level, cin=cin, cout=cout, splits=splits)
        for name, fn in fns.items():
            def call(fn=fn):
                counters.zero_()
                err = fn(x.data_ptr(), w.data_ptr(), km.data_ptr(),
                         out.data_ptr(), part.data_ptr(),
                         counters.data_ptr(), n, 27, cin, cout, 0, splits,
                         stream)
                if err:
                    raise SystemExit(f"{name}: CUDA error {err}")
            row[name] = event_ms(call)
        table.append(row)
        print(f"L{level} {cin}->{cout} (splits {splits}): " + " ".join(
            f"{name} {row[name]:.4f} ms" for name in VARIANTS), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(card=chip_smoke.card_line(),
                                        rows=table), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
