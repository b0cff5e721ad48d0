"""Golden surrogate runs of MinkUNet, SPVCNN, RPVNet, Cylinder3D and the
range models (CENet, FIDNet, RangeNet, SalsaNext): the convergence gate of
the port.

Counterpart of ``tools/scripts/golden_run.py`` for the minkunet, spvcnn,
rpvnet, cylinder, cenet, fidnet, rangenet and salsanext models
(``--model``, the blocks of its ``model_setup``). With no dataset
it trains on the ray-cast surrogate (``data/raycast.py``): 128 train scans
(seeds 0-127) and 16 held-out val scans (seeds 10000-10015), each
``raycast_batch(seed, 1, cap=131072)``; batch 1, the model's widths, the
SGD recipe of the mk34 yamls, the LR warmed up over the first
``--warmup_frac`` of the steps and cosine-decayed to the last. Every
``--eval_every`` steps it reads the val mIoU over the classes present in
the val ground truth (``utils.metrics.gt_present_miou``) and writes the
curves to ``--out``. The gate: the mean of the last 3 evals is at least
the model's ``accept_threshold`` in ``GOLDEN_r05_summary.json``, with no
voxel dropped; the payload's ``gate`` says whether it passed. The summary
has no RPVNet entry: its threshold, derived from JAX's two RPVNet runs by
the summary's rule, stands in ``golden_gates.json`` beside this file, and
``accept_threshold`` reads a model there first.

RPVNet runs JAX's protocol model, mk18 at cr 1.0 (NUM_LAYER [2] * 8,
IN_FEATURE_DIM 5), on each scan made a fusion batch (``to_fusion``): the
ray-cast scans have no ring ids, so each point's image row is its
inclination binned into 64 rows over +3 / -25 degrees, and
``build_fusion_range_image`` draws its azimuth cut from
``np.random.default_rng(seed)`` of the scan's seed.

A range model takes its yaml's MODEL block with KNN_POST off, the same
SGD recipe, and each scan projected to a 64 x 2048 range image
(``data/range_view.py range_project`` + ``pack_scan_tensor`` over the
scan's valid points); its eval counts pixels.

    python -m openpcseg_torch.cli.golden_run --model spvcnn --seed 0 \\
        --out GOLDEN_torch_spvcnn_s0.json
    python -m openpcseg_torch.cli.golden_run --model cylinder --seed 0 \\
        --out GOLDEN_torch_cylinder_s0.json
    python -m openpcseg_torch.cli.golden_run --model cenet --seed 0 \\
        --out GOLDEN_torch_cenet_s0.json
    python -m openpcseg_torch.cli.golden_run --model rpvnet --seed 0 \\
        --out GOLDEN_torch_rpvnet_s0.json
    python -m openpcseg_torch.cli.golden_run --data_path <kitti sequences>

With ``--data_path`` it runs the port's training CLI on a real tree
instead. The ray-cast scans are made once (in ``--workers`` processes) and
kept in ``build/openpcseg_torch/golden_scans_<n_train>_v<n_val>_c<cap>.npz``;
a run without that file makes it again.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from functools import partial
from pathlib import Path

import numpy as np
import torch

from openpcseg_torch.data.raycast import raycast_batch

ROOT = Path(__file__).resolve().parents[2]
CFG_FILES = {
    "minkunet": "tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10.yaml",
    "spvcnn": "tools/cfgs/fusion/semantic_kitti/spvcnn_mk34_cr10.yaml",
    "rpvnet": "tools/cfgs/fusion/semantic_kitti/rpvnet_mk18_cr10.yaml",
    "cylinder": "tools/cfgs/voxel/semantic_kitti/cylinder_cy480_cr10.yaml",
    "cenet": "tools/cfgs/range/semantic_kitti/cenet_64x2048.yaml",
    "fidnet": "tools/cfgs/range/semantic_kitti/fidnet_64x2048.yaml",
    "rangenet": "tools/cfgs/range/semantic_kitti/rangenet_64x2048.yaml",
    "salsanext": "tools/cfgs/range/semantic_kitti/salsanext_64x2048.yaml",
}
RANGE_MODELS = ("cenet", "fidnet", "rangenet", "salsanext")
RANGE_H, RANGE_W = 64, 2048
# the ray-cast surrogate's NUM_LAYER per model (tools/scripts/golden_run.py)
NUM_LAYER = {"minkunet": [2, 3, 4, 6, 2, 2, 2, 2], "spvcnn": [2] * 8,
             "rpvnet": [2] * 8}
SUMMARY = "GOLDEN_r05_summary.json"
# the port's own gates, for models the summary has no entry for
GATES = Path(__file__).resolve().parent / "golden_gates.json"
NUM_CLASS = 20
VAL_SEED0 = 10_000


def run_real(args) -> int:
    """A real tree: the port's training CLI on the model's mk34 yaml."""
    cmd = [sys.executable, "-m", "openpcseg_torch.cli.train",
           "--cfg_file", CFG_FILES[args.model], "--extra_tag",
           f"golden_{args.model}",
           "--log_interval", "20", "--device", args.device]
    if args.epochs:
        cmd += ["--epochs", str(args.epochs)]
    cmd += ["--set", "DATA.DATA_PATH", args.data_path]
    return subprocess.call(cmd, cwd=ROOT)


def base_optim(batch: int = 1) -> dict:
    return {"BATCH_SIZE_PER_GPU": batch, "NUM_EPOCHS": 36,
            "OPTIMIZER": "sgd", "LR_PER_SAMPLE": 0.02,
            "WEIGHT_DECAY": 0.0001, "MOMENTUM": 0.9, "NESTEROV": True,
            "GRAD_NORM_CLIP": 10,
            "SCHEDULER": "linear_warmup_with_cosdecay", "WARMUP_EPOCH": 1}


def model_setup(cr: float, voxel_cap: int = 98304,
                model: str = "minkunet") -> dict:
    if model in RANGE_MODELS:
        from openpcseg_torch.config import CfgDict, cfg_from_yaml_file
        ycfg = CfgDict()
        cfg_from_yaml_file(str(ROOT / CFG_FILES[model]), ycfg)
        return {
            "MODALITY": "range",
            "DATA": {"DATASET": "semantickitti", "H": RANGE_H,
                     "W": RANGE_W},
            "MODEL": dict(ycfg.MODEL, KNN_POST=False),
            "OPTIM": base_optim(),
            "TPU": {},
        }
    if model == "cylinder":     # INIT_SIZE 32 whatever `cr`, as in JAX
        return {
            "MODALITY": "cylinder",
            "DATA": {"DATASET": "semantickitti",
                     "CYLINDER_GRID_SIZE": [480, 360, 32],
                     "CYLINDER_SPACE_MAX": [50, 180, 2],
                     "CYLINDER_SPACE_MIN": [0, -180, -4]},
            "MODEL": {
                "NAME": "Cylinder_TS", "IGNORE_LABEL": 0,
                "IN_FEATURE_DIM": 9, "DROPOUT_P": 0.0,
                "LABEL_SMOOTHING": 0.0, "INIT_SIZE": 32,
                "POINT_REFINEMENT": True,
            },
            "OPTIM": base_optim(),
            "TPU": {"VOXEL_CAP_PER_SCAN": voxel_cap},
        }
    cfgs = {
        "DATA": {"DATASET": "semantickitti", "VOXEL_SIZE": 0.05},
        "MODEL": {
            "NAME": {"minkunet": "MinkUNet", "spvcnn": "SPVCNN",
                     "rpvnet": "RPVNet"}[model],
            "IGNORE_LABEL": 0, "IN_FEATURE_DIM": 5 if model == "rpvnet" else 4,
            "BLOCK": "ResBlock", "NUM_LAYER": list(NUM_LAYER[model]),
            "PLANES": [32, 32, 64, 128, 256, 256, 128, 96, 96],
            "cr": cr, "DROPOUT_P": 0.0, "LABEL_SMOOTHING": 0.1,
        },
        "OPTIM": base_optim(),
        "TPU": {"VOXEL_CAP_PER_SCAN": voxel_cap},
    }
    if model == "rpvnet":
        cfgs["MODALITY"] = "fusion"
    return cfgs


def gate_source(model: str) -> Path:
    """The file that holds the model's accept_threshold: the port's
    golden_gates.json where it names the model, else the summary."""
    if model in json.loads(GATES.read_text())["models"]:
        return GATES
    return ROOT / SUMMARY


def accept_threshold(model: str) -> float:
    """The model's gate: its accept_threshold in GOLDEN_r05_summary.json,
    the JAX package's tail mIoU over two seeds less their spread, or, for
    a model the summary lacks, in golden_gates.json (the same rule over
    the same kind of JAX runs)."""
    data = json.loads(gate_source(model).read_text())
    return float(data["models"][model]["accept_threshold"])


def describe_device(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    CPU."""
    if device.type != "cuda":
        return "cpu"
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        line = f"{torch.cuda.get_device_name(device)}, power limit unread"
    return line


def to_range(b: dict) -> dict:
    """A cached ray-cast scan (batch of 1) as a range-view batch: its valid
    points projected to RANGE_H x RANGE_W (JAX golden_run's to_range)."""
    from openpcseg_torch.data.range_view import pack_scan_tensor, range_project
    v = b["valid"][0].astype(bool)
    s = range_project(b["xyz"][0][v], b["feats"][0][v, 3],
                      b["labels"][0][v], RANGE_H, RANGE_W)
    scan, label, mask = pack_scan_tensor(s)
    return {"scan": scan[None], "label": label[None], "mask": mask[None]}


def to_fusion(b: dict, seed: int, h: int = RANGE_H,
              w: int = RANGE_W) -> dict:
    """A cached ray-cast scan (batch of 1) as a fusion batch (JAX
    golden_run's to_fusion): the features [x, y, z, intensity, row], the
    h x w range image and each point's pxpy, the row the point's
    inclination binned over +3 / -25 degrees (the scans have no ring ids),
    computed over every point of the scan, padding included, as JAX
    does."""
    from openpcseg_torch.data.fusion_view import build_fusion_range_image
    xyz = b["xyz"][0]
    inten = b["feats"][0][:, 3:4]
    depth = np.maximum(np.linalg.norm(xyz, 2, axis=1), 1e-6)
    pitch = np.arcsin(np.clip(xyz[:, 2] / depth, -1, 1))
    fov_up, fov_down = 3.0 * np.pi / 180, -25.0 * np.pi / 180
    row = np.clip((1.0 - (pitch - fov_down) / (fov_up - fov_down))
                  * (h - 1), 0, h - 1)
    pts5 = np.concatenate([xyz, inten, row[:, None].astype(np.float32)],
                          axis=1)
    img, pxpy = build_fusion_range_image(
        pts5, h, w, np.random.default_rng(seed), row=row)
    return {"xyz": b["xyz"], "feats": pts5[None], "labels": b["labels"],
            "valid": b["valid"], "range_image": img[None],
            "pxpy": pxpy[None]}


def load_scans(n_train: int, n_val: int, cap: int, workers: int,
               cache: Path) -> dict:
    """{seed: host batch} of the train and val scans: from the cache file
    when it is there, else ray-cast (in `workers` processes) and cached."""
    keys = ("xyz", "feats", "labels", "valid")
    seeds = list(range(n_train)) + [VAL_SEED0 + v for v in range(n_val)]
    if cache.exists():
        z = np.load(cache)
        return {s: {k: z[f"{s}_{k}"] for k in keys} for s in seeds}
    t0 = time.time()
    make = partial(raycast_batch, batch_size=1, cap=cap)
    if workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
            host = dict(zip(seeds, pool.map(make, seeds)))
    else:
        host = dict(zip(seeds, map(make, seeds)))
    print(f"ray-cast {len(host)} scans in {time.time() - t0:.1f} s "
          f"({workers} processes)", flush=True)
    cache.parent.mkdir(parents=True, exist_ok=True)
    tmp = cache.with_name(cache.stem + f".{os.getpid()}.tmp.npz")
    np.savez(tmp, **{f"{s}_{k}": v for s, b in host.items()
                     for k, v in b.items()})
    tmp.replace(cache)
    return host


def run_surrogate(args) -> dict:
    from openpcseg_torch.engine.task import SegTask, batch_to_device
    from openpcseg_torch.utils.metrics import gt_present_miou

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"golden_run: device {device} asked for, but "
                           "torch sees no CUDA device (--device cpu runs "
                           "on the CPU)")
    cfgs = model_setup(args.cr, args.voxel_cap, args.model)
    if args.lr_scale != 1.0:
        cfgs["OPTIM"]["LR_PER_SAMPLE"] *= args.lr_scale
    cache = Path(args.cache_dir) / (f"golden_scans_{args.n_train}_v"
                                    f"{args.n_val}_c{args.point_cap}.npz")
    t0 = time.time()
    host = load_scans(args.n_train, args.n_val, args.point_cap,
                      args.workers, cache)
    if args.model in RANGE_MODELS:
        host = {s: to_range(b) for s, b in host.items()}
    elif args.model == "rpvnet":
        host = {s: to_fusion(b, s) for s, b in host.items()}
    print(f"scan cache ready ({time.time() - t0:.0f}s)", flush=True)

    # warmup_frac of the steps ramp the LR (WARMUP_EPOCH 1 = one "epoch" of
    # `warm` steps), then the cosine decays it to the last step
    warm = max(1, int(args.steps * args.warmup_frac))
    task = SegTask(cfgs, NUM_CLASS, device=device, seed=args.seed,
                   batch_per_device=1, iters_per_epoch=warm,
                   total_epochs=max(1, args.steps // warm),
                   compute_dtype=(torch.bfloat16 if device.type == "cuda"
                                  else torch.float32))
    on_dev = {s: batch_to_device(b, device) for s, b in host.items()}

    order = np.random.default_rng(args.seed).permutation(args.n_train)
    losses, curve, curve_raw, perclass = [], [], [], []
    overflow = torch.zeros((), dtype=torch.int64, device=device)
    pend = []
    t0 = time.time()
    for it in range(args.steps):
        m = task.train_step(on_dev[int(order[it % args.n_train])])
        pend.append(m["loss"])
        overflow = torch.maximum(overflow, m["voxel_overflow"].long())
        if (it + 1) % args.loss_every == 0:
            losses.append((it + 1, float(torch.stack(pend).float().mean())))
            pend.clear()
            print(f"step {it + 1}: loss {losses[-1][1]:.4f} "
                  f"({(time.time() - t0) / (it + 1) * 1e3:.0f} ms/step)",
                  flush=True)
        if (it + 1) % args.eval_every == 0 or it + 1 == args.steps:
            hist = torch.zeros(NUM_CLASS, NUM_CLASS, dtype=torch.int64,
                               device=device)
            for v in range(args.n_val):
                hist += task.eval_step(on_dev[VAL_SEED0 + v])["hist"]
            miou, miou_raw, per = gt_present_miou(hist.cpu().numpy(),
                                                  NUM_CLASS)
            curve.append((it + 1, miou))
            curve_raw.append((it + 1, miou_raw))
            perclass.append((it + 1, [round(float(x), 2) for x in per]))
            print(f"step {it + 1}: val mIoU {miou:.2f} "
                  f"(union-denominator {miou_raw:.2f})", flush=True)
    wall = time.time() - t0
    tail = [v for _, v in curve[-3:]]
    tail_mean = float(np.mean(tail)) if tail else None
    threshold = accept_threshold(args.model)
    passed = bool(tail_mean is not None and tail_mean >= threshold
                  and int(overflow) == 0)
    source = gate_source(args.model).relative_to(ROOT).as_posix()
    print(f"gate: tail mean {tail_mean} against {args.model}'s "
          f"accept_threshold {threshold} ({source}), voxel_overflow max "
          f"{int(overflow)}: {'passed' if passed else 'MISSED'}", flush=True)
    payload = {
        "kind": "raycast_surrogate",
        "model": f"{args.model} cr={args.cr}",
        "seed": args.seed,
        "lr_scale": args.lr_scale,
        "warmup_frac": args.warmup_frac,
        "schedule": (f"linear warmup {warm} steps + cosine decay to step "
                     f"{args.steps}" if args.warmup_frac < 1.0
                     else "all-warmup"),
        "steps": args.steps,
        "n_train_scans": args.n_train, "n_val_scans": args.n_val,
        "loss_curve": losses,
        "val_miou_curve": curve,
        "val_miou_union_denom_curve": curve_raw,
        "val_perclass_iou": perclass,
        "final_val_miou": curve[-1][1] if curve else None,
        "tail_mean": tail_mean,
        "gate": {"accept_threshold": threshold, "source": source,
                 "passed": passed},
        "voxel_overflow_max": int(overflow),
        "wall_s": round(wall, 1),
        "ms_per_step": round(wall / max(args.steps, 1) * 1e3, 2),
        "device": describe_device(device),
        "compute_dtype": str(task.compute_dtype).replace("torch.", ""),
        "torch": torch.__version__,
        "note": ("ray-cast surrogate (no SemanticKITTI here): loss and "
                 "held-out mIoU of the PyTorch port over the protocol of "
                 "tools/scripts/golden_run.py; run with --data_path for the "
                 "real protocol."),
    }
    if args.out:
        Path(args.out).write_text(json.dumps(payload, indent=1))
        print("wrote", args.out, flush=True)
    return payload


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=sorted(CFG_FILES), default="minkunet")
    ap.add_argument("--data_path", type=str, default=None,
                    help="a real SemanticKITTI sequences dir: run the train "
                         "CLI on it instead of the surrogate")
    ap.add_argument("--epochs", type=int, default=0)
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--eval_every", type=int, default=100)
    ap.add_argument("--loss_every", type=int, default=50)
    ap.add_argument("--n_train", type=int, default=128)
    ap.add_argument("--n_val", type=int, default=16)
    ap.add_argument("--cr", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="weight init and train-scan order")
    ap.add_argument("--lr_scale", type=float, default=1.0)
    ap.add_argument("--warmup_frac", type=float, default=0.1)
    ap.add_argument("--point_cap", type=int, default=131072)
    ap.add_argument("--voxel_cap", type=int, default=98304)
    ap.add_argument("--workers", type=int,
                    default=min(8, os.cpu_count() or 1),
                    help="processes that ray-cast the scans")
    ap.add_argument("--cache_dir", type=str,
                    default=str(ROOT / "build" / "openpcseg_torch"))
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=None,
                    help="default GOLDEN_torch_<model>.json")
    args = ap.parse_args(argv)
    args.out = args.out or f"GOLDEN_torch_{args.model}.json"
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.data_path:
        return run_real(args)
    run_surrogate(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
