"""Summarise golden surrogate runs into per-model acceptance statistics.

The rule of the JAX package's ``tools/scripts/golden_summary.py``: per run
the tail mean, the mean of the val mIoU over the last ``TAIL`` evals of
``val_miou_curve``, rounded to 2 decimals; per model the mean over its
runs, the half range of their tail means, and a regression threshold

    accept_threshold = round(min(tail means) - max(5.0, 2 x half range), 2)

Beside each model it lists the gate the port's golden runs are held to
(``cli/golden_run.py accept_threshold``: the JAX package's threshold in
``GOLDEN_r05_summary.json``, RPVNet's in ``cli/golden_gates.json``) and
whether every run's tail mean clears it. No gate is changed here.

    python -m openpcseg_torch.tools.golden_summary     # the port's runs
    python -m openpcseg_torch.tools.golden_summary \\
        --runs 'GOLDEN_r05f_{m}_s*.json' --out /tmp/jax_summary.json

``--runs`` takes glob patterns relative to the repository root, ``{m}``
standing for the model; by default the port's ``GOLDEN_torch_{m}_s*.json``
into ``GOLDEN_torch_summary.json``. It never writes the JAX package's
``GOLDEN_r05_summary.json``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from pathlib import Path

import numpy as np

from openpcseg_torch.cli import golden_run

ROOT = Path(__file__).resolve().parents[2]
TAIL = 3
MODELS = ["minkunet", "spvcnn", "cylinder", "rpvnet",
          "cenet", "fidnet", "rangenet", "salsanext"]
RUNS = ["GOLDEN_torch_{m}_s*.json"]
OUT = ROOT / "GOLDEN_torch_summary.json"
NOTE = ("Tail mIoU of the golden surrogate runs by the JAX package's rule "
        "(tools/scripts/golden_summary.py). Surrogate mIoU is a "
        "within-model regression gate, not a cross-model ranking. "
        "'gates' lists the threshold the port's golden runs are held to "
        "(cli/golden_run.py accept_threshold) and whether every run clears "
        "it; the thresholds under 'models' come from these runs alone.")


def tail_stats(path: str) -> dict:
    with open(path) as f:
        d = json.load(f)
    curve = d["val_miou_curve"]
    vals = [v for _, v in curve[-TAIL:]]
    return {
        "file": os.path.basename(path),
        "seed": d.get("seed", 0),
        "lr_scale": d.get("lr_scale", 1.0),
        "tail_mean": round(float(np.mean(vals)), 2),
        "tail_std": round(float(np.std(vals)), 2),
        "final": round(float(curve[-1][1]), 2),
        "best": round(float(max(v for _, v in curve)), 2),
    }


def collect(patterns) -> dict:
    """{model: [tail_stats...]} over the glob patterns ({m} the model)."""
    by_model = {}
    for m in MODELS:
        runs = [tail_stats(f) for pat in patterns
                for f in sorted(glob.glob(str(ROOT / pat.format(m=m))))]
        if runs:
            by_model[m] = runs
    return by_model


def summarize(by_model) -> dict:
    """{model: runs, mean, half range, accept_threshold} by the rule."""
    out = {}
    for m, runs in by_model.items():
        means = [r["tail_mean"] for r in runs]
        spread = (max(means) - min(means)) / 2 if len(means) > 1 else None
        out[m] = {
            "runs": runs,
            "tail_mean_across_seeds": round(float(np.mean(means)), 2),
            "half_range": None if spread is None else round(spread, 2),
            "accept_threshold": round(min(means) - max(5.0, (spread or 0.0)
                                                       * 2), 2),
        }
    return out


def gates(models) -> dict:
    """Each model's golden gate and whether every run's tail mean clears
    it."""
    out = {}
    for m, s in models.items():
        gate = golden_run.accept_threshold(m)
        means = [r["tail_mean"] for r in s["runs"]]
        out[m] = {"accept_threshold": gate,
                  "source": golden_run.gate_source(m).relative_to(
                      ROOT).as_posix(),
                  "tail_means": means,
                  "every_run_clears": all(v >= gate for v in means)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", nargs="+", default=RUNS, metavar="PATTERN",
                    help="glob patterns of run files under the repository "
                         "root, {m} standing for the model")
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    if args.out.resolve() == (ROOT / golden_run.SUMMARY).resolve():
        ap.error(f"{golden_run.SUMMARY} is the JAX package's summary")

    models = summarize(collect(args.runs))
    out = {"tail_evals": TAIL, "runs": args.runs, "models": models,
           "gates": gates(models), "note": NOTE}
    print("| model | runs | tail mIoU mean±spread | best | accept ≥ "
          "| golden gate | every run clears |")
    print("|---|---|---|---|---|---|---|")
    for m, s in models.items():
        sp = "—" if s["half_range"] is None else f"±{s['half_range']:.2f}"
        g = out["gates"][m]
        print(f"| {m} | {len(s['runs'])} | {s['tail_mean_across_seeds']:.2f}"
              f" {sp} | {max(r['best'] for r in s['runs']):.2f} "
              f"| {s['accept_threshold']:.2f} | {g['accept_threshold']:.2f} "
              f"| {g['every_run_clears']} |")
    args.out.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
