"""The benchmark's cells at a size the CPU holds: a narrow MinkUNet (cr
0.25, one block a stage) on 16-beam ray-cast scans, with traffic and
limits of their own under ``benchmark/tests/data``."""
from __future__ import annotations

import json
from pathlib import Path

DATA = Path(__file__).resolve().parent / "data"
ROOT = DATA.parents[2]
CELLS = {"t-train": "train-b2", "t-serve": "serve-b1", "t-eval": "eval-b2"}


def bench() -> dict:
    """BENCHMARK.json's metrics, with the tiny cells in place of its own."""
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    e2e = []
    for m in real["end_to_end"]:
        m = dict(m)
        if "workloads" in m:
            m["workloads"] = [w for w, t in CELLS.items()
                              if _mode(t) in _modes(m["name"])]
        e2e.append(m)
    per = []
    for m in real["per_layer"]:
        m = dict(m)
        m["workloads"] = [w for w, t in CELLS.items()
                          if _mode(t) in _modes(m["moves"])]
        per.append(m)
    return dict(real, end_to_end=e2e, per_layer=per,
                configs=[{"name": "tiny-kitti",
                          "file": "benchmark/tests/data/configs/"
                                  "tiny-kitti.json"}],
                workloads=[{"name": w, "config": "tiny-kitti", "traffic": t,
                            "chips": 1} for w, t in CELLS.items()])


def _mode(traffic: str) -> str:
    return json.loads((DATA / "traffic" / f"{traffic}.json").read_text()
                      )["mode"]


def _modes(e2e: str):
    return {"train_scans_per_s": ("train",),
            "eval_scans_per_s": ("eval",),
            "latency_p95_ms": ("serve",)}.get(e2e, ("train", "serve",
                                                    "eval"))
