"""A whole run of each tiny cell on the CPU (the look for a card skipped):
correct with the program as it is, not correct with each fault planted in
the timed path, and the control's readings above the limits."""
from __future__ import annotations

import io
import json
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from benchmark import calibrate, run
from benchmark.tests import tiny

SEED = 3_000_000_019          # over 32 bits, as the driver's seeds are


def _run(workload, fault=None, trace=0):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", workload, "--seed", str(SEED),
                       "--seconds", "0.5", "--trace", str(trace)],
                      bench=tiny.bench(), files=tiny.DATA,
                      device=torch.device("cpu"), fault=fault,
                      pool_workers=1)
    assert rc == 0, err.getvalue()[-3000:]
    lines = out.getvalue().strip().splitlines()
    return json.loads(lines[-1]), err.getvalue()


@pytest.mark.parametrize("workload", sorted(tiny.CELLS))
def test_sound_run_is_correct(workload):
    res, err = _run(workload)
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    for name, c in res["checks"].items():
        assert c["value"] <= c["limit"]
        assert f"check {name}:" in err.splitlines()[-len(res["checks"]):][
            list(res["checks"]).index(name)]
    assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("workload,fault", [
    ("t-train", "unchanged"), ("t-train", "half"), ("t-train", "altered"),
    ("t-train", "bn_grad"),
    ("t-serve", "half"), ("t-serve", "altered"),
    ("t-eval", "half"), ("t-eval", "altered"),
    ("t-eval", "bn_stats"), ("t-eval", "bn_affine"),
    ("t-serve", "bn_stats")])
def test_planted_fault_is_not_correct(workload, fault):
    res, _ = _run(workload, fault)
    assert res["correct"] is False


@pytest.mark.parametrize("workload", ["t-train", "t-serve"])
def test_control_fails_a_limit(workload):
    limits = json.loads((tiny.DATA / "limits" / f"{workload}.json"
                         ).read_text())["limits"]
    read = calibrate.control(workload, SEED, torch.device("cpu"),
                             tiny.DATA, tiny.bench())
    assert any(read[k] > v for k, v in limits.items()), read


def test_traced_run_reports_per_layer_metrics():
    res, _ = _run("t-train", trace=1)
    assert res["correct"] is True
    assert "mfu.train" in res["metrics"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
