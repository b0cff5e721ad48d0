"""BENCHMARK.json against the contract's shape, and every piece it names
found by name: configurations, traffic, limits, drivers, readers."""
from __future__ import annotations

import json
import re
import shutil

import pytest
import torch

from benchmark import run

SPEC = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys():
    assert set(SPEC) == KEYS
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group in ("end_to_end", "per_layer"),
                          entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry and group != "end_to_end" and (
                        group != "per_layer" or key == "layer"):
                    assert 1 <= len(entry[key]) <= 200
                    assert "\n" not in entry[key] and "\t" not in entry[key]
    assert len(names) == len(set(names))
    for c in SPEC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])


def test_metrics_and_cells():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert set(e2e) == {"train_scans_per_s", "eval_scans_per_s",
                        "latency_p95_ms", "setup_s"}
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    assert all(0 < m["bound"] <= 0.25 for m in e2e.values())
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
    for w in cells:
        reported = [m for m in SPEC["end_to_end"]
                    if w in m.get("workloads", [w])]
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert run.cell_metrics(SPEC, w, True)


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_each_cell_finds_its_files(cell):
    _, config, traffic, limits = run.cell_files(SPEC, cell["name"])
    assert config["name"] == cell["config"]
    assert run.find(run.BENCH, "drivers", f"{traffic['driver']}.py")
    assert limits and all(v > 0 for v in limits.values())
    for m in run.cell_metrics(SPEC, cell["name"], True):
        assert run.find(run.BENCH, "metrics", f"{m['name']}.py")


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_repos_yaml(conf):
    from openpcseg_torch.config import load_yaml_file
    held = json.loads((run.ROOT / conf["file"]).read_text())
    yaml = load_yaml_file(run.ROOT / held["yaml"])
    for block in ("MODEL", "OPTIM", "TPU"):
        assert held[block] == yaml[block], block
    assert held["compute_dtype"] == yaml["TPU"]["COMPUTE_DTYPE"]
    assert held["source"] == conf["source"]


def test_a_new_file_is_found_with_no_edit(tmp_path):
    """A later change adds a metric, a traffic mix and a cell's limits as
    files of their own; the harness finds each by its name."""
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "steps_seen.py").write_text(
        "def read(rec):\n    return rec['steps']\n")
    shutil.copytree(run.BENCH / "traffic", tmp_path / "traffic")
    (tmp_path / "traffic" / "serve-b2.json").write_text(json.dumps(dict(
        json.loads((run.BENCH / "traffic" / "serve-b1.json").read_text()),
        batch=2)))
    (tmp_path / "limits").mkdir()
    (tmp_path / "limits" / "new-cell.json").write_text(
        json.dumps({"limits": {"label_gap": 0.5}}))
    spec = dict(SPEC, workloads=SPEC["workloads"] + [dict(
        SPEC["workloads"][1], name="new-cell", traffic="serve-b2")])
    _, _, traffic, limits = run.cell_files(spec, "new-cell", tmp_path)
    assert traffic["batch"] == 2 and limits == {"label_gap": 0.5}
    assert run.read_metric(tmp_path, "steps_seen", {"steps": 7}) == 7
    assert run.read_metric(tmp_path, "eval_scans_per_s", dict(
        mode="serve", scans=10, window_s=2.0)) == 5.0


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", SPEC["workloads"][0]["name"], "--seed",
                   "1", "--seconds", "1"], pool_workers=1)
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
