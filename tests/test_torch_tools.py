"""The port's tool scripts (openpcseg_torch/tools/) held to the JAX
package's: the golden summary's rule over JAX's runs and the port's, the
committed GOLDEN_torch_summary.json derived again, the visualizers' colour
maps and their PNGs from a ray-cast scan and a prediction dump, and the
Waymo preprocessors' imports and their exit without the Waymo packages."""
import ast
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

from openpcseg_torch.cli import golden_run
from openpcseg_torch.data.raycast import raycast_scan
from openpcseg_torch.data.raycast_kitti import first_raw_id_per_class
from openpcseg_torch.data.raycast_waymo import waymo_frame
from openpcseg_torch.tools import (golden_summary, preprocess_waymo_data,
                                   unpack_wod_sequence, vis_semantickitti,
                                   vis_waymo)

ROOT = Path(__file__).resolve().parents[1]
TOOLS = ROOT / "openpcseg_torch" / "tools"


def _load_jax_script(rel):
    """A JAX tool script, loaded by its path (tools/ is no package)."""
    spec = importlib.util.spec_from_file_location(Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _summary(tmp_path, *runs):
    out = tmp_path / "summary.json"
    assert golden_summary.main(["--runs", *runs, "--out", str(out)]) == 0
    return json.loads(out.read_text())


def test_summary_of_jax_runs_reproduces_jax_summary_and_rpvnet_gate(
        tmp_path):
    jax = json.loads((ROOT / "GOLDEN_r05_summary.json").read_text())
    got = _summary(tmp_path, "GOLDEN_r05f_{m}_s*.json")
    assert got["tail_evals"] == jax["tail_evals"]
    assert len(jax["models"]) == 7
    for m, entry in jax["models"].items():
        assert got["models"][m] == entry, m
    # GOLDEN_r05f_rpvnet_s*.json came after the summary: its entry is the
    # port's golden_gates.json
    assert set(got["models"]) - set(jax["models"]) == {"rpvnet"}
    gates = json.loads(golden_run.GATES.read_text())["models"]["rpvnet"]
    rpv = got["models"]["rpvnet"]
    assert [r["file"] for r in rpv["runs"]] == gates["runs"]
    assert [r["tail_mean"] for r in rpv["runs"]] == gates["tail_means"]
    assert rpv["half_range"] == gates["half_range"] == 2.15
    assert rpv["accept_threshold"] == gates["accept_threshold"] == 64.33
    legacy = _summary(tmp_path, "GOLDEN_r04_{m}.json",
                      "GOLDEN_r05_{m}_s*.json")
    assert legacy["models"] == jax["models_legacy_allwarmup"]


def test_committed_port_summary_is_derived_from_the_port_runs(tmp_path):
    got = _summary(tmp_path, *golden_summary.RUNS)
    committed = json.loads((ROOT / "GOLDEN_torch_summary.json").read_text())
    assert got == committed
    runs = sorted(p.name for p in ROOT.glob("GOLDEN_torch_*_s*.json"))
    assert len(runs) == 16
    assert sorted(r["file"] for s in got["models"].values()
                  for r in s["runs"]) == runs
    tails = {m: g["tail_means"] for m, g in got["gates"].items()}
    assert tails["minkunet"] == [68.77, 69.22]
    assert tails["spvcnn"] == [68.68, 69.32]
    assert tails["cylinder"] == [85.67, 87.52]
    assert tails["rpvnet"] == [71.35, 71.11]
    assert tails["cenet"] == [77.7, 80.07]
    for m, g in got["gates"].items():
        assert g["accept_threshold"] == golden_run.accept_threshold(m)
        assert g["every_run_clears"]


def test_summary_refuses_to_write_the_jax_summary():
    with pytest.raises(SystemExit):
        golden_summary.main(["--out", str(ROOT / "GOLDEN_r05_summary.json")])


def test_colour_maps_match_the_jax_scripts():
    jvis = _load_jax_script("tools/visualizer/vis_semantickitti.py")
    jwaymo = _load_jax_script("tools/visualizer/vis_waymo.py")
    ids = np.arange(-3, 300)
    np.testing.assert_array_equal(vis_semantickitti.label_colors(ids),
                                  jvis.label_colors(ids))
    np.testing.assert_array_equal(vis_waymo.waymo_colors(ids),
                                  jwaymo.waymo_colors(ids))


@pytest.fixture(scope="module")
def kitti_scan(tmp_path_factory):
    """A ray-cast scan as a .bin, its raw .label, and a --save_pred dump
    of it (int32 train ids, one per point)."""
    d = tmp_path_factory.mktemp("kitti")
    _, feats, lab = raycast_scan(3)
    feats.astype(np.float32).tofile(d / "000000.bin")
    first_raw_id_per_class()[lab].astype(np.uint32).tofile(d / "000000.label")
    np.save(d / "08_000000.npy", ((lab + 1) % 20).astype(np.int32))
    return d


@pytest.mark.parametrize("source", ["label", "pred"])
def test_semantickitti_visualizer_writes_a_png(kitti_scan, tmp_path, source):
    arg = (kitti_scan / "000000.label" if source == "label"
           else kitti_scan / "08_000000.npy")
    out = tmp_path / "vis.png"
    assert vis_semantickitti.main(["--scan", str(kitti_scan / "000000.bin"),
                                   f"--{source}", str(arg),
                                   "--out", str(out)]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert out.stat().st_size > 10_000


@pytest.fixture(scope="module")
def waymo_files(tmp_path_factory):
    """A ray-cast Waymo frame's first return as an unpacked .npy frame,
    and a --save_pred dump of it."""
    d = tmp_path_factory.mktemp("waymo")
    first, _ = waymo_frame(5)
    np.save(d / "frame.npy", first)
    np.save(d / "pred.npy", (first[:, -1].astype(np.int32) + 3) % 23)
    return d


@pytest.mark.parametrize("source", ["frame", "pred"])
def test_waymo_visualizer_writes_a_png(waymo_files, tmp_path, source):
    out = tmp_path / "vis.png"
    argv = ["--frame", str(waymo_files / "frame.npy"), "--out", str(out)]
    if source == "pred":
        argv += ["--pred", str(waymo_files / "pred.npy")]
    assert vis_waymo.main(argv) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert out.stat().st_size > 10_000


def _imports(path):
    """Every module a file imports, at any depth of its code."""
    seen = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            seen |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            seen.add(node.module)
    return seen


def test_tools_import_nothing_of_jax():
    """Not at import time, nor inside a function (the preprocessor's
    geometry fallback): the port's modules in place of the JAX
    package's."""
    for path in sorted(TOOLS.glob("*.py")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "optax", "yaml",
                           "openpcseg_tpu"}, path.name
    fallback = _imports(TOOLS / "preprocess_waymo_data.py")
    assert "openpcseg_torch.data.waymo_conversion" in fallback
    from openpcseg_torch.data import waymo_conversion
    assert callable(waymo_conversion.compute_inclinations)
    assert callable(waymo_conversion.range_image_to_points)


@pytest.mark.parametrize("tool, argv", [
    (preprocess_waymo_data, ["--tfrecord_dir", "in", "--out_dir", "out"]),
    (unpack_wod_sequence, ["--tfrecord", "in.tfrecord", "--out_dir", "out"]),
], ids=["preprocess_waymo_data", "unpack_wod_sequence"])
def test_waymo_tools_exit_without_the_waymo_packages(tool, argv, tmp_path,
                                                     monkeypatch):
    monkeypatch.chdir(tmp_path)
    # neither package importable, whatever this machine has installed
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    monkeypatch.setitem(sys.modules, "waymo_open_dataset", None)
    with pytest.raises(SystemExit,
                       match="waymo-open-dataset \\+ tensorflow"):
        tool.main(argv)
    assert not (tmp_path / "out").exists()
