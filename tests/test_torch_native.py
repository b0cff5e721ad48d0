"""The port's native SemanticKITTI readers (openpcseg_torch/native.py,
csrc/pcseg_io.cpp) held to the JAX package's (openpcseg_tpu/native.py) and
to their numpy plain versions on the same files, the port's SemanticKITTI
and ScribbleKITTI views held to JAX's native-path views on a mini tree with
planted ids and a scan past the row cap, and a build that cannot happen
raising instead of reading with numpy."""
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
from mini_trees import KITTI_RAW_IDS, make_mini_kitti
from torch_threads import one_torch_thread  # noqa: F401

from openpcseg_tpu import native as jnative
from openpcseg_tpu.config import CfgDict as JaxCfgDict
from openpcseg_tpu.data.semantickitti import \
    SemantickittiDataset as JaxSemantickitti
from openpcseg_torch import native
from openpcseg_torch.config import CfgDict
from openpcseg_torch.data.semantickitti import SemantickittiDataset
from openpcseg_torch.data.semantickitti_meta import LEARNING_MAP_LUT

ROOT = Path(__file__).resolve().parents[1]
ROWS_PAST_CAP = native.CAP + 1


def _scan(rng, n):
    return rng.normal(0, 20, (n, 4)).astype(np.float32)


def _labels(rng, n, planted=()):
    """Raw ids from the SemanticKITTI set with instance bits in the upper
    16, and the `planted` ids in the first rows."""
    sem = rng.choice(KITTI_RAW_IDS, n).astype(np.uint32)
    sem[:len(planted)] = planted
    return sem | (rng.integers(0, 2 ** 16, n, dtype=np.uint32) << 16)


SCANS = {
    "random rows": lambda rng: _scan(rng, 1000).tobytes(),
    "rows past the cap": lambda rng: _scan(rng, ROWS_PAST_CAP).tobytes(),
    "empty": lambda rng: b"",
    "a ragged last row": lambda rng: _scan(rng, 10).tobytes() + b"\0" * 6,
}
LABELS = {
    "raw ids with instance bits": lambda rng: _labels(rng, 1000).tobytes(),
    "ids 259, 260 and 65535": lambda rng: _labels(
        rng, 1000, [259, 260, 65535, 300, 65535]).tobytes(),
    "rows past the cap": lambda rng: _labels(
        rng, ROWS_PAST_CAP, [260]).tobytes(),
}


@pytest.fixture(scope="module")
def jax_lib():
    lib = jnative.get_lib()
    assert lib is not None, "the JAX package's native reader did not build"
    return lib


@pytest.mark.parametrize("case", SCANS)
def test_scan_reader_matches_jax_native_and_plain(tmp_path, rng, jax_lib,
                                                  case):
    path = tmp_path / "s.bin"
    path.write_bytes(SCANS[case](rng))
    got = native.load_kitti_scan(str(path))
    want = jnative.load_kitti_scan(str(path))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, native.load_kitti_scan_plain(path))
    assert len(got) == min(len(path.read_bytes()) // 16, native.CAP)


@pytest.mark.parametrize("case", LABELS)
def test_label_reader_matches_jax_native_and_plain(tmp_path, rng, jax_lib,
                                                   case):
    path = tmp_path / "s.label"
    path.write_bytes(LABELS[case](rng))
    got = native.load_kitti_labels(str(path), LEARNING_MAP_LUT)
    want = jnative.load_kitti_labels(str(path), LEARNING_MAP_LUT)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, native.load_kitti_labels_plain(path, LEARNING_MAP_LUT))
    raw = np.fromfile(path, np.uint32)[:native.CAP]
    assert len(got) == len(raw)
    assert (got[(raw & 0xFFFF) >= len(LEARNING_MAP_LUT)] == 0).all()


def test_reads_count_successful_native_reads_only(tmp_path, rng):
    path = tmp_path / "s.bin"
    _scan(rng, 100).tofile(path)
    _labels(rng, 100).tofile(tmp_path / "s.label")
    before = dict(native.READS)
    native.load_kitti_scan(path)
    native.load_kitti_labels(tmp_path / "s.label", LEARNING_MAP_LUT)
    native.load_kitti_scan_plain(path)
    with pytest.raises(FileNotFoundError):
        native.load_kitti_scan(tmp_path / "missing.bin")
    assert native.READS == {"scan": before["scan"] + 1,
                            "labels": before["labels"] + 1,
                            "projection": before["projection"]}


def _tree(root, rng):
    """A SemanticKITTI mini tree (val sequence 08) with ids 259, 260 and
    65535 planted in scan 0's labels and scan 1 past the row cap, and its
    ScribbleKITTI twin (other ids, under scribbles/)."""
    seqs = root / "SemanticKITTI" / "sequences"
    make_mini_kitti(seqs, seqs=("08",), scans_per_seq=3, n_pts=2000, seed=7)
    d = seqs / "08"
    _labels(rng, 2000, [259, 260, 65535]).tofile(d / "labels/000000.label")
    _scan(rng, ROWS_PAST_CAP).tofile(d / "velodyne/000001.bin")
    _labels(rng, ROWS_PAST_CAP, [260]).tofile(d / "labels/000001.label")
    scrib = root / "ScribbleKITTI" / "sequences" / "08" / "scribbles"
    scrib.mkdir(parents=True)
    for i, n in enumerate((2000, ROWS_PAST_CAP, 2000)):
        _labels(rng, n, [65535, 260, 0]).tofile(scrib / f"{i:06d}.label")
    return seqs


@pytest.mark.parametrize("scribble", [False, True],
                         ids=["semantickitti", "scribblekitti"])
def test_view_matches_jax_native_view(tmp_path, rng, jax_lib, scribble):
    seqs = _tree(tmp_path, rng)
    d = {"DATASET": "semantickitti", "DATA_PATH": str(seqs)}
    port = SemantickittiDataset(CfgDict(d), training=False,
                                if_scribble=scribble)
    jax = JaxSemantickitti(JaxCfgDict(d), training=False,
                           if_scribble=scribble)
    assert len(port) == len(jax) == 3
    before = dict(native.READS)
    items = [port[i] for i in range(3)]
    assert native.READS == dict(before, scan=before["scan"] + 3,
                                labels=before["labels"] + 3)
    for got, want in zip(items, (jax[i] for i in range(3))):
        assert got["path"] == want["path"]
        for k in ("xyzret", "labels"):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(items[1]["xyzret"]) == len(items[1]["labels"]) == native.CAP
    planted = [0, 0, 0] if scribble else [LEARNING_MAP_LUT[259], 0, 0]
    np.testing.assert_array_equal(items[0]["labels"][:3], planted)


@pytest.fixture
def no_library(monkeypatch, tmp_path):
    """No loaded library and an empty build directory."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")


def test_missing_compiler_raises(no_library, monkeypatch, tmp_path, rng):
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    make_mini_kitti(tmp_path / "seq", seqs=("08",), scans_per_seq=1,
                    n_pts=100)
    view = SemantickittiDataset(CfgDict({"DATASET": "semantickitti",
                                         "DATA_PATH": str(tmp_path / "seq")}),
                                training=False)
    before = dict(native.READS)
    with pytest.raises(RuntimeError, match="no-such-g.. not found"):
        view[0]
    with pytest.raises(RuntimeError, match="not found"):
        native.load_kitti_labels(
            tmp_path / "seq/08/labels/000000.label", LEARNING_MAP_LUT)
    assert native.READS == before
    assert not (tmp_path / "build").exists()


def test_compiler_error_raises(no_library, monkeypatch, tmp_path, rng):
    monkeypatch.setattr(
        native.subprocess, "run",
        lambda cmd, **kw: subprocess.CompletedProcess(cmd, 1, "",
                                                      "pcseg_io.cpp: error"))
    _scan(rng, 10).tofile(tmp_path / "s.bin")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native.load_kitti_scan(tmp_path / "s.bin")
    assert not list((tmp_path / "build").glob("*.so"))


def test_threads_build_once_and_read_together(no_library, monkeypatch,
                                              tmp_path, rng):
    """More threads than cores race for the first build and read at once:
    one compiler run, every read right, every read counted."""
    runs = []
    real_run = subprocess.run

    def counting_run(cmd, **kw):
        runs.append(cmd)
        return real_run(cmd, **kw)
    monkeypatch.setattr(native.subprocess, "run", counting_run)
    pts = _scan(rng, 5000)
    pts.tofile(tmp_path / "s.bin")
    n_threads = 16
    before = native.READS["scan"]
    gate = threading.Barrier(n_threads)

    def read(_):
        gate.wait(timeout=60)
        return native.load_kitti_scan(tmp_path / "s.bin")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(n_threads) as pool:
            got = list(pool.map(read, range(n_threads), timeout=120))
    finally:
        sys.setswitchinterval(old)
    assert len(runs) == 1
    for g in got:
        np.testing.assert_array_equal(g, pts)
    assert native.READS["scan"] == before + n_threads


def test_processes_build_into_one_directory(tmp_path):
    """Processes that find no library build their own copy under a
    temporary name and move it into place: all succeed, one library."""
    build = tmp_path / "build"
    code = ("import sys, numpy as np\n"
            "from pathlib import Path\n"
            "from openpcseg_torch import native\n"
            "native.BUILD_DIR = Path(sys.argv[1])\n"
            "np.arange(8, dtype=np.float32).tofile(sys.argv[2])\n"
            "assert native.load_kitti_scan(sys.argv[2]).sum() == 28\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build),
                               str(tmp_path / f"{i}.bin")], cwd=ROOT)
             for i in range(3)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0, 0]
    assert [p.name for p in build.iterdir()] == [native.build().name]


def test_source_is_the_jax_readers():
    """The port's source holds the JAX package's two readers, line for line
    but for one redundant test, and its range projection line for line,
    and nothing else of its library."""
    text = (ROOT / "openpcseg_torch/csrc/pcseg_io.cpp").read_text()
    jax = (ROOT / "native/pcseg_io.cpp").read_text()

    def body(src, head, end):
        return src[src.index(f"{head}("):src.index(end, src.index(
            f"{head}("))]
    assert body(text, "int load_kitti_scan", "\n}\n") == body(
        jax, "int load_kitti_scan", "\n}\n")
    assert body(text, "int load_kitti_labels", "\n}\n") == body(
        jax, "int load_kitti_labels", "\n}\n").replace(
        "(sem >= 0 && sem < lut_n)", "(sem < lut_n)")
    assert body(text, "void range_project", "\n}\n") == body(
        jax, "void range_project", "\n}\n")
    for gone in ("aug_points_xyz", "load_float_rows"):
        assert gone not in text
