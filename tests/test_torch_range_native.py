"""The port's native range projection (openpcseg_torch/native.py
``range_project`` over csrc/pcseg_io.cpp) held bit for bit to the JAX
package's (openpcseg_tpu/native.py ``range_project_native``), which JAX's
range views take wherever g++ builds it: on the 127,765-point ray-cast
scan of seed 0, on exact duplicates (equal depths in one pixel: the first
point wins), on points above and below the field of view and at the
origin, with ``labels=None``, at 64 x 2048 and nuScenes' 32 x 1088.

The plain version (``range_project_plain``: the numpy z-buffer, float64
angles, and ``pack_scan_tensor``) lands a few pixels of a scan elsewhere.
On the ray-cast scan at 64 x 2048 it read, where the fixture was made:
13,512 occupied pixels natively against 13,404; 146 mask pixels, 462
pixels of the 6-channel scan tensor and 161 label pixels differ.
``test_plain_departure_on_the_raycast_scan`` holds it to a few pixels
(at most 0.5% of the image in any of the three), every point within a
row and a column of its native pixel.

The committed RANGE_NATIVE_FIXTURE (the ray-cast scan's native scan, label
and mask, made by ``PYTHONPATH=. python tests/test_torch_range_native.py
[OUT_DIR]`` from the repository's root) is what chip_smoke.py holds the
card machine's projection to; it must be the output of the machine
that runs the tests. Also: a
range view with no compiler raises from its first item instead of
projecting with numpy."""
import sys
from pathlib import Path

import numpy as np
import pytest
from mini_trees import make_mini_kitti
from torch_threads import one_torch_thread  # noqa: F401

import chip_smoke
from openpcseg_tpu import native as jnative
from openpcseg_torch import native
from openpcseg_torch.config import CfgDict
from openpcseg_torch.data.range_view import SemkittiRangeViewDataset

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"64x2048": (64, 2048, 3.0, -25.0), "32x1088": (32, 1088, 10.0,
                                                          -30.0)}


@pytest.fixture(scope="module")
def jax_lib():
    assert jnative.get_lib() is not None, (
        "the JAX package's native library did not build")


@pytest.fixture(scope="module")
def raycast():
    return chip_smoke.raycast_projection_input()


def _points(rng, n):
    pts = rng.uniform(-50, 50, (n, 4)).astype(np.float32)
    pts[:, 2] = rng.uniform(-4, 2, n)
    pts[:, 3] = rng.random(n)
    return pts


def _duplicates(rng):
    """Exact duplicates of a scan's points with other intensities and
    labels (equal depths in one pixel), in both orders."""
    pts = _points(rng, 3000)
    lab = rng.integers(0, 20, 3000).astype(np.int32)
    dup = pts[:1000].copy()
    dup[:, 3] = rng.random(1000)
    pts = np.concatenate([pts, dup, pts[1000:1500]])
    lab = np.concatenate([lab, (lab[:1000] + 7) % 20, (lab[1000:1500] + 3)
                          % 20]).astype(np.int32)
    return pts, lab


def _outside_the_fov(rng):
    """Points far above and below every field of view, straight up and
    down, at the origin (depth floored at 1e-8), and on the -x axis
    (yaw = -pi, the image's left edge)."""
    pts = _points(rng, 2000)
    pts[:200, 2] = rng.uniform(20, 80, 200)
    pts[200:400, 2] = rng.uniform(-80, -20, 200)
    extra = np.array([[0, 0, 0, 0.5], [0, 0, 5, 0.1], [0, 0, -5, 0.2],
                      [-10, 0, 0, 0.3], [-10, -0.0, 0, 0.4], [1e-9, 0, 0, 1],
                      [0, 0, 0, 0.7]], np.float32)
    pts = np.concatenate([pts, extra])
    return pts, rng.integers(0, 20, len(pts)).astype(np.int32)


CASES = {
    "duplicates": _duplicates,
    "outside the fov": _outside_the_fov,
    "random": lambda rng: (_points(rng, 20000),
                           rng.integers(0, 20, 20000).astype(np.int32)),
}


def _assert_bitwise(got, want):
    assert len(got) == len(want) == 5
    for name, g, w in zip(("scan", "label", "mask", "px", "py"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("labelled", [True, False],
                         ids=["labels", "labels=None"])
@pytest.mark.parametrize("case", ["raycast", *CASES])
def test_projection_is_jax_native_bit_for_bit(jax_lib, raycast, case, shape,
                                              labelled):
    if case == "raycast":
        pts, lab = raycast
    else:
        pts, lab = CASES[case](np.random.default_rng(len(case)))
    lab = lab if labelled else None
    h, w, up, down = SHAPES[shape]
    before = native.READS["projection"]
    got = native.range_project(pts, lab, h, w, up, down)
    assert native.READS["projection"] == before + 1
    _assert_bitwise(got, jnative.range_project_native(pts, lab, h, w, up,
                                                      down))
    scan, label, mask = got[:3]
    np.testing.assert_array_equal(scan[..., 5], mask)
    assert label.any() == labelled
    assert not label[mask == 0].any() and not scan[mask == 0].any()
    if case == "outside the fov":
        assert got[4][-7] == got[4][-1] and got[4][-6] == 0
        assert got[4][-5] == h - 1
        assert mask[0].any() and mask[h - 1].any()


def test_duplicates_keep_the_first_point(jax_lib):
    """Of two points at one depth in one pixel the first is drawn: the
    duplicates' intensities and labels appear nowhere they are not
    also the first's."""
    pts, lab = _duplicates(np.random.default_rng(0))
    scan, label, mask, px, py = native.range_project(pts, lab, 64, 2048)
    first = native.range_project(pts[:3000], lab[:3000], 64, 2048)
    for a, b in zip((scan, label, mask), first[:3]):
        assert a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(px[3000:4000], px[:1000])
    np.testing.assert_array_equal(py[3000:4000], py[:1000])


def test_projection_refuses_mismatched_arrays(raycast):
    pts, lab = raycast
    before = native.READS["projection"]
    for bad in ((pts[:, :3], lab), (pts, lab[:-1]), (pts[0], lab[:1])):
        with pytest.raises(ValueError):
            native.range_project(*bad, 64, 2048)
    with pytest.raises(ValueError):
        native.range_project(pts, lab, 0, 2048)
    assert native.READS["projection"] == before


def _differing(a, b):
    return {"mask": int((a[2] != b[2]).sum()),
            "scan": int((a[0] != b[0]).any(-1).sum()),
            "label": int((a[1] != b[1]).sum())}


def test_plain_departure_on_the_raycast_scan(raycast):
    pts, lab = raycast
    h, w, up, down = SHAPES["64x2048"]
    nat = native.range_project(pts, lab, h, w, up, down)
    before = native.READS["projection"]
    plain = native.range_project_plain(pts, lab, h, w, up, down)
    assert native.READS["projection"] == before
    for a, b in zip(nat, plain):
        assert a.dtype == b.dtype and a.shape == b.shape
    diff = _differing(nat, plain)
    assert all(0 < n <= 0.005 * h * w for n in diff.values()), diff
    assert 13_000 < nat[2].sum() < 14_000
    for got, want, size in ((nat[3], plain[3], w), (nat[4], plain[4], h)):
        off = np.abs(got - want)
        assert (off != 0).mean() < 0.05
        assert set(np.unique(off).tolist()) <= {0, 1, size - 1}


def write_fixture(out_dir: Path) -> Path:
    """The ray-cast scan's native projection at 64 x 2048 as
    chip_smoke.RANGE_NATIVE_FIXTURE's .npz under `out_dir`."""
    pts, lab = chip_smoke.raycast_projection_input()
    scan, label, mask = native.range_project(
        pts, lab, chip_smoke.RANGE_H, chip_smoke.RANGE_W)[:3]
    out = Path(out_dir) / Path(chip_smoke.RANGE_NATIVE_FIXTURE).name
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, scan=scan, label=label, mask=mask,
                        points_sha256=np.array(chip_smoke.points_digest(pts)))
    return out


def test_committed_fixture_is_this_machines_projection(raycast, tmp_path):
    want = np.load(ROOT / chip_smoke.RANGE_NATIVE_FIXTURE)
    got = np.load(write_fixture(tmp_path))
    assert sorted(got.files) == sorted(want.files) == [
        "label", "mask", "points_sha256", "scan"]
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert str(want["points_sha256"]) == chip_smoke.points_digest(raycast[0])


def test_missing_compiler_raises_from_the_first_item(monkeypatch, tmp_path):
    """No g++: the range view's first item raises (the scan is read in
    numpy here, so it is the projection that needs the library) and
    nothing projects with numpy."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "load_kitti_scan",
                        native.load_kitti_scan_plain)
    monkeypatch.setattr(native, "load_kitti_labels",
                        native.load_kitti_labels_plain)
    plain = []
    monkeypatch.setattr(native, "range_project_plain",
                        lambda *a, **k: plain.append(a))
    make_mini_kitti(tmp_path / "seq", seqs=("08",), scans_per_seq=1,
                    n_pts=500)
    view = SemkittiRangeViewDataset(
        CfgDict({"DATASET": "semantickitti", "DATA_PATH": str(
            tmp_path / "seq"), "H": 16, "W": 256}), training=False)
    before = dict(native.READS)
    with pytest.raises(RuntimeError, match="no-such-g.. not found"):
        view[0]
    assert native.READS == before and not plain
    assert not (tmp_path / "build").exists()


if __name__ == "__main__":
    print(write_fixture(Path(sys.argv[1]) if len(sys.argv) > 1 else
                        ROOT / Path(chip_smoke.RANGE_NATIVE_FIXTURE).parent))
