"""Build, load and call the port's native SemanticKITTI readers and range
projection.

``csrc/pcseg_io.cpp`` holds two host readers: ``load_kitti_scan`` (a
``.bin`` scan of x, y, z, intensity float32 rows) and ``load_kitti_labels``
(a ``.label`` file whose lower 16 bits are remapped through a lookup
table), and ``range_project``, the JAX package's spherical projection
with its closest-point z-buffer, which writes the packed 6-channel range
image. At first use it is compiled with ``g++ -O3 -shared -fPIC`` into
``build/openpcseg_torch/`` at the repository root, named by a hash of the
source and flags so an edit forces a rebuild, written under a temporary
name and moved into place (processes that build at once each finish their
own copy), and loaded with ctypes under a lock (the loader's threads read
at once). Nothing here runs at import time.

The readers' rules: at most ``CAP`` rows of a file are read; a label's
semantic id is its lower 16 bits, remapped through the table, and an id
outside the table becomes 0. ``load_kitti_scan_plain`` and
``load_kitti_labels_plain`` are the same rules in numpy, which the tests
hold the native readers to.

The projection is JAX's float32 arithmetic (``atan2f``, ``asinf``,
``sqrtf``), so compiled with JAX's flags it gives JAX's native images bit
for bit; ``range_project_plain`` is the numpy z-buffer of
``data/range_view.py`` (float64 angles, an argsort), which lands a few
pixels of a scan elsewhere. The range views project natively; the plain
version is for the tests and chip_smoke.py.

A missing compiler or a failed build raises, naming the compiler's error;
nothing falls back to numpy. ``READS`` counts the native calls of each
kind (``scan``, ``labels``, ``projection``), incremented after a
successful call and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "pcseg_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "openpcseg_torch"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]
CAP = 200_000          # rows read of a scan or label file at most
READS = {"scan": 0, "labels": 0, "projection": 0}

_LIB = None
_LOCK = threading.Lock()


def _find_cxx() -> str:
    found = shutil.which(CXX)
    if found is None:
        raise RuntimeError(f"{CXX} not found: the native scan and label "
                           "readers and range projection of openpcseg_torch "
                           "need a C++ compiler to build")
    return found


def build() -> Path:
    """Compile csrc/pcseg_io.cpp into a shared library (cached by the hash
    of the source and flags); its path."""
    h = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode())
    out = BUILD_DIR / f"libpcseg_io_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    cmd = [_find_cxx(), *CXX_FLAGS, str(SRC), "-o"]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(cmd + [str(tmp)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{CXX} failed ({res.returncode}):\n"
                           f"{' '.join(cmd + [str(tmp)])}\n{res.stdout}\n"
                           f"{res.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded reader library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            so = ctypes.CDLL(str(build()))
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            so.load_kitti_scan.argtypes = [ctypes.c_char_p, f32p,
                                           ctypes.c_int]
            so.load_kitti_scan.restype = ctypes.c_int
            so.load_kitti_labels.argtypes = [ctypes.c_char_p, i32p,
                                             ctypes.c_int, i32p, ctypes.c_int]
            so.load_kitti_labels.restype = ctypes.c_int
            so.range_project.argtypes = [
                f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_void_p, f32p,
                ctypes.c_void_p, f32p, i32p, i32p]
            so.range_project.restype = None
            _LIB = so
        return _LIB


def _counted(kind: str) -> None:
    with _LOCK:
        READS[kind] += 1


def load_kitti_scan(path, cap: int = CAP) -> np.ndarray:
    """The scan's first min(rows, cap) rows, [N, 4] float32."""
    rows = min(os.path.getsize(path) // 16, cap)
    buf = np.empty((rows, 4), np.float32)
    if lib().load_kitti_scan(os.fsencode(path), buf, rows) < 0:
        raise OSError(f"cannot read {path}")
    _counted("scan")
    return buf


def load_kitti_labels(path, lut: np.ndarray, cap: int = CAP) -> np.ndarray:
    """The first min(rows, cap) labels, their lower 16 bits through `lut`
    (0 outside it), [N] int32."""
    rows = min(os.path.getsize(path) // 4, cap)
    lut32 = np.ascontiguousarray(lut, np.int32)
    buf = np.empty(rows, np.int32)
    if lib().load_kitti_labels(os.fsencode(path), lut32, len(lut32), buf,
                               rows) < 0:
        raise OSError(f"cannot read {path}")
    _counted("labels")
    return buf


def range_project(pts4: np.ndarray, labels: Optional[np.ndarray], h: int,
                  w: int, fov_up: float = 3.0, fov_down: float = -25.0
                  ) -> Tuple[np.ndarray, ...]:
    """Project [N, 4] x, y, z, intensity points onto an h x w range image:
    (scan [h, w, 6] float32, label [h, w] int32 (zeros where `labels` is
    None), mask [h, w] float32, px [N] int32, py [N] int32)."""
    pts4 = np.ascontiguousarray(pts4, np.float32)
    n = len(pts4)
    if pts4.ndim != 2 or pts4.shape[1] != 4:
        raise ValueError(f"points must be [N, 4], not {pts4.shape}")
    if labels is not None and np.shape(labels) != (n,):
        raise ValueError(f"labels must be [{n}], not {np.shape(labels)}")
    if h < 1 or w < 1:
        raise ValueError(f"an image of {h} x {w} pixels")
    scan = np.empty((h, w, 6), np.float32)
    mask = np.empty((h, w), np.float32)
    label = np.empty((h, w), np.int32)
    px = np.empty(n, np.int32)
    py = np.empty(n, np.int32)
    lab_ptr = None
    if labels is not None:
        labels = np.ascontiguousarray(labels, np.int32)
        lab_ptr = labels.ctypes.data_as(ctypes.c_void_p)
    lib().range_project(pts4, n, h, w, np.float32(fov_up),
                        np.float32(fov_down), lab_ptr, scan,
                        label.ctypes.data_as(ctypes.c_void_p), mask, px, py)
    _counted("projection")
    return scan, label, mask, px, py


def range_project_plain(pts4: np.ndarray, labels: Optional[np.ndarray],
                        h: int, w: int, fov_up: float = 3.0,
                        fov_down: float = -25.0) -> Tuple[np.ndarray, ...]:
    """range_project through data/range_view.py's numpy z-buffer and
    pack_scan_tensor."""
    from .data.range_view import pack_scan_tensor
    from .data.range_view import range_project as numpy_project
    pts4 = np.asarray(pts4, np.float32)
    s = numpy_project(pts4[:, :3], pts4[:, 3], labels, h, w, fov_up,
                      fov_down)
    s.setdefault("semantic_label", np.zeros((h, w), np.int32))
    scan, label, mask = pack_scan_tensor(s)
    return scan, label, mask, s["proj_x"], s["proj_y"]


def load_kitti_scan_plain(path, cap: int = CAP) -> np.ndarray:
    """load_kitti_scan in numpy."""
    raw = np.fromfile(path, dtype=np.float32, count=4 * cap)
    return raw[:len(raw) // 4 * 4].reshape(-1, 4)


def load_kitti_labels_plain(path, lut: np.ndarray,
                            cap: int = CAP) -> np.ndarray:
    """load_kitti_labels in numpy."""
    sem = (np.fromfile(path, dtype=np.uint32, count=cap) & 0xFFFF).astype(
        np.int64)
    inside = sem < len(lut)
    out = np.zeros(len(sem), np.int32)
    out[inside] = lut[sem[inside]]
    return out
