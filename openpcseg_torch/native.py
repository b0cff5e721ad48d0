"""Build, load and call the port's native SemanticKITTI readers.

``csrc/pcseg_io.cpp`` holds two host readers: ``load_kitti_scan`` (a
``.bin`` scan of x, y, z, intensity float32 rows) and ``load_kitti_labels``
(a ``.label`` file whose lower 16 bits are remapped through a lookup
table). At first use it is compiled with ``g++ -O3 -shared -fPIC`` into
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

A missing compiler or a failed build raises, naming the compiler's error;
no reader falls back to numpy. ``READS`` counts the native reads of each
kind, incremented after a successful read and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "pcseg_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "openpcseg_torch"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]
CAP = 200_000          # rows read of a scan or label file at most
READS = {"scan": 0, "labels": 0}

_LIB = None
_LOCK = threading.Lock()


def _find_cxx() -> str:
    found = shutil.which(CXX)
    if found is None:
        raise RuntimeError(f"{CXX} not found: the native scan and label "
                           "readers of openpcseg_torch need a C++ compiler "
                           "to build")
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
