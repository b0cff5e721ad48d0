"""Build, load and count the port's hand-written CUDA kernels.

The sources live in ``openpcseg_torch/csrc`` (plain C ABI, no PyTorch
headers). At first use on a CUDA tensor each ``.cu`` is compiled with
``nvcc`` for ``sm_90a`` to an object file, all sources at once in parallel,
and the objects are linked into one shared library under
``build/openpcseg_torch/`` at the repository root, named by a hash of the
sources so an edit forces a rebuild, and loaded with ctypes. Nothing here
runs at import time, so the CPU tests import every module without a
compiler.

A failed build raises; no wrapper falls back to its plain version for a
CUDA tensor.

``LAUNCHES`` counts kernel launches per wrapper (incremented right after a
successful launch, nowhere else); ``PLAIN_ON_CUDA`` counts calls of a plain
version on a CUDA tensor, which only a kernel-vs-plain comparison makes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "openpcseg_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# forward kernels (K1, K3, K4, K7), then the backward ones: the dfeats
# passes of K2 / K6 / K5, the shared weight-gradient kernel, and K8; then
# K8 and K7 over a one-corner point-to-voxel table: "vmean" is K8 (SPVCNN's
# mean-voxelize sum; the backward of Cylinder3D's refinement gather),
# "vmean_bwd" K7 (the mean-voxelize's backward; the refinement gather);
# then Cylinder3D's k3 strided convs on the gather-GEMM: forward, dfeats
# and dW (gather_dw.cu); then RPVNet's range fusion (ops/range_fusion.py):
# "r2p" is K7 over a 4-corner bilinear table (range map -> points),
# "r2p_bwd" K8 over its transpose, "p2r" K8 over a one-corner pixel table
# (the sum of the points -> range mean), "p2r_bwd" K7 over it (the mean's
# backward)
COUNTERS = ("subm", "down", "up", "devox", "subm_bwd", "down_bwd", "up_bwd",
            "dw", "devox_bwd", "vmean", "vmean_bwd", "strided",
            "strided_bwd", "strided_dw", "r2p", "r2p_bwd", "p2r", "p2r_bwd")
LAUNCHES = dict.fromkeys(COUNTERS, 0)
PLAIN_ON_CUDA = dict.fromkeys(COUNTERS, 0)

# name -> number of pointer arguments before the int arguments
_SIGNATURES = {
    # feats, w, kmap, out, partial, counters
    #   | n_out, K, cin, cout, reverse, splits
    "opcs_gather_gemm_bf16": (6, 6),
    # src, w, src_rows, dst_rows, group_off, tile_off, out
    #   | cin, cout, max_tiles, tile_rows
    "opcs_parent_gemm_bf16": (7, 4),
    "opcs_devox_bf16": (4, 3),         # vox, idx, w, out | n, c, k
    "opcs_devox_f32": (4, 3),
    # a, ia, b, ib, partial, out | n, K, ca, cb, rows_per_chunk, n_chunks
    "opcs_gather_dw_bf16": (6, 6),
    # dout, ptr, point, w, seg_ptr, seg_voxel, partial, counters, dvox
    #   | n_seg, c, chunk
    "opcs_devox_bwd_bf16": (9, 3),
    "opcs_devox_bwd_f32": (9, 3),
}
# launch-configuration queries: name -> (number of int arguments, length of
# the int info array they fill); no stream, no launch
_QUERIES = {
    "opcs_gather_gemm_config": (4, 7),   # n_out, K, cin, cout
    "opcs_gather_dw_config": (2, 4),     # ca, cb
}

_LIB = None
BUILD_INFO: dict = {}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_ON_CUDA):
        for k in d:
            d[k] = 0


def note_plain(name: str, x: torch.Tensor) -> None:
    if x.is_cuda:
        PLAIN_ON_CUDA[name] += 1


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of openpcseg_torch "
                           "need the CUDA toolkit to build")
    return found


def _nvcc(cmd: list) -> subprocess.CompletedProcess:
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
            f"{res.stdout}\n{res.stderr}")
    return res


def build() -> Path:
    """Compile csrc/*.cu (one nvcc per source, all at once) and link them
    into one shared library (cached by source hash)."""
    srcs = _sources()
    h = hashlib.sha256()
    for s in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libopcs_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=0.0, cached=True)
        return out
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in srcs]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
        compiled = list(pool.map(
            _nvcc, [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                    for s, o in zip(srcs, objs)]))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    _nvcc([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
           "-o", str(tmp), *map(str, objs)])
    secs = time.perf_counter() - t0
    for o in objs:
        o.unlink()
    os.replace(tmp, out)
    BUILD_INFO.update(path=str(out), seconds=secs, cached=False,
                      ptxas="".join(r.stderr for r in compiled))
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        so = ctypes.CDLL(str(build()))
        for name, (n_ptr, n_int) in _SIGNATURES.items():
            fn = getattr(so, name)
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        for name, (n_int, _) in _QUERIES.items():
            fn = getattr(so, name)
            fn.argtypes = [ctypes.c_int] * n_int + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _LIB = so
    return _LIB


def query(name: str, *args) -> list:
    """The launch configuration a kernel's entry picks for these shapes
    (tile, dynamic shared memory, blocks per SM, ...): see the entry's
    comment in csrc. Launches nothing."""
    info = (ctypes.c_int * _QUERIES[name][1])()
    err = getattr(lib(), name)(*args, ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
    return list(info)


def launch(name: str, counter: str, *args) -> None:
    """Call a C entry point on the current stream; raise on a CUDA error.
    Temporaries the caller frees after this returns stay safe: PyTorch's
    caching allocator hands their memory out again only in stream order."""
    fn = getattr(lib(), name)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[counter] += 1


def check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
               device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-d, expected {ndim}-d")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name}: {t.numel()} elements exceed int32 indexing")
