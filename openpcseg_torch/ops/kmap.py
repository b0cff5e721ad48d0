"""Kernel-map construction for sparse convolution.

Counterpart of ``openpcseg_tpu/ops/kmap.py``: the submanifold map
(``build_subm_kmap``), the next level's coords (``build_downsample``, with
a per-axis stride for Cylinder3D's (2, 2, 1) pools), the strided and
transposed maps of any kernel and stride (``build_down_kmap``,
``build_up_kmap``: Cylinder3D's k3 pools and up convs) and the rows of an
anisotropic sub-kernel inside the full 3^3 map
(``subm_subset_indices``). A kernel map is a dense ``idx[K, N_out]``
int32 array (-1 = miss): for each output voxel and kernel offset there is
at most one input voxel. Each level stores coords in its own grid units,
so downsampling is ``floor(c / stride)`` and every kernel offset is a
unit offset.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from .coords import (Keys, UniqueResult, lookup_coords, lookup_packed,
                     make_keys, unique_coords)

KernelSize = Union[int, Sequence[int]]
Stride = Union[int, Sequence[int]]


def kernel_offsets(kernel_size: KernelSize) -> np.ndarray:
    """[K, 3] integer offsets, row-major over (x, y, z). Odd extents are
    centred {-k//2..k//2}, even extents {0..k-1} (torchsparse convention).
    This order fixes the weight layout [K, Cin, Cout]."""
    if isinstance(kernel_size, int):
        kernel_size = (kernel_size,) * 3
    axes = [np.arange(-(k // 2), k // 2 + 1) if k % 2 == 1 else np.arange(k)
            for k in kernel_size]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    return np.stack([gx.ravel(), gy.ravel(), gz.ravel()],
                    axis=1).astype(np.int32)


def _self_z_neighbors(keys: Keys, valid: torch.Tensor):
    """(row of the z-1 neighbour, row of the z+1 neighbour) of every table
    row: in a sorted packed table they are the adjacent rows when present."""
    n = keys.hi.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=valid.device)
    adj_next = (keys.hi[:-1] == keys.hi[1:]) & (keys.lo[:-1] + 1 == keys.lo[1:])
    f = torch.zeros(1, dtype=torch.bool, device=valid.device)
    has_p = torch.cat([adj_next, f]) & valid
    has_m = torch.cat([f, adj_next]) & valid
    miss = torch.full_like(iota, -1)
    return torch.where(has_m, iota - 1, miss), torch.where(has_p, iota + 1, miss)


def build_subm_kmap(level_keys: Keys, coords: torch.Tensor,
                    valid: torch.Tensor, kernel_size: KernelSize = 3
                    ) -> torch.Tensor:
    """Submanifold (stride-1) kernel map idx[K, N] into the same level.

    The centre offset is the identity, the centre column's z+-1 offsets
    come from row adjacency, and every other offset is one searchsorted
    query batch over the packed keys."""
    offs = kernel_offsets(kernel_size)
    n = coords.shape[0]
    dev = coords.device
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    ident = torch.where(valid, iota, torch.full_like(iota, -1))
    zm, zp = _self_z_neighbors(level_keys, valid)
    centre = {(0, 0, 0): ident, (0, 0, -1): zm, (0, 0, 1): zp}

    rest = [k for k, o in enumerate(offs) if tuple(o) not in centre]
    rows: dict = {k: centre[tuple(o)] for k, o in enumerate(offs)
                  if tuple(o) in centre}
    if rest:
        d = torch.as_tensor(offs[rest], dtype=torch.int32, device=dev)
        q = torch.cat([coords[None, :, :1].expand(len(rest), n, 1),
                       coords[None, :, 1:] + d[:, None, :]], dim=-1)
        qk = make_keys(q, valid[None, :].expand(len(rest), n)).packed()
        found = lookup_packed(level_keys.packed(), qk)
        for i, k in enumerate(rest):
            rows[k] = found[i]
    return torch.stack([rows[k] for k in range(len(offs))])


def _stride(stride: Stride, dev) -> torch.Tensor:
    """[3] int32 per-axis stride of an int or (fx, fy, fz)."""
    if isinstance(stride, int):
        stride = (stride,) * 3
    return torch.as_tensor(tuple(stride), dtype=torch.int32, device=dev)


def build_downsample(coords: torch.Tensor, valid: torch.Tensor, out_cap: int,
                     stride: Stride = 2) -> UniqueResult:
    """Coords of the next level: unique(floor(c / stride)), key-sorted; the
    stride is an int or per axis (fx, fy, fz)."""
    s = _stride(stride, coords.device)
    down = torch.cat([coords[:, :1], torch.div(coords[:, 1:], s,
                                               rounding_mode="floor")], dim=1)
    return unique_coords(down, valid, out_cap)


def build_down_kmap(fine_keys: Keys, coarse_coords: torch.Tensor,
                    coarse_valid: torch.Tensor, kernel_size: KernelSize = 2,
                    stride: Stride = 2) -> torch.Tensor:
    """Strided conv map fine -> coarse, idx[K, N_coarse] into the fine
    level's rows: coarse voxel o meets, at offset f, the fine voxel at
    ``stride * o + f``."""
    dev = coarse_coords.device
    offs = torch.as_tensor(kernel_offsets(kernel_size), device=dev)
    k, n = offs.shape[0], coarse_coords.shape[0]
    base = coarse_coords[:, 1:] * _stride(stride, dev)
    q = torch.cat([coarse_coords[None, :, :1].expand(k, n, 1),
                   base[None] + offs[:, None, :]], dim=-1)
    return lookup_coords(fine_keys, q, coarse_valid[None].expand(k, n))


def build_up_kmap(coarse_keys: Keys, fine_coords: torch.Tensor,
                  fine_valid: torch.Tensor, kernel_size: KernelSize = 2,
                  stride: Stride = 2) -> torch.Tensor:
    """Transposed conv map coarse -> fine, idx[K, N_fine] into the coarse
    level's rows, the transpose of ``build_down_kmap``: fine voxel c meets
    coarse voxel o at offset f iff ``c == stride * o + f``, i.e. c - f is
    divisible by the stride and (c - f) / stride is in the coarse table.
    Python's floor division and modulo, as JAX's, on negative c - f."""
    dev = fine_coords.device
    offs = torch.as_tensor(kernel_offsets(kernel_size), device=dev)
    s = _stride(stride, dev)
    k, n = offs.shape[0], fine_coords.shape[0]
    diff = fine_coords[None, :, 1:] - offs[:, None, :]          # [K, N, 3]
    divisible = (torch.remainder(diff, s) == 0).all(dim=-1)
    q = torch.cat([fine_coords[None, :, :1].expand(k, n, 1),
                   torch.div(diff, s, rounding_mode="floor")], dim=-1)
    return lookup_coords(coarse_keys, q, fine_valid[None] & divisible)


def subm_subset_indices(full_kernel: KernelSize,
                        sub_kernel: KernelSize) -> np.ndarray:
    """Rows of a sub-kernel's offsets inside a full kernel's map, in the
    sub-kernel's ``kernel_offsets`` order: Cylinder3D's anisotropic
    submanifold kernels ((1, 3, 3), (3, 1, 1), ...) slice the level's one
    3^3 map, ``subm_kmap[subm_subset_indices(3, (1, 3, 3))]``. For a centred
    odd box, row K - 1 - k of the subset is the negation of row k, so the
    reversed subset is the transposed map (the submanifold backward)."""
    full = {tuple(o): i for i, o in enumerate(kernel_offsets(full_kernel))}
    idx = []
    for o in kernel_offsets(sub_kernel):
        if tuple(o) not in full:
            raise ValueError(f"offset {tuple(o)} of {sub_kernel} is not in "
                             f"the {full_kernel} kernel")
        idx.append(full[tuple(o)])
    return np.asarray(idx, np.int32)
