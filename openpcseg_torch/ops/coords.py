"""Coordinate keys, deduplication and lookup over fixed-capacity buffers.

Counterpart of ``openpcseg_tpu/ops/coords.py``. Voxel coordinates
(b, x, y, z) pack losslessly into two int32 keys

  hi = (b << 15) | x        lo = (y << 15) | z

and the pair packs into ONE int64 sort key ``hi * 2**31 + lo`` (lo < 2**31,
so the int64 order is the (hi, lo) lexicographic order). Invalid rows carry
``hi = lo = INT32_MAX``, the largest packed key, so they sort last.

The JAX package replaces binary search with a 16-ary tree because scalar
gathers are slow on a TPU; here ``torch.sort`` (stable) and
``torch.searchsorted`` do the same jobs and give the same row order and the
same indices, integer for integer.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

INT32_MAX = 2 ** 31 - 1
COORD_BITS = 15
COORD_MAX = 1 << COORD_BITS
INVALID_KEY = INT32_MAX * 2 ** 31 + INT32_MAX


class Keys(NamedTuple):
    """Two-int32 lossless coordinate key. Invalid lanes are (INT32_MAX, INT32_MAX)."""

    hi: torch.Tensor  # [..., N] int32
    lo: torch.Tensor  # [..., N] int32

    def packed(self) -> torch.Tensor:
        return self.hi.long() * 2 ** 31 + self.lo.long()


def make_keys(coords: torch.Tensor, valid: torch.Tensor) -> Keys:
    """Pack coords [..., 4] (b, x, y, z int32) + valid [...] into keys.
    Out-of-range coords count as invalid."""
    b, x, y, z = (coords[..., i] for i in range(4))
    ok = (valid & (x >= 0) & (x < COORD_MAX) & (y >= 0) & (y < COORD_MAX)
          & (z >= 0) & (z < COORD_MAX) & (b >= 0))
    inv = torch.full_like(b, INT32_MAX, dtype=torch.int32)
    hi = torch.where(ok, (b << COORD_BITS) | x, inv).to(torch.int32)
    lo = torch.where(ok, (y << COORD_BITS) | z, inv).to(torch.int32)
    return Keys(hi, lo)


class UniqueResult(NamedTuple):
    coords: torch.Tensor      # [cap, 4] int32 unique coords, key-sorted; pad -1
    valid: torch.Tensor       # [cap] bool
    inverse: torch.Tensor     # [N] int32 row of each input in `coords`; -1 for
                              #     invalid inputs or rows beyond capacity
    num_unique: torch.Tensor  # [] int32 unique valid coords (may exceed cap)
    keys: Keys                # [cap] sorted keys of the unique coords


def unique_coords(coords: torch.Tensor, valid: torch.Tensor,
                  cap: int) -> UniqueResult:
    """Deduplicate coords into a fixed-capacity key-sorted table: sort the
    packed keys, mark segment starts, prefix-sum for ids."""
    n = coords.shape[0]
    dev = coords.device
    keys = make_keys(coords, valid).packed()
    sk, perm = torch.sort(keys, stable=True)

    valid_sorted = sk != INVALID_KEY
    prev = torch.cat([sk.new_full((1,), -1), sk[:-1]])
    is_new = (sk != prev) & valid_sorted
    uid = torch.cumsum(is_new.to(torch.int32), 0, dtype=torch.int32) - 1
    num_unique = is_new.sum(dtype=torch.int32)

    in_cap = (uid >= 0) & (uid < cap) & valid_sorted
    # first row of each unique key -> its table slot; slot `cap` drops
    slot = torch.where(is_new & in_cap, uid, torch.full_like(uid, cap)).long()
    out_coords = torch.full((cap + 1, 4), -1, dtype=torch.int32, device=dev)
    out_coords[slot] = coords[perm].to(torch.int32)
    out_key = torch.full((cap + 1,), INVALID_KEY, dtype=torch.int64,
                         device=dev)
    out_key[slot] = sk
    out_key = out_key[:cap]

    inv_sorted = torch.where(in_cap, uid, torch.full_like(uid, -1))
    inverse = torch.empty(n, dtype=torch.int32, device=dev)
    inverse[perm] = inv_sorted
    return UniqueResult(
        coords=out_coords[:cap],
        valid=out_key != INVALID_KEY,
        inverse=inverse,
        num_unique=num_unique,
        keys=Keys((out_key >> 31).to(torch.int32),
                  (out_key & INT32_MAX).to(torch.int32)),
    )


def lookup_packed(table: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Row of each packed query key in a sorted packed table; -1 on miss
    (and for invalid queries)."""
    cap = table.shape[0]
    pos = torch.searchsorted(table, q.reshape(-1)).reshape(q.shape)
    safe = pos.clamp(max=cap - 1)
    hit = (pos < cap) & (table[safe] == q) & (q != INVALID_KEY)
    return torch.where(hit, safe, torch.full_like(safe, -1)).to(torch.int32)


def lookup_keys(table: Keys, q: Keys) -> torch.Tensor:
    """Find each query key in a sorted key table; -1 on miss."""
    return lookup_packed(table.packed(), q.packed())


def lookup_keys_z3(table: Keys, q: Keys) -> torch.Tensor:
    """Indices of the keys (q with z-1, q, q with z+1): [3, *q.shape].

    lo +- 1 is exactly the z +- 1 neighbour; a wrap at z = 0 or 2**15 - 1
    gives a key no real table holds, so it is a natural miss (as in JAX)."""
    t = table.packed()
    qp = q.packed()
    qvalid = qp != INVALID_KEY
    out = [lookup_packed(t, torch.where(qvalid, qp + d, qp)) for d in (-1, 0, 1)]
    return torch.stack(out)


def lookup_coords(table: Keys, coords: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Look up coords [..., 4] in a sorted unique-key table; -1 on miss."""
    return lookup_keys(table, make_keys(coords, valid))
