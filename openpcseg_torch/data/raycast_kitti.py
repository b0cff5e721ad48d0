"""Ray-cast surrogate scans written as an on-disk SemanticKITTI tree.

Counterpart of ``tools/scripts/make_raycast_kitti.py``, and byte for byte
the same tree: full-size ray-cast scans (``raycast.py``) as ``.bin``
(x, y, z, intensity float32) and ``.label`` (uint32 raw ids, a random
instance id in the upper 16 bits) under ``<root>/sequences/00`` (train,
scan seeds 0..) and ``<root>/sequences/08`` (val, seeds 10000..), so the
training CLI's reader, LUT remap, augmentations and loader run at real
scan sizes without a dataset. Train ids go back to raw ids through the
first ``LEARNING_MAP`` entry of each class, so the reader's remap gives the
ray-cast labels again.

    python -m openpcseg_torch.data.raycast_kitti <root> [n_train] [n_val]
"""
from __future__ import annotations

import os
import sys

import numpy as np

from .raycast import raycast_scan
from .semantickitti_meta import LEARNING_MAP


def first_raw_id_per_class(num_class: int = 20) -> np.ndarray:
    inv = np.zeros(num_class, np.uint32)
    for raw, train in sorted(LEARNING_MAP.items()):
        if train < num_class and inv[train] == 0 and train != 0:
            inv[train] = raw
    inv[0] = 0  # unlabeled
    return inv


def write_tree(root, n_train: int = 48, n_val: int = 8,
               verbose: bool = False) -> str:
    """Write the tree under `root`; returns ``<root>/sequences`` (the
    DATA_PATH to give the configs)."""
    inv = first_raw_id_per_class()
    rng = np.random.default_rng(0)
    for seq, n, seed0 in (("00", n_train, 0), ("08", n_val, 10_000)):
        vdir = os.path.join(root, "sequences", seq, "velodyne")
        ldir = os.path.join(root, "sequences", seq, "labels")
        os.makedirs(vdir, exist_ok=True)
        os.makedirs(ldir, exist_ok=True)
        for i in range(n):
            _, feats, lab = raycast_scan(seed0 + i)
            raw = inv[np.clip(lab, 0, len(inv) - 1)].astype(np.uint32)
            inst = rng.integers(0, 2 ** 16, len(raw), dtype=np.uint32)
            raw = raw | (inst << 16)
            feats.astype(np.float32).tofile(
                os.path.join(vdir, f"{i:06d}.bin"))
            raw.tofile(os.path.join(ldir, f"{i:06d}.label"))
            if verbose and i % 10 == 0:
                print(f"seq {seq}: {i + 1}/{n} ({len(raw)} pts)", flush=True)
    return os.path.join(root, "sequences")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Write ray-cast scans as a SemanticKITTI tree.")
    ap.add_argument("root", help="the tree's root (sequences/ goes under it)")
    ap.add_argument("n_train", type=int, nargs="?", default=48)
    ap.add_argument("n_val", type=int, nargs="?", default=8)
    args = ap.parse_args(argv)
    print("done ->", write_tree(args.root, args.n_train, args.n_val,
                                verbose=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
