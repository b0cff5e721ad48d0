"""Ray-cast surrogate frames written as a preprocessed Waymo Open tree.

The layout ``data/waymo.py`` reads (the reference's converter output):
one ``.npy`` per frame of float32 rows ``[range, intensity, elongation,
x, y, z, label]`` under ``<root>/first/`` (the first return), the second
return of the same frame under ``<root>/second/`` with the same name, and
the split lists ``train-0-31.txt`` / ``val-0-7.txt`` naming the frames of
``first/``. Each frame is a ray-cast scene (``raycast.py``) seen by
Waymo's top lidar: 64 beams over [-17.6, +2.4] degrees of inclination
(the band the fusion view bins its rows over), 2656 columns (the fusion
view's width), 75 m of range, from 2.0 m above the ground of the vehicle
frame. Labels go from the ray-cast classes to Waymo's 23 train ids
through ``WAYMO_OF_RAYCAST``. The second return is a seeded subset of the
first (SECOND_SHARE of its rays, vegetation twice as often), each a
little further along its ray with less intensity and more elongation.
A frame holds about 175-185k points in all (``python -m
openpcseg_torch.data.raycast_waymo <root> 2 1`` prints them), under the
yamls' cap of 196,608.

    python -m openpcseg_torch.data.raycast_waymo <root> [n_train] [n_val]
        [--sequence N]

With ``--sequence N`` it also writes an unlabeled sequence of N frames
(label column 0) under ``<root>/sequence/first`` and ``second``, the
tree ``WaymoInferDataset`` streams (DATA.DATA_PATH ``<root>/sequence``).
"""
from __future__ import annotations

import os
import sys

import numpy as np

from .raycast import raycast_scan

N_BEAMS, N_AZIMUTH = 64, 2656
FOV_UP, FOV_DOWN = 2.4, -17.6
MAX_RANGE = 75.0
SENSOR_Z = 2.0
SECOND_SHARE = 0.12
# ray-cast class (SemanticKITTI train id, raycast.py) -> Waymo train id
# (data/waymo.py WAYMO_CLASS_NAMES): car CAR, road ROAD, sidewalk
# SIDEWALK, building and fence BUILDING, vegetation VEGETATION, trunk
# TREE_TRUNK, terrain WALKABLE, pole POLE, traffic-sign SIGN; 0 UNDEFINED
WAYMO_OF_RAYCAST = np.zeros(20, np.int32)
for _kitti, _waymo in ((1, 1), (9, 18), (11, 22), (13, 14), (14, 14),
                       (15, 15), (16, 16), (17, 21), (18, 10), (19, 8)):
    WAYMO_OF_RAYCAST[_kitti] = _waymo


def waymo_frame(seed: int, labeled: bool = True):
    """(first, second): the two returns of the frame of `seed`, float32
    [N, 7] rows [range, intensity, elongation, x, y, z, label]."""
    xyz, feats, lab = raycast_scan(
        seed, n_beams=N_BEAMS, n_azimuth=N_AZIMUTH, max_range=MAX_RANGE,
        fov_up=FOV_UP, fov_down=FOV_DOWN, sensor_z=SENSOR_Z)
    rng = np.random.default_rng(seed + 7_777_777)
    origin = np.array([0.0, 0.0, SENSOR_Z], np.float32)
    rel = xyz - origin
    rng_m = np.linalg.norm(rel, axis=1)
    label = (WAYMO_OF_RAYCAST[lab] if labeled
             else np.zeros(len(lab), np.int32))
    elong = np.abs(rng.normal(0.0, 0.05, len(lab)))
    first = np.concatenate(
        [rng_m[:, None], feats[:, 3:4], elong[:, None], xyz,
         label[:, None]], axis=1).astype(np.float32)

    share = np.where(lab == 15, 2 * SECOND_SHARE, SECOND_SHARE)
    pick = rng.random(len(lab)) < share
    extra = rng.uniform(0.1, 1.0, int(pick.sum()))
    unit = rel[pick] / rng_m[pick, None]
    r2 = rng_m[pick] + extra
    xyz2 = origin + unit * r2[:, None]
    second = np.concatenate(
        [r2[:, None], 0.5 * first[pick, 1:2],
         first[pick, 2:3] + rng.uniform(0.05, 0.3, (len(r2), 1)), xyz2,
         first[pick, 6:7]], axis=1).astype(np.float32)
    return first, second


def frame_batch(seed: int, cap: int, labeled: bool = True) -> dict:
    """The frame of `seed` as ``WaymoDataset`` reads it (both returns, x, y,
    z, tanh(intensity), tanh(elongation)) as a padded numpy batch of 1:
    xyz [1, cap, 3], feats [1, cap, 5], labels [1, cap] (-1 pad), valid
    [1, cap]; a frame of more than `cap` points keeps a seeded sample of
    `cap` of them, in their order."""
    from .raycast import pad_scan

    arr = np.concatenate(waymo_frame(seed, labeled))
    if len(arr) > cap:
        keep = np.sort(np.random.default_rng(seed).permutation(
            len(arr))[:cap])
        arr = arr[keep]
    feats = np.concatenate([arr[:, 3:6], np.tanh(arr[:, 1:3])], axis=1)
    xyz, feats, labels, valid = pad_scan(arr[:, 3:6], feats,
                                         arr[:, 6].astype(np.int32), cap)
    return {"xyz": xyz[None], "feats": feats[None], "labels": labels[None],
            "valid": valid[None]}


def _frame_files(job):
    root, name, seed, labeled = job
    first, second = waymo_frame(seed, labeled)
    path = os.path.join(root, "first", name)
    np.save(path, first)
    np.save(os.path.join(root, "second", name), second)
    return os.path.abspath(path), len(first), len(second)


def _write(root, names_seeds, labeled, verbose, workers=1):
    """The frames (name, seed) under `root`/first and `root`/second, cast
    in `workers` threads; returns their first-return paths."""
    for d in ("first", "second"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    jobs = [(root, name, seed, labeled) for name, seed in names_seeds]
    if workers > 1:   # numpy's array passes release the GIL
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(workers) as pool:
            done = list(pool.map(_frame_files, jobs))
    else:
        done = [_frame_files(j) for j in jobs]
    if verbose:
        for (path, n1, n2) in done:
            print(f"{os.path.basename(path)}: {n1} + {n2} = {n1 + n2} "
                  f"points", flush=True)
    return [d[0] for d in done]


def write_tree(root, n_train: int = 32, n_val: int = 8,
               verbose: bool = False, workers: int = 1) -> str:
    """Write the tree under `root` (train frames of seeds 0.., val frames
    of seeds 10000..), casting in `workers` threads; returns `root` (the
    DATA_PATH to give the configs). The split lists hold absolute paths,
    as JAX's reader opens each line as it stands."""
    for split, n, seed0, lst in (("train", n_train, 0, "train-0-31.txt"),
                                 ("val", n_val, 10_000, "val-0-7.txt")):
        paths = _write(root, [(f"{split}_{i:06d}.npy", seed0 + i)
                              for i in range(n)], True, verbose, workers)
        with open(os.path.join(root, lst), "w") as f:
            f.write("".join(p + "\n" for p in paths))
    return str(root)


def write_sequence(root, n: int, seed0: int = 20_000,
                   verbose: bool = False, workers: int = 1) -> str:
    """An unlabeled sequence of `n` frames under `root`/first and
    `root`/second (names ``<i:06d>.npy``); returns `root`."""
    _write(root, [(f"{i:06d}.npy", seed0 + i) for i in range(n)], False,
           verbose, workers)
    return str(root)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Write ray-cast frames as a preprocessed Waymo tree.")
    ap.add_argument("root")
    ap.add_argument("n_train", type=int, nargs="?", default=32)
    ap.add_argument("n_val", type=int, nargs="?", default=8)
    ap.add_argument("--sequence", type=int, default=0,
                    help="also write an unlabeled sequence of this many "
                    "frames under <root>/sequence")
    ap.add_argument("--workers", type=int, default=1,
                    help="threads that cast the frames")
    args = ap.parse_args(argv)
    print("done ->", write_tree(args.root, args.n_train, args.n_val,
                                verbose=True, workers=args.workers))
    if args.sequence:
        print("sequence ->", write_sequence(
            os.path.join(args.root, "sequence"), args.sequence,
            verbose=True, workers=args.workers))
    return 0


if __name__ == "__main__":
    sys.exit(main())
