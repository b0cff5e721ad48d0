"""Frozen copy of the frame generator of
``openpcseg_torch/data/raycast_waymo.py`` (``waymo_frame``,
``frame_batch`` and their constants): ray-cast frames of Waymo's top
lidar, 64 beams x 2656 columns over [-17.6, +2.4] degrees, 75 m, with a
seeded second return; labels mapped to Waymo's 23 train ids. The tree
writers of the program's module are left out.
"""
from __future__ import annotations

import numpy as np

from .raycast import pad_scan, raycast_scan

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
