"""Synthetic LiDAR-like labeled scans for hermetic tests and benchmarks.

The reference ships no test fixtures (SURVEY.md §4 — zero automated tests);
this module provides deterministic procedurally-generated scans with
geometry-correlated labels so the full train/eval loop runs without
SemanticKITTI on disk, and so bench.py can generate realistic-sized inputs
(~120k points/scan like SemanticKITTI, semantickitti_voxel.py comment).

A copy of ``openpcseg_tpu/data/synthetic.py`` (the port imports
nothing of the JAX package), held to it by tests/test_torch_data.py.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_scan(
    seed: int,
    n_points: int = 120_000,
    num_class: int = 20,
    extent: float = 50.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (xyz [N,3] f32, feats [N,4] f32, labels [N] i32).

    Scene: a disk-shaped ground plane plus scattered vertical structures.
    Labels derive from azimuth sector x height band (learnable from
    geometry); intensity weakly encodes the label so short smoke trainings
    can demonstrably reduce loss / raise mIoU. A small fraction is labeled
    0 (ignored), mirroring SemanticKITTI's unlabeled class.
    """
    rng = np.random.default_rng(seed)
    n_ground = int(n_points * 0.7)
    n_obj = n_points - n_ground

    # ground: radial density like a spinning LiDAR
    r = extent * np.sqrt(rng.uniform(0.01, 1.0, n_ground))
    az = rng.uniform(-np.pi, np.pi, n_ground)
    gx = r * np.cos(az)
    gy = r * np.sin(az)
    gz = rng.normal(0.0, 0.05, n_ground) - 1.6

    # objects: clusters with height
    n_clusters = 40
    centers = rng.uniform(-extent * 0.8, extent * 0.8, (n_clusters, 2))
    cl = rng.integers(0, n_clusters, n_obj)
    ox = centers[cl, 0] + rng.normal(0, 0.8, n_obj)
    oy = centers[cl, 1] + rng.normal(0, 0.8, n_obj)
    oz = rng.uniform(-1.6, 2.5, n_obj)

    xyz = np.stack(
        [np.concatenate([gx, ox]), np.concatenate([gy, oy]),
         np.concatenate([gz, oz])], axis=1
    ).astype(np.float32)

    azim = np.arctan2(xyz[:, 1], xyz[:, 0])
    sector = ((azim + np.pi) / (2 * np.pi) * 4).astype(np.int64) % 4
    band = np.clip(((xyz[:, 2] + 2.0) / 1.2).astype(np.int64), 0, 3)
    radial = (np.linalg.norm(xyz[:, :2], axis=1) / (extent / 2)).astype(np.int64) % 2
    labels = 1 + (sector + 4 * band + 8 * radial) % (num_class - 1)

    # unlabeled fraction
    drop = rng.random(n_points) < 0.03
    labels = np.where(drop, 0, labels).astype(np.int32)

    intensity = (labels / num_class + rng.normal(0, 0.05, n_points)).astype(np.float32)
    feats = np.concatenate([xyz, intensity[:, None]], axis=1).astype(np.float32)
    return xyz, feats, labels


def pad_scan(
    xyz: np.ndarray, feats: np.ndarray, labels: np.ndarray, cap: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad/crop one scan to a fixed capacity; returns (+valid mask)."""
    n = min(len(xyz), cap)
    pxyz = np.zeros((cap, 3), np.float32)
    pfeat = np.zeros((cap, feats.shape[1]), np.float32)
    plab = np.full((cap,), -1, np.int32)
    pval = np.zeros((cap,), bool)
    pxyz[:n] = xyz[:n]
    pfeat[:n] = feats[:n]
    plab[:n] = labels[:n]
    pval[:n] = True
    return pxyz, pfeat, plab, pval


def synthetic_batch(
    seed: int,
    batch_size: int,
    n_points: int = 120_000,
    cap: int | None = None,
    num_class: int = 20,
):
    """Padded batch dict of synthetic scans (host numpy)."""
    cap = cap or n_points
    xyzs, feats, labels, valids = [], [], [], []
    for i in range(batch_size):
        x, f, l = synthetic_scan(seed * 1000 + i, n_points, num_class)
        px, pf, pl, pv = pad_scan(x, f, l, cap)
        xyzs.append(px); feats.append(pf); labels.append(pl); valids.append(pv)
    return dict(
        xyz=np.stack(xyzs),
        feats=np.stack(feats),
        labels=np.stack(labels),
        valid=np.stack(valids),
    )
