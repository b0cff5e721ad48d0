"""Ray-cast synthetic LiDAR scans: surface-realistic geometry + labels.

The blob-based generator in synthetic.py scatters points in volumes, which
produces voxel statistics nothing like a real scan (no surfaces, ~no decay
under downsampling, near-zero kernel-map hit rates). This module simulates
a spinning LiDAR (KITTI HDL-64-like: 64 beams, +3..-25 deg elevation,
reference laserscan.py:174-238 projection model) against a procedural
scene of planes, boxes, cylinders and spheres, so that:

- voxel occupancy, per-level decay, z-run lengths and kernel-map hit rates
  match real outdoor scans (surfaces, not dust);
- labels follow scene semantics (ground/building/car/pole/vegetation...)
  with SemanticKITTI-like class frequencies, giving a *learnable* surrogate
  dataset for convergence/golden runs while the real dataset is absent.

Everything is deterministic in `seed`. Numpy only: a verbatim counterpart
of ``openpcseg_tpu/data/raycast.py`` (the port imports nothing of the JAX
package), held to it array for array by tests/test_torch_coords.py.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# SemanticKITTI train ids used for scene classes (semantickitti_meta.py):
# 1 car, 9 road, 11 sidewalk, 13 building, 14 fence, 15 vegetation,
# 16 trunk, 17 terrain, 18 pole, 19 traffic-sign
_L_CAR, _L_ROAD, _L_SIDEWALK, _L_BUILDING, _L_FENCE = 1, 9, 11, 13, 14
_L_VEG, _L_TRUNK, _L_TERRAIN, _L_POLE, _L_SIGN = 15, 16, 17, 18, 19


def _ray_box(o: np.ndarray, d: np.ndarray, bmin, bmax) -> np.ndarray:
    """Slab test: t of entry hit for rays o + t*d, inf when missed."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t0 = (bmin[None, :] - o[None, :]) / d
        t1 = (bmax[None, :] - o[None, :]) / d
    tnear = np.nanmax(np.minimum(t0, t1), axis=1)
    tfar = np.nanmin(np.maximum(t0, t1), axis=1)
    hit = (tfar >= tnear) & (tfar > 0)
    t = np.where(tnear > 0, tnear, tfar)
    return np.where(hit, t, np.inf)


def _ray_vcyl(o, d, cx, cy, r, z0, z1):
    """Vertical cylinder |xy - c| = r clipped to [z0, z1]."""
    ox, oy = o[0] - cx, o[1] - cy
    dx, dy = d[:, 0], d[:, 1]
    a = dx * dx + dy * dy
    b = 2 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - r * r
    disc = b * b - 4 * a * c
    with np.errstate(invalid="ignore", divide="ignore"):
        sq = np.sqrt(np.maximum(disc, 0.0))
        t = (-b - sq) / (2 * a)
    z = o[2] + t * d[:, 2]
    ok = (disc > 0) & (t > 0) & (z >= z0) & (z <= z1)
    return np.where(ok, t, np.inf)


def _ray_sphere(o, d, cx, cy, cz, r):
    oc = o - np.array([cx, cy, cz])
    b = 2 * (d @ oc)
    c = oc @ oc - r * r
    disc = b * b - 4 * c
    with np.errstate(invalid="ignore"):
        sq = np.sqrt(np.maximum(disc, 0.0))
        t = (-b - sq) / 2
    ok = (disc > 0) & (t > 0)
    return np.where(ok, t, np.inf)


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


def raycast_scan(
    seed: int,
    n_beams: int = 64,
    n_azimuth: int = 2048,
    max_range: float = 75.0,
    num_class: int = 20,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (xyz [N,3] f32, feats [N,4] = xyz+intensity, labels [N] i32).

    N <= n_beams * n_azimuth (rays beyond max_range are dropped, like real
    scans dropping no-return rays).
    """
    rng = np.random.default_rng(seed)

    # --- rays: KITTI HDL-64 fov_up=3, fov_down=-25 (laserscan.py:31) -----
    elev = np.deg2rad(np.linspace(3.0, -25.0, n_beams))
    azim = np.linspace(-np.pi, np.pi, n_azimuth, endpoint=False)
    el, az = np.meshgrid(elev, azim, indexing="ij")
    d = np.stack(
        [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)],
        axis=-1,
    ).reshape(-1, 3)
    o = np.array([0.0, 0.0, 1.8])

    nray = d.shape[0]
    best_t = np.full(nray, np.inf)
    best_lab = np.zeros(nray, np.int32)

    def consider(t, lab):
        nonlocal best_t, best_lab
        win = t < best_t
        best_t = np.where(win, t, best_t)
        best_lab = np.where(win, lab, best_lab)

    # ground: road corridor along a random heading, sidewalk strips, terrain
    road_dir = rng.uniform(-np.pi, np.pi)
    cr, sr = np.cos(road_dir), np.sin(road_dir)
    with np.errstate(divide="ignore"):
        tg = -o[2] / d[:, 2]
    tg = np.where((tg > 0) & (d[:, 2] < 0), tg, np.inf)
    tgf = np.where(np.isfinite(tg), tg, 0.0)
    gx = o[0] + tgf * d[:, 0]
    gy = o[1] + tgf * d[:, 1]
    lat = np.abs(-sr * gx + cr * gy)         # lateral distance from road axis
    glab = np.where(
        lat < 6.0, _L_ROAD, np.where(lat < 9.0, _L_SIDEWALK, _L_TERRAIN)
    )
    consider(tg, glab)

    # buildings: boxes flanking the road
    for _ in range(14):
        along = rng.uniform(-60, 60)
        side = rng.choice([-1, 1])
        latc = rng.uniform(12, 35) * side
        w, l_, h = rng.uniform(6, 18), rng.uniform(8, 30), rng.uniform(4, 16)
        cx = cr * along - sr * latc
        cy = sr * along + cr * latc
        t = _ray_box(o, d, np.array([cx - w / 2, cy - l_ / 2, 0.0]),
                     np.array([cx + w / 2, cy + l_ / 2, h]))
        consider(t, np.full(nray, _L_BUILDING, np.int32))

    # cars: small boxes on/near the road
    for _ in range(10):
        along = rng.uniform(-45, 45)
        latc = rng.uniform(-5.0, 5.0)
        cx = cr * along - sr * latc
        cy = sr * along + cr * latc
        yaw = road_dir + rng.normal(0, 0.1)
        cyaw, syaw = np.cos(yaw), np.sin(yaw)
        # approximate oriented car by an AABB in its own frame:
        # rotate rays into the car frame
        R = np.array([[cyaw, syaw, 0], [-syaw, cyaw, 0], [0, 0, 1.0]])
        oc = R @ (o - np.array([cx, cy, 0.0]))
        dc = d @ R.T
        t = _ray_box(oc, dc, np.array([-2.2, -0.9, 0.0]),
                     np.array([2.2, 0.9, 1.5]))
        consider(t, np.full(nray, _L_CAR, np.int32))

    # fences: long thin boxes at sidewalk edge
    for _ in range(4):
        along0 = rng.uniform(-60, 20)
        side = rng.choice([-1, 1])
        latc = rng.uniform(9.0, 11.0) * side
        ln = rng.uniform(10, 40)
        cx = cr * along0 - sr * latc
        cy = sr * along0 + cr * latc
        R = np.array([[cr, sr, 0], [-sr, cr, 0], [0, 0, 1.0]])
        oc = R @ (o - np.array([cx, cy, 0.0]))
        dc = d @ R.T
        t = _ray_box(oc, dc, np.array([0.0, -0.08, 0.0]),
                     np.array([ln, 0.08, 1.6]))
        consider(t, np.full(nray, _L_FENCE, np.int32))

    # poles + signs
    for _ in range(12):
        along = rng.uniform(-50, 50)
        side = rng.choice([-1, 1])
        latc = rng.uniform(7, 10) * side
        cx = cr * along - sr * latc
        cy = sr * along + cr * latc
        h = rng.uniform(3, 7)
        t = _ray_vcyl(o, d, cx, cy, rng.uniform(0.08, 0.2), 0.0, h)
        consider(t, np.full(nray, _L_POLE, np.int32))
        if rng.random() < 0.5:
            t = _ray_box(o, d, np.array([cx - 0.35, cy - 0.35, h]),
                         np.array([cx + 0.35, cy + 0.35, h + 0.7]))
            consider(t, np.full(nray, _L_SIGN, np.int32))

    # trees: trunk cylinder + canopy sphere (vegetation)
    for _ in range(10):
        along = rng.uniform(-55, 55)
        side = rng.choice([-1, 1])
        latc = rng.uniform(8, 25) * side
        cx = cr * along - sr * latc
        cy = sr * along + cr * latc
        th = rng.uniform(2, 4)
        t = _ray_vcyl(o, d, cx, cy, rng.uniform(0.15, 0.4), 0.0, th)
        consider(t, np.full(nray, _L_TRUNK, np.int32))
        t = _ray_sphere(o, d, cx, cy, th + 1.2, rng.uniform(1.2, 2.8))
        consider(t, np.full(nray, _L_VEG, np.int32))

    hit = best_t < max_range
    t = best_t[hit]
    dh = d[hit]
    lab = best_lab[hit]

    # range noise + a few percent unlabeled (class 0), like real scans
    t = t + rng.normal(0, 0.015, t.shape)
    xyz = (o[None, :] + t[:, None] * dh).astype(np.float32)
    lab = np.where(rng.random(len(lab)) < 0.02, 0, lab).astype(np.int32)

    # vegetation canopies are porous: drop 40% of canopy returns to mimic
    # partial transmission
    keep = ~((lab == _L_VEG) & (rng.random(len(lab)) < 0.4))
    xyz, lab = xyz[keep], lab[keep]

    # intensity: class-correlated + distance falloff + noise (learnable but
    # not trivially separable)
    rr = np.linalg.norm(xyz - o[None, :], axis=1)
    intensity = (
        0.2 + 0.6 * ((lab.astype(np.int64) * 2654435761 % 97) / 96.0)
        * np.exp(-rr / 60.0)
        + rng.normal(0, 0.05, len(lab))
    ).astype(np.float32)

    feats = np.concatenate([xyz, intensity[:, None]], axis=1).astype(
        np.float32)
    return xyz, feats, lab.astype(np.int32)


def raycast_batch(
    seed: int,
    batch_size: int,
    cap: int = 131072,
    num_class: int = 20,
):
    """Padded batch dict of numpy arrays: xyz [B, cap, 3], feats
    [B, cap, 4], labels [B, cap] (-1 pad), valid [B, cap]."""
    xyzs, feats, labels, valids = [], [], [], []
    for i in range(batch_size):
        x, f, l = raycast_scan(seed * 1000 + i, num_class=num_class)
        px, pf, pl, pv = pad_scan(x, f, l, cap)
        xyzs.append(px); feats.append(pf); labels.append(pl); valids.append(pv)
    return dict(
        xyz=np.stack(xyzs),
        feats=np.stack(feats),
        labels=np.stack(labels),
        valid=np.stack(valids),
    )
