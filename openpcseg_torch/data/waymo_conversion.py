"""Self-contained Waymo range-image -> point-cloud conversion (numpy).

Re-derivation of the math inside waymo_open_dataset's
range_image_utils.extract_point_cloud_from_range_image, as used by the
reference's converter (reference pcseg/utils/waymo_utils.py:85-194 — which
delegates the geometry to the waymo package). Here the geometry is
implemented directly so the preprocessor works wherever the proto payloads
can be decoded, and the math is unit-testable without the optional
`waymo-open-dataset` dependency (round-trip tests in
tests/test_waymo_conversion.py).

Conventions (Waymo spec):
- rows are beams ordered TOP-of-fov first => inclinations passed here are
  per-row, row 0 = highest beam (callers reverse the calibration list,
  reference waymo_utils.py:139);
- column azimuth sweeps from +pi to -pi across the image, corrected by the
  extrinsic yaw so column 0 faces the sensor's rear seam;
- the cartesian point is direction * range in SENSOR frame, then pushed
  through the extrinsic into the VEHICLE frame; for the TOP lidar a
  per-pixel pose (rolling shutter) maps via world back into the frame pose.

A copy of ``openpcseg_tpu/data/waymo_conversion.py`` (the port imports
nothing of the JAX package), held to it by tests/test_torch_waymo.py.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def compute_inclinations(inclination_min: float, inclination_max: float,
                         height: int) -> np.ndarray:
    """Uniform beam inclinations, BOTTOM-first (matching
    range_image_utils.compute_inclination): centers of `height` equal bins.
    """
    frac = (np.arange(height, dtype=np.float64) + 0.5) / height
    return (inclination_min
            + frac * (inclination_max - inclination_min)).astype(np.float64)


def range_image_to_cartesian(
    range_img: np.ndarray,            # [H, W] range in meters (<=0 = miss)
    extrinsic: np.ndarray,            # [4, 4] sensor->vehicle
    inclinations: np.ndarray,         # [H] per-row, row 0 = TOP beam
    pixel_pose: Optional[np.ndarray] = None,   # [H, W, 4, 4] vehicle->world
    frame_pose: Optional[np.ndarray] = None,   # [4, 4] vehicle->world
) -> np.ndarray:
    """Returns [H, W, 3] vehicle-frame xyz (garbage where range<=0)."""
    h, w = range_img.shape
    incl = np.asarray(inclinations, np.float64)
    assert incl.shape == (h,)

    # column azimuths: +pi..-pi sweep, minus the extrinsic yaw
    az_correction = np.arctan2(extrinsic[1, 0], extrinsic[0, 0])
    ratios = (np.arange(w, dtype=np.float64) + 0.5) / w
    azimuth = (np.pi - 2.0 * np.pi * ratios)[None, :] - az_correction

    cos_i = np.cos(incl)[:, None]
    sin_i = np.sin(incl)[:, None]
    x = cos_i * np.cos(azimuth) * range_img
    y = cos_i * np.sin(azimuth) * range_img
    z = sin_i * np.ones_like(azimuth) * range_img
    p_sensor = np.stack([x, y, z], axis=-1)            # [H, W, 3]

    # sensor -> vehicle
    rot, tr = extrinsic[:3, :3], extrinsic[:3, 3]
    p_vehicle = p_sensor @ rot.T + tr

    if pixel_pose is not None:
        assert frame_pose is not None
        # vehicle -> world per pixel, then world -> frame vehicle
        pr = pixel_pose[..., :3, :3]                    # [H, W, 3, 3]
        pt = pixel_pose[..., :3, 3]
        p_world = np.einsum("hwij,hwj->hwi", pr, p_vehicle) + pt
        inv = np.linalg.inv(frame_pose)
        p_vehicle = p_world @ inv[:3, :3].T + inv[:3, 3]

    return p_vehicle.astype(np.float32)


def range_image_to_points(
    range_image_tensor: np.ndarray,   # [H, W, >=4]: range, int, elong, nlz
    extrinsic: np.ndarray,
    inclinations: np.ndarray,
    labels_img: Optional[np.ndarray] = None,  # [H, W] semantic labels
    pixel_pose: Optional[np.ndarray] = None,
    frame_pose: Optional[np.ndarray] = None,
):
    """Mask + flatten one return, reference row layout
    ([range, intensity, elongation, x, y, z(, label)]): returns
    (points [N, 6] float32, labels [N] int32 or None)."""
    rng_img = range_image_tensor[..., 0]
    mask = rng_img > 0
    xyz = range_image_to_cartesian(
        rng_img, extrinsic, inclinations, pixel_pose, frame_pose)
    cols = [rng_img[mask], range_image_tensor[..., 1][mask],
            range_image_tensor[..., 2][mask],
            xyz[mask][:, 0], xyz[mask][:, 1], xyz[mask][:, 2]]
    pts = np.stack(cols, axis=1).astype(np.float32)
    lab = labels_img[mask].astype(np.int32) if labels_img is not None else None
    return pts, lab
