"""Host-side point-cloud augmentations (numpy).

Re-implementations of the reference's augmentation set:
- aug_points: rotate/scale/flip/jitter + deterministic TTA variants
  (reference: tools/utils/common/seg_utils.py:43-100)
- lasermix: inclination-band alternating mix of two scans
  (reference: pcseg/data/dataset/semantickitti/LaserMix_semantickitti.py:11-113).
  NOTE: the reference compares radian inclinations against thresholds written
  as ``-6.7 / pi * 180`` (~-383), a units bug that degenerates every band
  test and makes its LaserMix a no-op. We implement the intended LaserMix
  (arXiv:2207.00026): thresholds in radians, ``deg * pi / 180``.
- polarmix: azimuth-sector swap + instance rotate-paste
  (reference: PolarMix_semantickitti.py:9-74, after github.com/xiaoaoran/polarmix)

A copy of ``openpcseg_tpu/data/augment.py`` (the port imports
nothing of the JAX package), held to it by tests/test_torch_data.py.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# deterministic TTA rotation angles (reference seg_utils.py:57-61)
TTA_ANGLE_VEC = [0, 1, -1, 2, -2, 6, -6, 7, -7, 8]


def aug_points(
    xyz: np.ndarray,
    if_flip: bool = False,
    if_scale: bool = False,
    scale_axis: str = "xyz",
    scale_range: Sequence[float] = (0.9, 1.1),
    if_jitter: bool = False,
    if_rotate: bool = False,
    if_tta: bool = False,
    num_vote: int = 0,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Global xyz augmentation; returns transformed xyz."""
    rng = rng or np.random.default_rng()
    xyz = np.array(xyz, np.float64)

    if if_rotate:
        if if_tta:
            theta = TTA_ANGLE_VEC[num_vote] * np.pi / 8.0
        else:
            theta = rng.uniform(0, 2 * np.pi)
        c, s = np.cos(theta), np.sin(theta)
        rot = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
        xyz = xyz @ rot

    if if_scale:
        # per-axis scaling restricted to the axes named in SCALE_AUG_AXIS
        # (reference seg_utils.py:43-100; shipped configs use 'xyz')
        factor = rng.uniform(scale_range[0], scale_range[1])
        scale = np.ones(3)
        for ax, name in enumerate("xyz"):
            if name in scale_axis:
                scale[ax] = factor
        xyz = xyz * scale

    if if_flip:
        flip_type = num_vote if if_tta else int(rng.integers(0, 4))
        if flip_type == 1:
            xyz[:, 0] = -xyz[:, 0]
        elif flip_type == 2:
            xyz[:, 1] = -xyz[:, 1]
        elif flip_type == 3:
            xyz[:, :2] = -xyz[:, :2]

    if if_jitter:
        xyz = xyz + rng.normal(0, 0.1, size=(1, 3))

    return xyz.astype(np.float32)


def _inclination(xyzi: np.ndarray) -> np.ndarray:
    rho = np.sqrt(xyzi[:, 0] ** 2 + xyzi[:, 1] ** 2)
    return np.arctan2(xyzi[:, 2], rho)  # radians


# LaserMix band edges in degrees per strategy (intent of the reference's
# inc{3..6}phi1 strategies, LaserMix_semantickitti.py:31-109)
_LASERMIX_BANDS = {
    "inc3phi1": [-6.7, -13.4],
    "inc4phi1": [-5.0, -10.0, -15.0],
    "inc5phi1": [-4.0, -8.0, -12.0, -16.0],
    "inc6phi1": [-3.3, -6.6, -9.9, -13.2, -16.5],
}


def lasermix(
    xyzi_a: np.ndarray, label_a: np.ndarray,
    xyzi_b: np.ndarray, label_b: np.ndarray,
    rng: np.random.Generator | None = None,
    fov_scale: Tuple[float, float] | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Alternate inclination bands between two scans; returns the mix that
    starts with scan A's top band (the reference returns xyzil_mix_1).

    ``fov_scale=(lo_deg, hi_deg)`` linearly remaps the KITTI band edges
    (defined over [-25, 3] degrees) onto another sensor's FOV — used by the
    nuScenes reader (32-beam, [-30, 10])."""
    rng = rng or np.random.default_rng()
    strategy = rng.choice(list(_LASERMIX_BANDS))
    edges_deg = _LASERMIX_BANDS[strategy]
    if fov_scale is not None:
        lo, hi = fov_scale
        edges_deg = [lo + (e - (-25.0)) / 28.0 * (hi - lo)
                     for e in edges_deg]
    edges = [e * np.pi / 180.0 for e in edges_deg]

    inc_a = _inclination(xyzi_a)
    inc_b = _inclination(xyzi_b)
    bounds = [np.inf] + edges + [-np.inf]

    parts_x: List[np.ndarray] = []
    parts_l: List[np.ndarray] = []
    for i in range(len(bounds) - 1):
        hi, lo = bounds[i], bounds[i + 1]
        src_x, src_l, inc = (
            (xyzi_a, label_a, inc_a) if i % 2 == 0 else (xyzi_b, label_b, inc_b)
        )
        m = (inc <= hi) & (inc > lo)
        parts_x.append(src_x[m])
        parts_l.append(src_l[m])
    return np.concatenate(parts_x, axis=0), np.concatenate(parts_l, axis=0)


def polarmix(
    pts1: np.ndarray, labels1: np.ndarray,
    pts2: np.ndarray, labels2: np.ndarray,
    alpha: float, beta: float,
    instance_classes: Sequence[int],
    omega: Sequence[float],
    rng: np.random.Generator | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Azimuth-sector swap (p=0.5) + rotate-paste of instance classes
    (reference PolarMix_semantickitti.py:61-74)."""
    rng = rng or np.random.default_rng()
    pts_out, labels_out = pts1, labels1

    if rng.random() < 0.5:
        yaw1 = -np.arctan2(pts1[:, 1], pts1[:, 0])
        yaw2 = -np.arctan2(pts2[:, 1], pts2[:, 0])
        in1 = (yaw1 > alpha) & (yaw1 < beta)
        in2 = (yaw2 > alpha) & (yaw2 < beta)
        pts_out = np.concatenate([pts1[~in1], pts2[in2]], axis=0)
        labels_out = np.concatenate([labels1[~in1], labels2[in2]], axis=0)

    # rotate-paste (reference applies with probability 1.0)
    inst_mask = np.isin(labels2, np.asarray(instance_classes))
    pts_inst, labels_inst = pts2[inst_mask], labels2[inst_mask]
    copies_x, copies_l = [pts_inst], [labels_inst]
    for om in omega:
        c, s = np.cos(om), np.sin(om)
        rot = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
        new = pts_inst.copy()
        new[:, :3] = pts_inst[:, :3] @ rot
        copies_x.append(new)
        copies_l.append(labels_inst)
    pts_out = np.concatenate([pts_out] + copies_x, axis=0)
    labels_out = np.concatenate([labels_out] + copies_l, axis=0)
    return pts_out, labels_out
