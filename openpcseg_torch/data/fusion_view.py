"""Fusion-modality dataset view: voxel pipeline + per-scan range image.

Counterpart of the reference SemkittiFusionDataset
(reference: pcseg/data/dataset/semantickitti/semantickitti_fusion.py:17-245):
on top of the padded voxel view, each scan gets a 64x2048 range image with
random azimuth cut — channels [25*(1/depth-0.4), 20*(reflectivity-0.5),
x, y, z] — plus per-point normalized pixel coords (px, py) in [-1, 1]
(get_range_image :64-114). The reference's cv2 INTER_LINEAR resize is an
identity here (INIT_HW == UP_HW in the reference too).

Deviation: the reference builds the range image from the host-deduplicated
points; we build it from all padded points (dedup runs on device), which
only fills more pixels of the same image.

A copy of ``openpcseg_tpu/data/fusion_view.py`` (the port imports nothing
of the JAX package), held to it by tests/test_torch_data.py. SPVCNN reads
the voxel features only; the range image and pxpy travel with the batch
as in JAX, for RPVNet (ROADMAP.md Queue 1 item 13).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .voxel_view import SemkittiVoxelDataset


def build_fusion_range_image(
    points: np.ndarray,      # [N, >=5] x, y, z, intensity, ring
    h: int = 64,
    w: int = 2048,
    rng: Optional[np.random.Generator] = None,
    row: Optional[np.ndarray] = None,   # per-point image row override;
                                        # default = ring id column 4
                                        # (Waymo has no rings — its view
                                        # passes inclination-binned rows)
):
    """Returns (range_image [H, W, 5], pxpy [N, 2] in [-1, 1])."""
    rng = rng or np.random.default_rng()
    depth = np.linalg.norm(points[:, :3], 2, axis=1)
    depth = np.maximum(depth, 1e-6)
    yaw = np.arctan2(points[:, 1], -points[:, 0])
    yaw = yaw + (rng.random() - 0.5) * 2 * np.pi  # random azimuth cut
    yaw = yaw % (2 * np.pi) - np.pi
    proj_x = 0.5 * (yaw / np.pi + 1.0) * (w - 1)
    proj_y = np.clip(points[:, 4] if row is None else row, 0, h - 1)

    ix = np.round(proj_x).astype(np.int32)
    iy = np.round(proj_y).astype(np.int32)

    img = np.zeros((h, w, 5), np.float32)
    img[iy, ix, 0] = 1.0 / depth
    img[iy, ix, 1] = points[:, 3]
    img[iy, ix, 2:5] = points[:, :3]
    img[..., 0] = 25.0 * (img[..., 0] - 0.4)
    img[..., 1] = 20.0 * (img[..., 1] - 0.5)

    px = 2.0 * (ix / (w - 1) - 0.5)
    py = 2.0 * (iy / (h - 1) - 0.5)
    return img, np.stack([px, py], axis=1).astype(np.float32)


class SemkittiFusionDataset(SemkittiVoxelDataset):
    """Voxel view + range image + per-point pxpy.

    Sample keys: xyz/feats/labels/valid (padded, feats = [x,y,z,i,ring]) +
    range_image [H, W, 5] + pxpy [cap, 2].
    """

    RANGE_H = 64
    RANGE_W = 2048
    PACK_FEAT_DIM = 5

    def __init__(self, data_cfgs, **kw):
        super().__init__(data_cfgs, **kw)
        self.RANGE_H = data_cfgs.get("RANGE_H", self.RANGE_H)
        self.RANGE_W = data_cfgs.get("RANGE_W", self.RANGE_W)

    def get_sample(self, index: int, num_vote: int = 0,
                   tta: bool = False,
                   rng=None) -> Dict[str, np.ndarray]:
        rng = rng if rng is not None else self.rng
        src = getattr(self.source, "get_with_rng", None)
        pc = src(index, rng) if src is not None else self.source[index]
        point = pc["xyzret"].astype(np.float32)  # x,y,z,i,ring
        labels = pc["labels"].reshape(-1)

        from .augment import aug_points
        if self.training or tta:
            point[:, :3] = aug_points(
                point[:, :3],
                if_flip=False if tta else self.if_flip,
                if_scale=self.if_scale,
                scale_axis=self.scale_axis,
                scale_range=[0.95, 1.05] if tta else self.scale_range,
                if_jitter=False if tta else self.if_jitter,
                if_rotate=self.if_rotate,
                if_tta=tta,
                num_vote=num_vote,
                rng=rng,
            )

        row = (self._range_row(point)
               if hasattr(self, "_range_row") else None)
        img, pxpy = build_fusion_range_image(
            point, self.RANGE_H, self.RANGE_W, rng, row=row)

        cap = self.point_cap
        if len(point) > cap:
            # one shared subset for points AND pxpy (the base _pack would
            # otherwise draw its own)
            sel = rng.choice(len(point), cap, replace=False)
            point, labels, pxpy = point[sel], labels[sel], pxpy[sel]

        # feats: x,y,z,i(,ring) — PACK_FEAT_DIM 5 for 64-beam KITTI/Waymo,
        # 4 for nuScenes (IN_FEATURE_DIM 4 configs)
        out = self._pack(point[:, :3], point[:, :self.PACK_FEAT_DIM],
                         labels, pc["path"], rng)
        ppxpy = np.zeros((cap, 2), np.float32)
        n = min(len(pxpy), cap)
        ppxpy[:n] = pxpy[:n]
        out["range_image"] = img
        out["pxpy"] = ppxpy
        return out
