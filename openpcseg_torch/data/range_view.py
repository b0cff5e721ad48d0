"""Range-view (spherical projection) dataset + augmentations (host, numpy).

Re-implementations of the reference range pipeline:
- spherical projection with depth-ordered z-buffer
  (reference: pcseg/data/dataset/semantickitti/laserscan.py:174-238)
- per-pixel input tensor [x/50, y/50, z/3, intensity, depth/80, mask]
  (reference: semantickitti_rv.py:284-301 prepare_input_label_semantic_with_mask)
- point-level augs: drop/flip/scale/rotate/jitter (laserscan.py:104-143)
- RangeShift: random azimuth column roll of the projected images
  (semantickitti_rv.py:304-320)
- RangePaste: copy rare-class pixels from a second scan (:210-260)
- RangeUnion: fill empty pixels from a second scan (:197-207)
- RangeMix: alternating grid mix of two scans — exact MixTeacher
  'mixtureV2' semantics (:360-1621): the 17 colNrowM checkerboard
  strategies plus the mix1/mix2 complement pick.

Test-time augmentation: the reference defines TTA only for the voxel/
cylinder/fusion views (collate_batch_tta); its range pipeline has none, so
none is implemented here either (the per-point KNN post-processing is the
range pipeline's accuracy lever instead).

A copy of ``openpcseg_tpu/data/range_view.py`` (the port imports nothing
of the JAX package), held to it by tests/test_torch_range_data.py. The
dataset projects every image (training, eval, each TTA vote) with the
native C++ z-buffer (``openpcseg_torch/native.py range_project``, the JAX
package's default path, bit for bit), which raises where g++ is missing.
The numpy z-buffer here (``range_project``, float64 angles) lands a few
pixels of a scan elsewhere; it stays for the per-point eval arrays and
the synthetic batch, as in the JAX package.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from .. import native
from .semantickitti import SemantickittiDataset
from .semantickitti_meta import CLASS_NAMES

# rare classes pasted by RangePaste (reference semantickitti_rv.py:55-59
# instance_list, resolved to train ids)
RANGE_PASTE_CLASSES = [2, 3, 4, 5, 6, 7, 8, 12, 16, 18, 19]


def range_project(
    points: np.ndarray,        # [N, 3]
    remission: np.ndarray,     # [N]
    labels: Optional[np.ndarray],  # [N] or None
    h: int, w: int,
    fov_up_deg: float = 3.0,
    fov_down_deg: float = -25.0,
) -> Dict[str, np.ndarray]:
    """Spherical projection with farthest-first z-buffer (closest wins),
    matching laserscan.py:174-238."""
    fov_up = fov_up_deg / 180.0 * np.pi
    fov_down = fov_down_deg / 180.0 * np.pi
    fov = abs(fov_down) + abs(fov_up)

    depth = np.linalg.norm(points, 2, axis=1)
    depth = np.maximum(depth, 1e-8)
    yaw = -np.arctan2(points[:, 1], points[:, 0])
    pitch = np.arcsin(np.clip(points[:, 2] / depth, -1, 1))

    proj_x = 0.5 * (yaw / np.pi + 1.0) * w
    proj_y = (1.0 - (pitch + abs(fov_down)) / fov) * h
    proj_x = np.clip(np.floor(proj_x), 0, w - 1).astype(np.int32)
    proj_y = np.clip(np.floor(proj_y), 0, h - 1).astype(np.int32)

    order = np.argsort(depth)[::-1]  # draw far first, near overwrites
    py, px = proj_y[order], proj_x[order]

    proj_range = np.zeros((h, w), np.float32)
    proj_xyz = np.zeros((h, w, 3), np.float32)
    proj_rem = np.zeros((h, w), np.float32)
    proj_idx = np.full((h, w), -1, np.int64)
    proj_range[py, px] = depth[order]
    proj_xyz[py, px] = points[order]
    proj_rem[py, px] = remission[order]
    proj_idx[py, px] = np.arange(len(points))[order]
    # NOTE: reference uses (proj_idx > 0) — index 0's pixel counts as empty,
    # an off-by-one in the reference; we keep >= 0 (correct occupancy)
    proj_mask = (proj_idx >= 0).astype(np.float32)

    out = {
        "xyz": proj_xyz, "intensity": proj_rem, "range_img": proj_range,
        "xyz_mask": proj_mask, "proj_idx": proj_idx,
        "proj_x": proj_x, "proj_y": proj_y, "unproj_range": depth,
    }
    if labels is not None:
        lab = np.zeros((h, w), np.int32)
        lab[py, px] = labels[order]
        out["semantic_label"] = lab * proj_mask.astype(np.int32)
    return out


def pack_scan_tensor(sample: Dict[str, np.ndarray]) -> Tuple[np.ndarray, ...]:
    """[H, W, 6]: xyz/(50,50,3), intensity, depth/80, mask
    (reference semantickitti_rv.py:284-301)."""
    scale = np.asarray([50.0, 50.0, 3.0], np.float32)
    scan = np.concatenate([
        sample["xyz"] / scale,
        sample["intensity"][..., None],
        sample["range_img"][..., None] / 80.0,
        sample["xyz_mask"][..., None],
    ], axis=-1).astype(np.float32)
    return scan, sample["semantic_label"], sample["xyz_mask"]


def range_paste(scan, label, mask, scan_b, label_b, mask_b):
    """Overwrite pixels with another scan's rare-class pixels
    (reference :210-260)."""
    sel = np.isin(label_b, RANGE_PASTE_CLASSES) & (mask_b > 0)
    scan = np.where(sel[..., None], scan_b, scan)
    label = np.where(sel, label_b, label)
    mask = np.where(sel, mask_b, mask)
    return scan, label, mask


def range_union(scan, label, mask, scan_b, label_b, mask_b):
    """Fill empty pixels from another scan (reference :197-207)."""
    empty = mask == 0
    scan = np.where(empty[..., None], scan_b, scan)
    label = np.where(empty, label_b, label)
    mask = np.where(empty, mask_b, mask)
    return scan, label, mask


# MixTeacher 'mixtureV2' strategy pool as (n_cols, n_rows) — the
# reference's 17 colNrowM methods (semantickitti_rv.py:387-469) are each
# an alternating checkerboard over N column x M row bands; the strategy
# set below reproduces the pool verbatim
MIXTEACHER_V2_STRATEGIES = [
    (1, 3), (1, 4), (1, 5), (1, 6),
    (2, 3), (2, 4), (2, 5), (2, 6),
    (3, 3), (3, 4), (3, 5), (3, 6),
    (4, 3), (4, 4), (4, 5), (4, 6),
    (6, 4),
]


def range_mix(scan, label, mask, scan_b, label_b, mask_b,
              rng: np.random.Generator):
    """Alternating band mix of two range images: exact MixTeacher
    'mixtureV2' semantics (semantickitti_rv.py:360-1621) — each colNrowM
    strategy is the checkerboard with that many column/row bands, and the
    reference's mix1/mix2 pair pick (:170-175) is the complement flip."""
    h, w = label.shape
    n_cols, n_rows = MIXTEACHER_V2_STRATEGIES[
        int(rng.integers(len(MIXTEACHER_V2_STRATEGIES)))]
    row_id = (np.arange(h)[:, None] * n_rows // h)
    col_id = (np.arange(w)[None, :] * n_cols // w)
    take_b = ((row_id + col_id) % 2).astype(bool)
    if rng.random() < 0.5:          # mix2 = complement of mix1
        take_b = ~take_b
    take_b = np.broadcast_to(take_b, (h, w))
    scan_m = np.where(take_b[..., None], scan_b, scan)
    label_m = np.where(take_b, label_b, label)
    mask_m = np.where(take_b, mask_b, mask)
    return scan_m, label_m, mask_m


class SemkittiRangeViewDataset:
    """Range-view dataset yielding dense [H, W, 6] tensors + label/mask
    images (reference: semantickitti_rv.py:15-320)."""

    def __init__(
        self,
        data_cfgs,
        training: bool = True,
        root_path: Optional[str] = None,
        point_cap: int = 0,  # unused (dense images); kept for API parity
        seed: int = 0,
    ):
        self.point_eval_cap = point_cap or 131072
        self.data_cfgs = data_cfgs
        self.training = training
        self.class_names = CLASS_NAMES
        self.h = data_cfgs.get("H", 64)
        self.w = data_cfgs.get("W", 2048)
        # sensor FOV (degrees); nuScenes subclass overrides via cfg
        self.fov_up = float(data_cfgs.get("FOV_UP", 3.0))
        self.fov_down = float(data_cfgs.get("FOV_DOWN", -25.0))
        self.rng = np.random.default_rng(seed + 2)

        # reuse the raw reader (scan-mix off: range has its own mixers)
        cfg = dict(data_cfgs)
        cfg["AUGMENT"] = "NoAugment"
        from ..config import CfgDict
        self.source = self._make_source(
            CfgDict(cfg), training, root_path, seed)

        t = training
        self.if_drop = t and data_cfgs.get("IF_DROP", True)
        self.if_flip = t and data_cfgs.get("IF_FLIP", True)
        self.if_scale = t and data_cfgs.get("IF_SCALE", True)
        self.if_rotate = t and data_cfgs.get("IF_ROTATE", True)
        self.if_jitter = t and data_cfgs.get("IF_JITTER", True)
        self.p_mix = data_cfgs.get("IF_RANGE_MIX", 0.0) if t else 0.0
        self.p_shift = data_cfgs.get("IF_RANGE_SHIFT", 0.0) if t else 0.0
        self.p_paste = data_cfgs.get("IF_RANGE_PASTE", 0.0) if t else 0.0
        self.p_union = data_cfgs.get("IF_RANGE_UNION", 0.0) if t else 0.0

    def _make_source(self, data_cfgs, training, root_path, seed):
        return SemantickittiDataset(
            data_cfgs, training=training, root_path=root_path,
            if_scribble=(data_cfgs.DATASET == "scribblekitti"), seed=seed,
        )

    def __len__(self) -> int:
        return len(self.source)

    def resample(self) -> None:
        self.source.resample()

    def _augment_points(self, pts: np.ndarray, rem: np.ndarray,
                        lab: np.ndarray):
        """laserscan.py:104-143 drop/flip/scale/rotate/jitter."""
        rng = self.rng
        if self.if_drop and len(pts) > 2:
            num_drop = int(rng.integers(0, max(1, int(len(pts) * 0.1))))
            drop = np.unique(rng.integers(0, len(pts) - 1, size=num_drop))
            keep = np.ones(len(pts), bool)
            keep[drop] = False
            pts, rem, lab = pts[keep], rem[keep], lab[keep]
        if self.if_flip:
            ft = int(rng.integers(0, 4))
            pts = pts.copy()
            if ft == 1:
                pts[:, 0] = -pts[:, 0]
            elif ft == 2:
                pts[:, 1] = -pts[:, 1]
            elif ft == 3:
                pts[:, :2] = -pts[:, :2]
        if self.if_scale:
            s = rng.uniform(1.0, 1.05)
            if rng.random() < 0.5:
                s = 1.0 / 1.05
            pts = pts.copy()
            pts[:, 0] *= s
            pts[:, 1] *= s
        if self.if_rotate:
            rad = np.deg2rad(rng.random() * 360)
            c, s = np.cos(rad), np.sin(rad)
            rot = np.array([[c, s], [-s, c]])
            pts = pts.copy()
            pts[:, :2] = pts[:, :2] @ rot
        if self.if_jitter:
            j = np.clip(rng.normal(0, 0.1, 3), -0.3, 0.3)
            pts = pts + j
        return pts, rem, lab

    def _load_projected(self, index: int):
        pc = self.source[index]
        pts = pc["xyzret"][:, :3].astype(np.float64)
        rem = pc["xyzret"][:, 3].astype(np.float32)
        lab = pc["labels"]
        if self.training:
            pts, rem, lab = self._augment_points(pts, rem, lab)

        do_shift = self.rng.random() < self.p_shift
        split = int(self.rng.integers(100, self.w - 100)) if do_shift else 0

        # the native projection (C++ z-buffer + tensor packing, JAX's own
        # arithmetic); the column roll of RangeShift is a post-op
        pts4 = np.concatenate(
            [pts.astype(np.float32), rem[:, None]], axis=1)
        scan, label, mask = native.range_project(
            pts4, lab.astype(np.int32), self.h, self.w,
            self.fov_up, self.fov_down)[:3]
        mask = mask.astype(np.float32)
        if do_shift:
            scan = np.concatenate([scan[:, split:], scan[:, :split]], axis=1)
            label = np.concatenate(
                [label[:, split:], label[:, :split]], axis=1)
            mask = np.concatenate([mask[:, split:], mask[:, :split]], axis=1)
        return (scan, label, mask), pc["path"]

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        (scan, label, mask), path = self._load_projected(index)

        if self.p_mix > 0 or self.p_paste > 0 or self.p_union > 0:
            idx2 = int(self.rng.integers(0, len(self.source)))
            (scan_b, label_b, mask_b), _ = self._load_projected(idx2)
            if self.rng.random() < self.p_mix:
                scan, label, mask = range_mix(
                    scan, label, mask, scan_b, label_b, mask_b, self.rng)
            if self.rng.random() < self.p_paste:
                scan, label, mask = range_paste(
                    scan, label, mask, scan_b, label_b, mask_b)
            if self.rng.random() < self.p_union:
                scan, label, mask = range_union(
                    scan, label, mask, scan_b, label_b, mask_b)

        out = {
            "scan": scan.astype(np.float32),
            "label": label.astype(np.int32),
            "mask": mask.astype(np.float32),
            "name": path,
        }
        if not self.training:
            out.update(self._point_eval_arrays(index))
        return out

    def get_tta_sample(self, index: int, voting: int = 10):
        """Deterministic TTA votes for the range view.

        The voxel TTA rotates the scan about z per vote (reference
        semantickitti_voxel.py:62-69). Under spherical projection a yaw
        rotation IS a column roll of the range image, so each vote is a
        roll of ONE projection by ``v * W / voting`` columns — the
        per-point px arrays roll with it so every vote's pixel
        probabilities gather back to the same original points."""
        (scan, label, mask), path = self._load_projected(index)
        pe = self._point_eval_arrays(index)
        votes = []
        for v in range(voting):
            shift = (v * self.w) // voting
            s = {
                "scan": np.roll(scan, -shift, axis=1) if shift else scan,
                "label": np.roll(label, -shift, axis=1) if shift else label,
                "mask": np.roll(mask, -shift, axis=1) if shift else mask,
                "name": path,
                "p_label": pe["p_label"], "p_py": pe["p_py"],
                "p_range": pe["p_range"], "p_valid": pe["p_valid"],
                "p_px": (pe["p_px"] - shift) % self.w,
            }
            s["scan"] = s["scan"].astype(np.float32)
            votes.append(s)
        return votes

    def _point_eval_arrays(self, index: int) -> Dict[str, np.ndarray]:
        """Per-point projection arrays for point-level eval (reference
        range/utils.py:209-341: predictions are re-projected from pixels to
        the ORIGINAL points, optionally KNN-refined — published range mIoU
        protocols are per-point, not per-pixel). Eval is unaugmented, so
        px/py/range are the closed-form projection of the raw scan."""
        pc = self.source[index]
        pts = pc["xyzret"][:, :3].astype(np.float32)
        lab = pc["labels"].reshape(-1).astype(np.int32)
        depth = np.maximum(np.linalg.norm(pts, 2, axis=1), 1e-8)
        yaw = -np.arctan2(pts[:, 1], pts[:, 0])
        pitch = np.arcsin(np.clip(pts[:, 2] / depth, -1, 1))
        fov_up = self.fov_up / 180.0 * np.pi
        fov_down = self.fov_down / 180.0 * np.pi
        fov = abs(fov_down) + abs(fov_up)
        px = np.clip(np.floor(0.5 * (yaw / np.pi + 1.0) * self.w),
                     0, self.w - 1).astype(np.int32)
        py = np.clip(
            np.floor((1.0 - (pitch + abs(fov_down)) / fov) * self.h),
            0, self.h - 1).astype(np.int32)

        cap = self.point_eval_cap
        n = min(len(pts), cap)
        out = {
            "p_label": np.full((cap,), -1, np.int32),
            "p_px": np.zeros((cap,), np.int32),
            "p_py": np.zeros((cap,), np.int32),
            "p_range": np.zeros((cap,), np.float32),
            "p_valid": np.zeros((cap,), bool),
        }
        out["p_label"][:n] = lab[:n]
        out["p_px"][:n] = px[:n]
        out["p_py"][:n] = py[:n]
        out["p_range"][:n] = depth[:n]
        out["p_valid"][:n] = True
        return out


def synthetic_range_batch(seed: int, batch: int, h: int = 64, w: int = 512,
                          num_class: int = 20):
    """Synthetic range-view batch for hermetic tests/bench."""
    from .synthetic import synthetic_scan
    scans, labels, masks = [], [], []
    for i in range(batch):
        xyz, feats, lab = synthetic_scan(seed * 100 + i, n_points=h * w * 2,
                                         num_class=num_class)
        s = range_project(xyz, feats[:, 3], lab, h, w)
        scan, label, mask = pack_scan_tensor(s)
        scans.append(scan); labels.append(label); masks.append(mask)
    return {
        "scan": np.stack(scans), "label": np.stack(labels),
        "mask": np.stack(masks),
    }
