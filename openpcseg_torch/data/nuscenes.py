"""nuScenes-lidarseg raw scan reader (host, numpy only, devkit-free).

Implements the dataset family the reference REFERENCES but never ships
(reference pcseg/data/__init__.py:59-87 dispatches to NuscVoxelDataset /
NuscRangeViewDataset / NuscCylinderDataset / NuscFusionDataset — the
classes do not exist anywhere in the reference tree). Reads the official
directory layout directly:

    <root>/v1.0-trainval/{sample_data,sample,scene,lidarseg}.json
    <root>/samples/LIDAR_TOP/*.pcd.bin          (float32 x,y,z,i,ring)
    <root>/lidarseg/v1.0-trainval/*_lidarseg.bin (uint8 raw category)

Split handling: scene-level. ``DATA.TRAIN_SCENES`` / ``DATA.VAL_SCENES``
may name text files of scene names (one per line, the official devkit
700/150 lists); without them a deterministic seeded 85/15 scene split
stands in (documented in the config). ``DATA.SPLIT_FILE`` restricts
training to listed lidar filenames for semi-supervised protocols
(tools/scripts/make_nuscenes_splits.py generates stratified pct lists).

A copy of ``openpcseg_tpu/data/nuscenes.py`` (the port imports nothing
of the JAX package), held to it by tests/test_torch_nuscenes.py; its
``CfgDict`` is the port's (``openpcseg_torch/config.py``).
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import augment
from .nuscenes_meta import LEARNING_MAP_LUT

# thing classes for PolarMix instance paste (barrier..truck)
POLARMIX_INSTANCE_CLASSES = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]


def _load_table(root: Path, version: str, name: str):
    with open(root / version / f"{name}.json") as f:
        return json.load(f)


class NuscenesDataset:
    """Raw scan source yielding dicts {'xyzret', 'labels', 'path'}."""

    def __init__(
        self,
        data_cfgs,
        training: bool = True,
        root_path: Optional[str] = None,
        seed: int = 0,
    ):
        self.data_cfgs = data_cfgs
        self.training = training
        self.root_path = Path(root_path or data_cfgs.DATA_PATH)
        self.version = data_cfgs.get("VERSION", "v1.0-trainval")
        self.augment_mode = data_cfgs.get("AUGMENT", "GlobalAugment_LP")
        self.tta = data_cfgs.get("TTA", False)
        train_val = data_cfgs.get("TRAINVAL", False)

        if training:
            self.split = "train_val" if train_val else "train"
        else:
            self.split = "val"
        if self.tta:
            self.split = "test"

        root = self.root_path
        samples = {s["token"]: s for s in
                   _load_table(root, self.version, "sample")}
        scenes = {s["token"]: s for s in
                  _load_table(root, self.version, "scene")}
        sample_data = _load_table(root, self.version, "sample_data")
        try:
            lidarseg = {e["sample_data_token"]: e["filename"]
                        for e in _load_table(root, self.version, "lidarseg")}
        except FileNotFoundError:
            lidarseg = {}

        # key-frame LIDAR_TOP sweeps with their scene name
        records = []
        for sd in sample_data:
            fn = sd.get("filename", "")
            if not sd.get("is_key_frame") or "LIDAR_TOP" not in fn:
                continue
            scene_tok = samples[sd["sample_token"]]["scene_token"]
            records.append({
                "path": str(root / fn),
                "label": (str(root / lidarseg[sd["token"]])
                          if sd["token"] in lidarseg else None),
                "scene": scenes[scene_tok]["name"],
                # sample_data token: names official lidarseg submission
                # files (<token>_lidarseg.bin)
                "token": sd["token"],
            })
        records.sort(key=lambda r: r["path"])

        train_scenes = self._scene_list(data_cfgs.get("TRAIN_SCENES", None))
        val_scenes = self._scene_list(data_cfgs.get("VAL_SCENES", None))
        if train_scenes is None or val_scenes is None:
            # deterministic seeded stand-in for the official 700/150 lists
            names = sorted({r["scene"] for r in records})
            rs = np.random.default_rng(0).permutation(len(names))
            n_val = max(1, int(round(len(names) * 0.15)))
            val_set = {names[i] for i in rs[:n_val]}
            train_scenes = train_scenes or [n for n in names
                                            if n not in val_set]
            val_scenes = val_scenes or sorted(val_set)
        wanted = {
            "train": set(train_scenes),
            "val": set(val_scenes),
            "train_val": set(train_scenes) | set(val_scenes),
            "test": set(val_scenes),
        }[self.split]
        self.annos = [r for r in records if r["scene"] in wanted]

        split_file = data_cfgs.get("SPLIT_FILE", None)
        if split_file and training:
            with open(split_file) as f:
                keep = {os.path.basename(ln.strip())
                        for ln in f if ln.strip()}
            self.annos = [r for r in self.annos
                          if os.path.basename(r["path"]) in keep]

        self.rng = np.random.default_rng(seed)
        self.annos_another = list(self.annos)
        self.rng.shuffle(self.annos_another)

        self._sample_idx = np.arange(len(self.annos))
        self.samples_per_epoch = data_cfgs.get("SAMPLES_PER_EPOCH", -1)
        if self.samples_per_epoch == -1 or not training:
            self.samples_per_epoch = len(self.annos)
        if training:
            self.resample()
        else:
            self.sample_idx = self._sample_idx

    @staticmethod
    def _scene_list(spec) -> Optional[List[str]]:
        if spec is None:
            return None
        if isinstance(spec, (list, tuple)):
            return list(spec)
        with open(spec) as f:
            return [ln.strip() for ln in f if ln.strip()]

    def __len__(self) -> int:
        return len(self.sample_idx)

    def resample(self) -> None:
        self.sample_idx = self.rng.choice(
            self._sample_idx, self.samples_per_epoch)

    # ------------------------------------------------------------- loaders --

    @staticmethod
    def _load_points(path: str) -> np.ndarray:
        """[N, 5] float32: x, y, z, intensity, ring."""
        return np.fromfile(path, dtype=np.float32).reshape(-1, 5)

    def _load_labels(self, rec: Dict, n: int) -> np.ndarray:
        if self.split == "test" or rec["label"] is None:
            return np.zeros(n, np.int32)
        raw = np.fromfile(rec["label"], dtype=np.uint8)
        return LEARNING_MAP_LUT[np.clip(raw, 0, 31)].astype(np.int32)

    # --------------------------------------------------------------- items --

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.get_with_rng(index, self.rng)

    def get_with_rng(self, index: int,
                     rng: np.random.Generator) -> Dict[str, np.ndarray]:
        rec = self.annos[self.sample_idx[index]]
        pts = self._load_points(rec["path"])
        labels = self._load_labels(rec, len(pts)).reshape(-1)
        raw = pts[:, :4]           # x, y, z, intensity for the mix ops
        ring = pts[:, 4:5]

        if self.augment_mode == "GlobalAugment_LP" and self.split == "train":
            rec2 = self.annos_another[self.sample_idx[index]
                                      % len(self.annos_another)]
            pts2 = self._load_points(rec2["path"])
            labels2 = self._load_labels(rec2, len(pts2)).reshape(-1)
            if rng.integers(0, 2) == 1:
                raw, labels = augment.lasermix(
                    raw, labels, pts2[:, :4], labels2, rng=rng,
                    fov_scale=(-30.0, 10.0))  # 32-beam FOV (nuscenes_meta)
            else:
                alpha = (rng.random() - 1) * np.pi
                beta = alpha + np.pi
                omega = [rng.random() * np.pi * 2 / 3,
                         (rng.random() + 1) * np.pi * 2 / 3]
                raw, labels = augment.polarmix(
                    raw, labels, pts2[:, :4], labels2, alpha=alpha,
                    beta=beta,
                    instance_classes=POLARMIX_INSTANCE_CLASSES, omega=omega,
                    rng=rng)
            # ring ids for mixed scans: reconstruct from pitch banding
            ring = self.ring_from_pitch(raw).reshape(-1, 1)

        xyzret = np.concatenate(
            [raw, ring[: len(raw)]], axis=1).astype(np.float32)
        return {"xyzret": xyzret, "labels": labels.astype(np.int32),
                "path": rec["path"]}

    @staticmethod
    def ring_from_pitch(points: np.ndarray) -> np.ndarray:
        """Approximate 32-beam ring id from elevation (mix ops lose the
        sensor ring column)."""
        from .nuscenes_meta import FOV_DOWN_DEG, FOV_UP_DEG, NUM_BEAMS
        d = np.linalg.norm(points[:, :3], axis=1) + 1e-9
        pitch = np.arcsin(np.clip(points[:, 2] / d, -1, 1))
        lo, hi = np.deg2rad(FOV_DOWN_DEG), np.deg2rad(FOV_UP_DEG)
        frac = np.clip((pitch - lo) / (hi - lo), 0.0, 1.0)
        return np.minimum((frac * NUM_BEAMS).astype(np.float32),
                          NUM_BEAMS - 1)


# ----------------------------------------------------------------- views --
# The modality views the reference *names* in its factory but never ships
# (pcseg/data/__init__.py:59-87). Same wrapper pattern as waymo.py.


class NuscVoxelDataset:
    """Voxel / cylinder modality view over nuScenes (feats = x,y,z,i)."""

    def __new__(cls, data_cfgs, training=True, root_path=None,
                point_cap=131072, seed=0):
        from .nuscenes_meta import CLASS_NAMES
        from .voxel_view import SemkittiVoxelDataset

        class _View(SemkittiVoxelDataset):
            FEAT_DIM = 4

            def _make_source(self, data_cfgs, training, root_path, seed):
                return NuscenesDataset(
                    data_cfgs, training=training, root_path=root_path,
                    seed=seed)

        v = _View(data_cfgs, training=training, root_path=root_path,
                  point_cap=point_cap, seed=seed)
        v.class_names = CLASS_NAMES
        return v


class NuscRangeViewDataset:
    """Range modality view (32 x W spherical images, FOV +10/-30)."""

    def __new__(cls, data_cfgs, training=True, root_path=None,
                point_cap=131072, seed=0):
        from .nuscenes_meta import FOV_DOWN_DEG, FOV_UP_DEG
        from .range_view import SemkittiRangeViewDataset

        cfg = dict(data_cfgs)
        cfg.setdefault("H", 32)
        cfg.setdefault("W", 1088)
        cfg.setdefault("FOV_UP", FOV_UP_DEG)
        cfg.setdefault("FOV_DOWN", FOV_DOWN_DEG)
        from ..config import CfgDict

        class _View(SemkittiRangeViewDataset):
            def _make_source(self, data_cfgs, training, root_path, seed):
                return NuscenesDataset(
                    data_cfgs, training=training, root_path=root_path,
                    seed=seed)

        return _View(CfgDict(cfg), training=training, root_path=root_path,
                     point_cap=point_cap, seed=seed)


class NuscFusionDataset:
    """Fusion modality view: voxel sample + 32-row range image (real ring
    ids from the sensor, column 4) + per-point pxpy."""

    def __new__(cls, data_cfgs, training=True, root_path=None,
                point_cap=131072, seed=0):
        from .fusion_view import SemkittiFusionDataset
        from .nuscenes_meta import CLASS_NAMES

        cfg = dict(data_cfgs)
        cfg.setdefault("RANGE_H", 32)
        cfg.setdefault("RANGE_W", 1088)
        from ..config import CfgDict

        class _View(SemkittiFusionDataset):
            FEAT_DIM = 4
            PACK_FEAT_DIM = 4

            def _make_source(self, data_cfgs, training, root_path, seed):
                return NuscenesDataset(
                    data_cfgs, training=training, root_path=root_path,
                    seed=seed)

        v = _View(CfgDict(cfg), training=training, root_path=root_path,
                  point_cap=point_cap, seed=seed)
        v.class_names = CLASS_NAMES
        return v
