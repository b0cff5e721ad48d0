"""Waymo Open dataset reader (preprocessed .npy layout) + views.

Re-implementation of the reference Waymo readers
(reference: pcseg/data/dataset/waymo/waymo.py:7-109, waymo_voxel.py:17-170,
waymo_infer.py:8-74): per-frame .npy arrays of
[range, intensity, elongation, x, y, z, label] rows for the first return,
with a sibling 'second/' directory for the second lidar return; returns are
concatenated and intensity/elongation tanh-normalized (waymo.py:87-96).
Split file lists (train-0-31.txt / val-0-7.txt) name the frame files.

23 classes, labels already in train-id space (0 = UNDEFINED, ignored).

A copy of ``openpcseg_tpu/data/waymo.py`` (the port imports nothing of
the JAX package), held to it by tests/test_torch_waymo.py. Its views
subclass the port's voxel and fusion views through their hooks
(``FEAT_DIM``, ``_make_source``, ``RANGE_W``, ``_range_row``).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

WAYMO_CLASS_NAMES = [
    "UNDEFINED", "CAR", "TRUCK", "BUS", "OTHER_VEHICLE", "MOTORCYCLIST",
    "BICYCLIST", "PEDESTRIAN", "SIGN", "TRAFFIC_LIGHT", "POLE",
    "CONSTRUCTION_CONE", "BICYCLE", "MOTORCYCLE", "BUILDING", "VEGETATION",
    "TREE_TRUNK", "CURB", "ROAD", "LANE_MARKER", "OTHER_GROUND", "WALKABLE",
    "SIDEWALK",
]
WAYMO_NUM_CLASS = 23


class WaymoDataset:
    """Raw frame source yielding {'xyzret', 'labels', 'path'} like the
    SemanticKITTI reader (5-dim xyzret: x, y, z, tanh(int), tanh(elong))."""

    def __init__(
        self,
        data_cfgs,
        training: bool = True,
        root_path: Optional[str] = None,
        seed: int = 0,
    ):
        self.data_cfgs = data_cfgs
        self.training = training
        self.split = "train" if training else "val"
        if data_cfgs.get("TTA", False):
            self.split = "test"

        root = Path(root_path or data_cfgs.DATA_PATH)
        split_file = data_cfgs.get(
            "SPLIT_FILE_TRAIN" if self.split == "train" else "SPLIT_FILE_VAL",
            str(root / ("train-0-31.txt" if self.split == "train"
                        else "val-0-7.txt")),
        )
        self.annos: List[str] = []
        if Path(split_file).is_file():
            with open(split_file) as f:
                self.annos = [ln.strip() for ln in f if ln.strip()]

        self.rng = np.random.default_rng(seed)
        self._sample_idx = np.arange(len(self.annos))
        self.samples_per_epoch = data_cfgs.get("SAMPLES_PER_EPOCH", -1)
        if self.samples_per_epoch == -1 or not training:
            self.samples_per_epoch = len(self.annos)
        if training:
            self.resample()
        else:
            self.sample_idx = self._sample_idx

    def __len__(self) -> int:
        return len(self.sample_idx)

    def resample(self) -> None:
        self.sample_idx = self.rng.choice(self._sample_idx,
                                          self.samples_per_epoch)

    @staticmethod
    def _load_return(path: str):
        arr = np.load(path)
        xyz = arr[:, 3:6].reshape(-1, 3).astype(np.float32)
        intenel = arr[:, 1:3].reshape(-1, 2).astype(np.float32)
        label = arr[:, -1].reshape(-1).astype(np.int32)
        return xyz, intenel, label

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        path = self.annos[self.sample_idx[index]]
        xyz1, ie1, lab1 = self._load_return(path)
        sec = path.replace("first/", "second/")
        if Path(sec).is_file():
            xyz2, ie2, lab2 = self._load_return(sec)
            xyz = np.concatenate([xyz1, xyz2], 0)
            ie = np.concatenate([ie1, ie2], 0)
            labels = np.concatenate([lab1, lab2], 0)
        else:
            xyz, ie, labels = xyz1, ie1, lab1
        ie = np.tanh(ie)  # (reference waymo.py:96)
        if self.split == "test":
            labels = np.zeros(len(xyz), np.int32)
        xyzret = np.concatenate([xyz, ie], axis=1).astype(np.float32)
        return {"xyzret": xyzret, "labels": labels, "path": path}


class WaymoInferDataset(WaymoDataset):
    """Unlabeled sequence streaming for inference dumps
    (reference: waymo_infer.py:8-74): frames listed by globbing an unpacked
    sequence directory instead of a split file."""

    def __init__(self, data_cfgs, training: bool = False,
                 root_path: Optional[str] = None, seed: int = 0):
        self.data_cfgs = data_cfgs
        self.training = False
        self.split = "test"
        root = Path(root_path or data_cfgs.DATA_PATH)
        first = root / "first"
        self.annos = (
            sorted(str(p) for p in first.glob("*.npy")) if first.is_dir()
            else sorted(str(p) for p in root.glob("*.npy"))
        )
        self.rng = np.random.default_rng(seed)
        self._sample_idx = np.arange(len(self.annos))
        self.samples_per_epoch = len(self.annos)
        self.sample_idx = self._sample_idx

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        out = super().__getitem__(index)
        out["labels"] = np.zeros(len(out["xyzret"]), np.int32)
        return out


class WaymoVoxelDataset:
    """Padded voxel view over Waymo frames (reference waymo_voxel.py:17-170,
    5-dim features [x, y, z, tanh(int), tanh(elong)])."""

    def __new__(cls, data_cfgs, training=True, root_path=None,
                point_cap=196608, seed=0):
        from .voxel_view import SemkittiVoxelDataset

        class _View(SemkittiVoxelDataset):
            FEAT_DIM = 5

            def _make_source(self, data_cfgs, training, root_path, seed):
                if data_cfgs.get("USE_INFER_DATA", False):
                    return WaymoInferDataset(
                        data_cfgs, training=training, root_path=root_path,
                        seed=seed)
                return WaymoDataset(
                    data_cfgs, training=training, root_path=root_path,
                    seed=seed)

        view = _View(data_cfgs, training=training, root_path=root_path,
                     point_cap=point_cap, seed=seed)
        view.class_names = WAYMO_CLASS_NAMES
        return view


class WaymoFusionDataset:
    """Fusion view over Waymo frames: voxel pipeline + 64-row range image.

    The reference's WaymoFusionDataset (waymo_fusion.py:56-133) never
    actually constructs a range image — its __getitem__ is byte-identical
    to the voxel view, so RPVNet-on-Waymo cannot run upstream. Here the
    fusion view builds a real [64, W, 5] image with inclination-binned
    rows (Waymo returns carry no ring id; the top lidar spans roughly
    [-17.6, +2.4] degrees), so the tri-branch models work on Waymo.
    """

    RANGE_FOV_UP = 2.4      # degrees
    RANGE_FOV_DOWN = -17.6

    def __new__(cls, data_cfgs, training=True, root_path=None,
                point_cap=196608, seed=0):
        from .fusion_view import SemkittiFusionDataset, \
            build_fusion_range_image

        fov_up = np.deg2rad(data_cfgs.get("RANGE_FOV_UP", cls.RANGE_FOV_UP))
        fov_dn = np.deg2rad(
            data_cfgs.get("RANGE_FOV_DOWN", cls.RANGE_FOV_DOWN))

        class _View(SemkittiFusionDataset):
            FEAT_DIM = 5
            RANGE_W = 2656  # ~Waymo azimuth resolution, rounded up to a
                            # multiple of 32 for the range branch strides

            def _make_source(self, data_cfgs, training, root_path, seed):
                if data_cfgs.get("USE_INFER_DATA", False):
                    return WaymoInferDataset(
                        data_cfgs, training=training, root_path=root_path,
                        seed=seed)
                return WaymoDataset(
                    data_cfgs, training=training, root_path=root_path,
                    seed=seed)

            def _range_row(self, point):
                depth = np.maximum(
                    np.linalg.norm(point[:, :3], 2, axis=1), 1e-6)
                pitch = np.arcsin(np.clip(point[:, 2] / depth, -1, 1))
                frac = 1.0 - (pitch - fov_dn) / (fov_up - fov_dn)
                return np.floor(frac * self.RANGE_H).astype(np.int32)

        view = _View(data_cfgs, training=training, root_path=root_path,
                     point_cap=point_cap, seed=seed)
        view.class_names = WAYMO_CLASS_NAMES
        return view
