"""SemanticKITTI / ScribbleKITTI raw scan reader (host).

Re-implementation of the reference reader
(reference: pcseg/data/dataset/semantickitti/semantickitti.py:19-182):
.bin (x,y,z,intensity) + .label files, lower-16-bit label remap via LUT
(table lookup instead of the reference's np.vectorize-over-dict, a measured
host hot spot, SURVEY.md §3.6), train/val/test sequence splits, per-epoch
resample(), ringID reconstruction from azimuth wrap-around, and the
train-time scan-mix dispatch: p=0.5 LaserMix else PolarMix with a second
random scan (reference :117-167).

A copy of ``openpcseg_tpu/data/semantickitti.py`` (the port imports
nothing of the JAX package), held to it by tests/test_torch_data.py and
tests/test_torch_native.py. It reads scans and labels through the port's
native readers (``openpcseg_torch/native.py``), as the JAX package does
wherever g++ builds its own: at most 200,000 rows a file, and a label id
of 260 or more (past the lookup table) becomes 0. Where they cannot be
built it raises; it does not read with numpy instead.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from .. import native
from . import augment
from .semantickitti_meta import LEARNING_MAP_LUT, SPLIT_SEQUENCES

# PolarMix constants (reference semantickitti.py:10-11)
POLARMIX_INSTANCE_CLASSES = [1, 2, 3, 4, 5, 6, 7, 8]


class SemantickittiDataset:
    """Raw scan source yielding dicts {'xyzret', 'labels', 'path'}."""

    def __init__(
        self,
        data_cfgs,
        training: bool = True,
        root_path: Optional[str] = None,
        if_scribble: bool = False,
        seed: int = 0,
    ):
        self.data_cfgs = data_cfgs
        self.training = training
        self.root_path = Path(root_path or data_cfgs.DATA_PATH)
        self.if_scribble = if_scribble
        self.augment_mode = data_cfgs.get("AUGMENT", "GlobalAugment_LP")
        self.tta = data_cfgs.get("TTA", False)
        train_val = data_cfgs.get("TRAINVAL", False)

        if training:
            self.split = "train_val" if train_val else "train"
        else:
            self.split = "val"
        if self.tta:
            self.split = "test"

        if self.split == "train_val":
            seqs = SPLIT_SEQUENCES["train"] + SPLIT_SEQUENCES["val"]
        else:
            seqs = SPLIT_SEQUENCES[self.split]
        self.seqs = seqs

        self.annos: List[str] = []
        for seq in seqs:
            d = self.root_path / seq / "velodyne"
            if d.is_dir():
                self.annos += [str(d / f) for f in sorted(os.listdir(d))
                               if f.endswith(".bin")]
        self.annos.sort()

        # semi-supervised split lists (reference pcseg/data/split/
        # {semantickitti,scribblekitti}/ 1/10/20/50% lists): when
        # DATA.SPLIT_FILE names a text file of scan paths (absolute or
        # relative to DATA_PATH), training restricts to those scans.
        split_file = data_cfgs.get("SPLIT_FILE", None)
        if split_file and training:
            def suffix(p: str) -> str:  # "<seq>/velodyne/<frame>.bin"
                return "/".join(p.replace("\\", "/").split("/")[-3:])
            with open(split_file) as f:
                wanted = {suffix(ln.strip()) for ln in f if ln.strip()}
            self.annos = [a for a in self.annos if suffix(a) in wanted]

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

    def __len__(self) -> int:
        return len(self.sample_idx)

    def resample(self) -> None:
        """Per-epoch resample with replacement (reference :83-84)."""
        self.sample_idx = self.rng.choice(self._sample_idx, self.samples_per_epoch)

    # ------------------------------------------------------------- loaders --

    def _load_points(self, path: str) -> np.ndarray:
        return native.load_kitti_scan(path)

    def _load_labels(self, bin_path: str, n: int) -> np.ndarray:
        if self.split == "test":
            return np.zeros(n, np.int32)
        if self.if_scribble:  # ScribbleKITTI: weak labels via path swap
            label_path = bin_path.replace("SemanticKITTI", "ScribbleKITTI")
            label_path = label_path.replace("velodyne", "scribbles")[:-3] + "label"
        else:
            label_path = bin_path.replace("velodyne", "labels")[:-3] + "label"
        return native.load_kitti_labels(label_path, LEARNING_MAP_LUT)

    @staticmethod
    def get_points_ring_id(points: np.ndarray) -> np.ndarray:
        """Reconstruct the laser ring id from azimuth wrap-around
        (reference semantickitti.py:86-96)."""
        yaw = -np.arctan2(points[:, 1], -points[:, 0])
        proj_x = 0.5 * (yaw / np.pi + 1.0)
        new_row = np.nonzero((proj_x[1:] < 0.2) & (proj_x[:-1] > 0.8))[0] + 1
        ring = np.zeros_like(proj_x)
        ring[new_row] = 1
        return np.clip(np.cumsum(ring), 0, 63)

    # --------------------------------------------------------------- items --

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.get_with_rng(index, self.rng)

    def get_with_rng(self, index: int,
                     rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """Fetch with an explicit generator (BatchLoader passes a
        worker-local one; np Generators are not thread-safe)."""
        path = self.annos[self.sample_idx[index]]
        raw = self._load_points(path)
        labels = self._load_labels(path, len(raw)).reshape(-1)

        if self.augment_mode == "GlobalAugment_LP" and self.split == "train":
            other_path = self.annos_another[self.sample_idx[index]]
            raw2 = self._load_points(other_path)
            labels2 = self._load_labels(other_path, len(raw2)).reshape(-1)
            if rng.integers(0, 2) == 1:
                raw, labels = augment.lasermix(raw, labels, raw2, labels2,
                                               rng=rng)
            else:
                alpha = (rng.random() - 1) * np.pi
                beta = alpha + np.pi
                omega = [rng.random() * np.pi * 2 / 3,
                         (rng.random() + 1) * np.pi * 2 / 3]
                raw, labels = augment.polarmix(
                    raw, labels, raw2, labels2, alpha=alpha, beta=beta,
                    instance_classes=POLARMIX_INSTANCE_CLASSES, omega=omega,
                    rng=rng,
                )

        ring = self.get_points_ring_id(raw).reshape(-1, 1)
        xyzret = np.concatenate([raw, ring], axis=1).astype(np.float32)
        return {"xyzret": xyzret, "labels": labels.astype(np.int32),
                "path": path}
