"""SemanticKITTI dataset metadata (public, from the official
semantic-kitti.yaml / semantic-kitti-api; also used by the reference at
pcseg/data/dataset/semantickitti/semantickitti_utils.py).

Raw label ids (lower 16 bits of the .label files) -> 20 train ids (0 =
unlabeled/ignored). LEARNING_MAP_LUT is the table-lookup form (the reference
uses np.vectorize over the dict, a known host hot spot, SURVEY.md §3.6).

A copy of ``openpcseg_tpu/data/semantickitti_meta.py`` (the port imports
nothing of the JAX package), held to it by tests/test_torch_data.py.
"""
from __future__ import annotations

import numpy as np

CLASS_NAMES = [
    "unlabeled",
    "car", "bicycle", "motorcycle", "truck", "other-vehicle", "person",
    "bicyclist", "motorcyclist",
    "road", "parking", "sidewalk", "other-ground", "building", "fence",
    "vegetation", "trunk", "terrain", "pole", "traffic-sign",
]

NUM_CLASS = 20
IGNORE_LABEL = 0

# Per-learned-class point-count fractions: the published `content` table
# from the official semantic-kitti.yaml, grouped through LEARNING_MAP
# (same sums the reference embeds at range/utils.py:344-367, minus its
# +1e-3 smoothing eps). Scaled to nominal counts for WCELoss's
# 1/sqrt(freq) weighting (reference pcseg/loss/wce_loss.py:14-23).
CLASS_CONTENT = [
    0.0,                        # unlabeled (ignored)
    0.040818519255974316 + 0.001789309418528068,                # car
    0.00016609538710764618,                                     # bicycle
    0.00039838616015114444,                                     # motorcycle
    0.0020633612104619787 + 0.00010157861367183268,             # truck
    2.7879693665067774e-05 + 0.0016218197275284021
    + 0.00011351574470342043 + 4.3840131989471124e-05,          # other-veh
    0.00017698551338515307 + 0.00016059776092534436,            # person
    1.1065903904919655e-08 + 0.00012709999297008662,            # bicyclist
    5.532951952459828e-09 + 3.745553104802113e-05,              # motorcyclist
    0.1987493871255525 + 4.7084144280367186e-05,                # road
    0.014717169549888214,                                       # parking
    0.14392298360372,                                           # sidewalk
    0.0039048553037472045,                                      # other-ground
    0.1326861944777486,                                         # building
    0.0723592229456223,                                         # fence
    0.26681502148037506,                                        # vegetation
    0.006035012012626033,                                       # trunk
    0.07814222006271769,                                        # terrain
    0.002855498193863172,                                       # pole
    0.0006155958086189918,                                      # traffic-sign
]
# nominal dataset-scale counts (~4.5e9 labeled points in train split)
CLS_NUM_PTS = [max(1, int(f * 4.5e9)) for f in CLASS_CONTENT]

LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}

LEARNING_MAP_INV = {
    0: 0, 1: 10, 2: 11, 3: 15, 4: 18, 5: 20, 6: 30, 7: 31, 8: 32, 9: 40,
    10: 44, 11: 48, 12: 49, 13: 50, 14: 51, 15: 70, 16: 71, 17: 72,
    18: 80, 19: 81,
}

# O(1) table lookup instead of np.vectorize over a dict
LEARNING_MAP_LUT = np.zeros(max(LEARNING_MAP) + 1, dtype=np.int32)
for _k, _v in LEARNING_MAP.items():
    LEARNING_MAP_LUT[_k] = _v

LEARNING_MAP_INV_LUT = np.zeros(max(LEARNING_MAP_INV) + 1, dtype=np.int32)
for _k, _v in LEARNING_MAP_INV.items():
    LEARNING_MAP_INV_LUT[_k] = _v

# train/val/test sequence splits (reference semantickitti.py:50-59)
SPLIT_SEQUENCES = {
    "train": ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10"],
    "val": ["08"],
    "test": ["11", "12", "13", "14", "15", "16", "17", "18", "19", "20", "21"],
}

# color map (bgr), from semantic-kitti.yaml, for the visualizer
COLOR_MAP = {
    0: (0, 0, 0), 1: (245, 150, 100), 2: (245, 230, 100), 3: (150, 60, 30),
    4: (180, 30, 80), 5: (255, 0, 0), 6: (30, 30, 255), 7: (200, 40, 255),
    8: (90, 30, 150), 9: (255, 0, 255), 10: (255, 150, 255),
    11: (75, 0, 75), 12: (75, 0, 175), 13: (0, 200, 255), 14: (50, 120, 255),
    15: (0, 175, 0), 16: (0, 60, 135), 17: (80, 240, 150),
    18: (150, 240, 255), 19: (0, 0, 255),
}


def remap_labels(raw_labels: np.ndarray) -> np.ndarray:
    """Lower 16 bits -> train ids (reference semantickitti.py:114-115)."""
    sem = (raw_labels & 0xFFFF).astype(np.int64)
    sem = np.clip(sem, 0, len(LEARNING_MAP_LUT) - 1)
    return LEARNING_MAP_LUT[sem]
