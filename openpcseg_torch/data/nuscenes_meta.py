"""nuScenes-lidarseg label maps and class tables.

The reference wires nuScenes into its dataloader factory but never ships
the dataset classes (reference pcseg/data/__init__.py:59-87 names
NuscVoxelDataset / NuscRangeViewDataset / NuscCylinderDataset /
NuscFusionDataset; none exist — SURVEY.md §2.9). This module + nuscenes.py
implement the family fully, self-contained (no nuscenes-devkit): raw
lidarseg categories (0-31) mapped to the standard 16-class benchmark set
(+0 ignore), matching the official lidarseg challenge mapping.

A copy of ``openpcseg_tpu/data/nuscenes_meta.py`` (the port imports
nothing of the JAX package), held to it by tests/test_torch_nuscenes.py.
"""
from __future__ import annotations

import numpy as np

# raw lidarseg category index -> name (v1.0, 32 categories)
RAW_CATEGORIES = [
    "noise",                                  # 0
    "animal",                                 # 1
    "human.pedestrian.adult",                 # 2
    "human.pedestrian.child",                 # 3
    "human.pedestrian.construction_worker",   # 4
    "human.pedestrian.personal_mobility",     # 5
    "human.pedestrian.police_officer",        # 6
    "human.pedestrian.stroller",              # 7
    "human.pedestrian.wheelchair",            # 8
    "movable_object.barrier",                 # 9
    "movable_object.debris",                  # 10
    "movable_object.pushable_pullable",       # 11
    "movable_object.trafficcone",             # 12
    "static_object.bicycle_rack",             # 13
    "vehicle.bicycle",                        # 14
    "vehicle.bus.bendy",                      # 15
    "vehicle.bus.rigid",                      # 16
    "vehicle.car",                            # 17
    "vehicle.construction",                   # 18
    "vehicle.emergency.ambulance",            # 19
    "vehicle.emergency.police",               # 20
    "vehicle.motorcycle",                     # 21
    "vehicle.trailer",                        # 22
    "vehicle.truck",                          # 23
    "flat.driveable_surface",                 # 24
    "flat.other",                             # 25
    "flat.sidewalk",                          # 26
    "flat.terrain",                           # 27
    "static.manmade",                         # 28
    "static.other",                           # 29
    "static.vegetation",                      # 30
    "vehicle.ego",                            # 31
]

# official 16-class benchmark mapping (lidarseg challenge)
LEARNING_MAP = {
    0: 0, 1: 0, 5: 0, 7: 0, 8: 0, 10: 0, 11: 0, 13: 0, 19: 0, 20: 0,
    29: 0, 31: 0,
    9: 1,                    # barrier
    14: 2,                   # bicycle
    15: 3, 16: 3,            # bus
    17: 4,                   # car
    18: 5,                   # construction_vehicle
    21: 6,                   # motorcycle
    2: 7, 3: 7, 4: 7, 6: 7,  # pedestrian
    12: 8,                   # traffic_cone
    22: 9,                   # trailer
    23: 10,                  # truck
    24: 11,                  # driveable_surface
    25: 12,                  # other_flat
    26: 13,                  # sidewalk
    27: 14,                  # terrain
    28: 15,                  # manmade
    30: 16,                  # vegetation
}

LEARNING_MAP_LUT = np.zeros(32, np.int32)
for _raw, _cls in LEARNING_MAP.items():
    LEARNING_MAP_LUT[_raw] = _cls

# inverse map for raw-id prediction dumps (first raw id per class)
LEARNING_MAP_INV = np.zeros(17, np.int32)
for _raw in range(31, -1, -1):
    LEARNING_MAP_INV[LEARNING_MAP_LUT[_raw]] = _raw

CLASS_NAMES = [
    "ignore", "barrier", "bicycle", "bus", "car", "construction_vehicle",
    "motorcycle", "pedestrian", "traffic_cone", "trailer", "truck",
    "driveable_surface", "other_flat", "sidewalk", "terrain", "manmade",
    "vegetation",
]

# 32-beam sensor geometry (range/fusion projections)
FOV_UP_DEG = 10.0
FOV_DOWN_DEG = -30.0
NUM_BEAMS = 32

COLOR_MAP = {  # class -> BGR, for the visualizer
    0: (0, 0, 0), 1: (47, 79, 79), 2: (220, 20, 60), 3: (255, 127, 80),
    4: (255, 158, 0), 5: (233, 150, 70), 6: (255, 61, 99),
    7: (0, 0, 230), 8: (47, 79, 79), 9: (255, 140, 0), 10: (255, 99, 71),
    11: (0, 207, 191), 12: (175, 0, 75), 13: (75, 0, 75),
    14: (112, 180, 60), 15: (222, 184, 135), 16: (0, 175, 0),
}
