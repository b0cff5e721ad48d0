"""Data layer: scan readers, augmentation, the voxel view and its loader.

Counterpart of ``openpcseg_tpu/data/__init__.py``: ``build_dataloader``
maps (modality, dataset) to a view and wraps it in a ``BatchLoader``. The
port has every view of the JAX package: the voxel, fusion, cylinder and
range views of SemanticKITTI and ScribbleKITTI, the voxel, cylinder and
fusion views of Waymo (``waymo.py``) and the voxel, cylinder, range and
fusion views of nuScenes (``nuscenes.py``). A cylinder view is the voxel
view: Cylinder3D partitions the points on the device
(``core.batch.cylinder_points_batch``). ``raycast`` and
``raycast_kitti`` / ``raycast_waymo`` / ``raycast_nuscenes`` make surrogate
scans and trees in each dataset's layout without a dataset.
"""
from __future__ import annotations

from .fusion_view import SemkittiFusionDataset
from .nuscenes import (NuscenesDataset, NuscFusionDataset,  # noqa: F401
                       NuscRangeViewDataset, NuscVoxelDataset)
from .range_view import SemkittiRangeViewDataset
from .voxel_view import BatchLoader, SemkittiVoxelDataset, collate  # noqa: F401
from .waymo import (WAYMO_CLASS_NAMES, WaymoDataset,  # noqa: F401
                    WaymoFusionDataset, WaymoInferDataset, WaymoVoxelDataset)

_VIEWS = {
    ("voxel", "semantickitti"): SemkittiVoxelDataset,
    ("voxel", "scribblekitti"): SemkittiVoxelDataset,
    ("fusion", "semantickitti"): SemkittiFusionDataset,
    ("fusion", "scribblekitti"): SemkittiFusionDataset,
    ("cylinder", "semantickitti"): SemkittiVoxelDataset,
    ("cylinder", "scribblekitti"): SemkittiVoxelDataset,
    ("range", "semantickitti"): SemkittiRangeViewDataset,
    ("range", "scribblekitti"): SemkittiRangeViewDataset,
    ("voxel", "waymo"): WaymoVoxelDataset,
    ("cylinder", "waymo"): WaymoVoxelDataset,
    ("fusion", "waymo"): WaymoFusionDataset,
    ("voxel", "nuscenes"): NuscVoxelDataset,
    ("cylinder", "nuscenes"): NuscVoxelDataset,
    ("range", "nuscenes"): NuscRangeViewDataset,
    ("fusion", "nuscenes"): NuscFusionDataset,
}


def num_classes_for(dataset: str) -> int:
    return {"nuscenes": 17, "semantickitti": 20, "scribblekitti": 20,
            "waymo": 23}[dataset]


def dataset_meta(dataset: str):
    """(class_names, cls_num_pts) of a dataset; cls_num_pts is None where
    no published table exists, both None for an unknown dataset."""
    from .nuscenes_meta import CLASS_NAMES as NUSC_CLASS_NAMES
    from .semantickitti_meta import CLASS_NAMES, CLS_NUM_PTS

    return {"semantickitti": (CLASS_NAMES, CLS_NUM_PTS),
            "scribblekitti": (CLASS_NAMES, CLS_NUM_PTS),
            "waymo": (WAYMO_CLASS_NAMES, None),
            "nuscenes": (NUSC_CLASS_NAMES, None)}.get(dataset, (None, None))


def rank_and_world() -> tuple:
    """This process's rank and the world size from torch.distributed when
    it is initialised, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def build_dataloader(data_cfgs, modality: str, batch_size: int, *,
                     training: bool = True, root_path: str | None = None,
                     point_cap: int = 131072, num_workers: int = 4,
                     seed: int = 0):
    """Returns (dataset, loader). `batch_size` is the global batch; each
    process loads its slice of it. Eval tails are padded to the full batch
    with all-invalid samples named ``<pad>``."""
    key = (modality, data_cfgs.DATASET)
    if key not in _VIEWS:
        raise NotImplementedError(
            f"no dataset view for modality={modality!r}, "
            f"dataset={data_cfgs.DATASET!r}; available: {sorted(_VIEWS)}")
    dataset = _VIEWS[key](data_cfgs, training=training, root_path=root_path,
                          point_cap=point_cap, seed=seed)
    rank, world = rank_and_world()
    loader = BatchLoader(dataset, batch_size, shuffle=training,
                         num_workers=num_workers, seed=seed,
                         drop_last=training, pad_last=not training,
                         process_index=rank, process_count=world)
    return dataset, loader
