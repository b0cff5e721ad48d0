"""Data layer: scan readers, augmentation, the voxel view and its loader.

Counterpart of ``openpcseg_tpu/data/__init__.py``: ``build_dataloader``
maps (modality, dataset) to a view and wraps it in a ``BatchLoader``. The
port has the voxel, fusion, cylinder and range views of SemanticKITTI and
ScribbleKITTI (the cylinder view is the voxel view: Cylinder3D partitions
the points on the device, ``core.batch.cylinder_points_batch``);
every other view of the JAX package raises ``NotImplementedError`` naming
the ROADMAP item that ports it. ``raycast`` and ``raycast_kitti`` make surrogate scans
and trees without a dataset.
"""
from __future__ import annotations

from .fusion_view import SemkittiFusionDataset
from .range_view import SemkittiRangeViewDataset
from .voxel_view import BatchLoader, SemkittiVoxelDataset, collate  # noqa: F401

_VIEWS = {
    ("voxel", "semantickitti"): SemkittiVoxelDataset,
    ("voxel", "scribblekitti"): SemkittiVoxelDataset,
    ("fusion", "semantickitti"): SemkittiFusionDataset,
    ("fusion", "scribblekitti"): SemkittiFusionDataset,
    ("cylinder", "semantickitti"): SemkittiVoxelDataset,
    ("cylinder", "scribblekitti"): SemkittiVoxelDataset,
    ("range", "semantickitti"): SemkittiRangeViewDataset,
    ("range", "scribblekitti"): SemkittiRangeViewDataset,
}
# the JAX package's other views, and the ROADMAP.md Queue 1 item that
# ports each
_NOT_PORTED = {
    ("voxel", "waymo"): 15, ("cylinder", "waymo"): 15,
    ("fusion", "waymo"): 15, ("voxel", "nuscenes"): 15,
    ("cylinder", "nuscenes"): 15, ("range", "nuscenes"): 15,
    ("fusion", "nuscenes"): 15,
}


def num_classes_for(dataset: str) -> int:
    return {"nuscenes": 17, "semantickitti": 20, "scribblekitti": 20,
            "waymo": 23}[dataset]


def dataset_meta(dataset: str):
    """(class_names, cls_num_pts) of a dataset, (None, None) where the
    port has no table for it."""
    from .semantickitti_meta import CLASS_NAMES, CLS_NUM_PTS

    return {"semantickitti": (CLASS_NAMES, CLS_NUM_PTS),
            "scribblekitti": (CLASS_NAMES, CLS_NUM_PTS)}.get(
                dataset, (None, None))


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
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"the {modality} view of {data_cfgs.DATASET!r} is not ported yet "
            f"(ROADMAP.md Queue 1 item {_NOT_PORTED[key]})")
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
