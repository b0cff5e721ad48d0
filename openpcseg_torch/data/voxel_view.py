"""Voxel-modality dataset view + batching (host side, numpy).

Counterpart of the reference's SemkittiVoxelDataset
(reference: pcseg/data/dataset/semantickitti/semantickitti_voxel.py:17-164)
with one structural difference: the host does NOT quantize/dedup. It loads,
augments (aug_points :83-110) and pads each scan to a fixed capacity; the
round(xyz/voxel)/min-shift/unique pipeline runs inside jit on device
(core/batch.py), keeping CPU workers off the critical path (the reference's
host sparse_quantize is a measured bottleneck, SURVEY.md §3.6).

TTA (10 deterministic votes, reference :62-69) is exposed via
``get_tta_sample``.

A copy of ``openpcseg_tpu/data/voxel_view.py`` (the port imports
nothing of the JAX package), held to it by tests/test_torch_data.py.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from .augment import aug_points
from .semantickitti import SemantickittiDataset
from .semantickitti_meta import CLASS_NAMES


class SemkittiVoxelDataset:
    """Yields padded per-scan dicts: xyz [cap,3], feats [cap,F], labels, valid."""

    FEAT_DIM = 4  # x, y, z, intensity (Waymo subclass uses 5)

    def _make_source(self, data_cfgs, training, root_path, seed):
        return SemantickittiDataset(
            data_cfgs, training=training, root_path=root_path,
            if_scribble=(data_cfgs.DATASET == "scribblekitti"), seed=seed,
        )

    def __init__(
        self,
        data_cfgs,
        training: bool = True,
        root_path: Optional[str] = None,
        point_cap: int = 131072,
        seed: int = 0,
    ):
        self.data_cfgs = data_cfgs
        self.training = training
        self.point_cap = point_cap
        self.class_names = CLASS_NAMES
        self.source = self._make_source(data_cfgs, training, root_path, seed)
        self.if_flip = data_cfgs.get("FLIP_AUG", True)
        self.if_scale = data_cfgs.get("SCALE_AUG", True)
        self.scale_axis = data_cfgs.get("SCALE_AUG_AXIS", "xyz")
        self.scale_range = data_cfgs.get("SCALE_AUG_RANGE", [0.9, 1.1])
        self.if_jitter = data_cfgs.get("TRANSFORM_AUG", True)
        self.if_rotate = data_cfgs.get("ROTATE_AUG", True)
        self.if_tta = data_cfgs.get("TTA", False)
        self.rng = np.random.default_rng(seed + 1)

    def __len__(self) -> int:
        return len(self.source)

    def resample(self) -> None:
        self.source.resample()

    def _pack(self, xyz, feats, labels, path,
              rng: Optional[np.random.Generator] = None
              ) -> Dict[str, np.ndarray]:
        rng = rng if rng is not None else self.rng
        cap = self.point_cap
        n = min(len(xyz), cap)
        out = {
            "xyz": np.zeros((cap, 3), np.float32),
            "feats": np.zeros((cap, feats.shape[1]), np.float32),
            "labels": np.full((cap,), -1, np.int32),
            "valid": np.zeros((cap,), bool),
        }
        if len(xyz) > cap:  # keep a random subset, never bias by file order
            sel = rng.choice(len(xyz), cap, replace=False)
            xyz, feats, labels = xyz[sel], feats[sel], labels[sel]
        out["xyz"][:n] = xyz[:n]
        out["feats"][:n] = feats[:n]
        out["labels"][:n] = labels[:n]
        out["valid"][:n] = True
        out["name"] = path
        return out

    def get_sample(self, index: int, num_vote: int = 0,
                   tta: bool = False,
                   rng: Optional[np.random.Generator] = None
                   ) -> Dict[str, np.ndarray]:
        rng = rng if rng is not None else self.rng
        src = getattr(self.source, "get_with_rng", None)
        pc = src(index, rng) if src is not None else self.source[index]
        point = pc["xyzret"][:, :self.FEAT_DIM].astype(np.float32)
        labels = pc["labels"].reshape(-1)

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
        # feats = augmented xyz + intensity (reference feat_ = point,
        # semantickitti_voxel.py:114)
        feats = point
        return self._pack(point[:, :3], feats, labels, pc["path"], rng)

    def __getitem__(self, index: int):
        return self.get_sample(index)

    def get_with_rng(self, index: int, rng: np.random.Generator):
        return self.get_sample(index, rng=rng)

    def get_tta_sample(self, index: int, voting: int = 10):
        """10-vote TTA variants of one scan (reference :62-69)."""
        return [self.get_sample(index, num_vote=v, tta=True)
                for v in range(voting)]


def collate(samples) -> Dict[str, np.ndarray]:
    """Stack fixed-shape sample dicts into a batch dict (+ scan names).

    Works for any view: stacks every ndarray key (voxel views: xyz/feats/
    labels/valid; range views: scan/label/mask)."""
    batch: Dict[str, np.ndarray] = {}
    for k, v in samples[0].items():
        if isinstance(v, np.ndarray):
            batch[k] = np.stack([s[k] for s in samples])
    if "name" in samples[0]:
        batch["name"] = [s["name"] for s in samples]
    return batch


class BatchLoader:
    """Minimal epoch iterator with background prefetch threads.

    Replaces torch's DataLoader worker pool (reference
    pcseg/data/__init__.py:96-139) with a thread pool — the heavy transform
    (quantize/dedup) runs on device, so host work is IO + augs only.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool,
                 num_workers: int = 4, seed: int = 0, drop_last: bool = True,
                 pad_last: bool = False,
                 process_index: int = 0, process_count: int = 1):
        """batch_size is the GLOBAL batch; with process_count > 1 each
        process yields its `batch_size // process_count` slice of every
        global batch (replaces torch's DistributedSampler, reference
        pcseg/data/__init__.py:106-113). All processes must construct the
        loader with the same seed so the shuffled order agrees.

        pad_last pads the final partial batch with all-invalid zero samples
        (valid=False, labels=-1) so every batch has the full static batch
        dim — required for sharded eval and to avoid per-shape retraces
        (reference pads its eval sampler to world size, data/__init__.py:
        23-43).
        """
        assert batch_size % process_count == 0, (batch_size, process_count)
        self.dataset = dataset
        self.batch_size = batch_size
        self.local_bs = batch_size // process_count
        self.process_index = process_index
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        self.pad_last = pad_last
        self._zero_sample = None

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _zeros_like_sample(self, sample: Dict[str, np.ndarray]):
        if self._zero_sample is None:
            z: Dict[str, np.ndarray] = {}
            for k, v in sample.items():
                if not isinstance(v, np.ndarray):
                    continue
                if k == "labels" or k == "label":
                    z[k] = np.full_like(v, -1)
                else:
                    z[k] = np.zeros_like(v)
            if "name" in sample:
                z["name"] = "<pad>"
            self._zero_sample = z
        return self._zero_sample

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        nb = len(self)
        pi = self.process_index
        batches = []
        for i in range(nb):
            g = order[i * self.batch_size:(i + 1) * self.batch_size]
            if len(g) < self.batch_size and self.pad_last:
                g = np.concatenate(
                    [g, np.full(self.batch_size - len(g), -1, g.dtype)])
            loc = g[pi * self.local_bs:(pi + 1) * self.local_bs]
            batches.append(loc)

        q: "queue.Queue" = queue.Queue(maxsize=self.num_workers * 2)
        stop = threading.Event()

        # each worker gets its own seeded Generator: np.random.Generator is
        # documented non-thread-safe, and the dataset's augmentation draws
        # would otherwise race on the shared one. Every process draws the
        # same epoch_seed, so a process past the first adds its index:
        # each sample of the global batch draws its own augmentation, as
        # one process loading the whole batch does (process 0 keeps the
        # one-process stream)
        epoch_seed = int(self.rng.integers(0, 2**31 - 1))
        proc = (pi,) if pi else ()

        def worker(worker_id: int):
            wrng = np.random.default_rng((epoch_seed, worker_id) + proc)
            for bi in range(worker_id, nb, self.num_workers):
                if stop.is_set():
                    return
                try:
                    samples = [
                        self._fetch(i, wrng) for i in batches[bi]
                    ]
                    q.put((bi, collate(samples)))
                except BaseException as e:  # surface in the main thread
                    q.put((bi, e))
                    return

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()

        try:
            pending: dict[int, Dict[str, np.ndarray]] = {}
            nxt = 0
            got = 0
            while got < nb:
                try:
                    bi, b = q.get(timeout=300)
                except queue.Empty:
                    if not any(t.is_alive() for t in threads):
                        raise RuntimeError(
                            "all BatchLoader workers died without output")
                    continue
                if isinstance(b, BaseException):
                    raise b
                pending[bi] = b
                got += 1
                while nxt in pending:
                    yield pending.pop(nxt)
                    nxt += 1
            while nxt in pending:
                yield pending.pop(nxt)
                nxt += 1
        finally:
            stop.set()

    def _fetch(self, i: int, wrng: np.random.Generator):
        """Fetch one sample, routing augmentation draws through the
        worker-local generator when the dataset supports it. i == -1 yields
        the all-invalid padding sample (pad_last tails)."""
        if i < 0:
            if self._zero_sample is None:
                self._zeros_like_sample(self.dataset[0])
            return self._zero_sample
        getter = getattr(self.dataset, "get_with_rng", None)
        if getter is not None:
            return getter(i, wrng)
        return self.dataset[i]
