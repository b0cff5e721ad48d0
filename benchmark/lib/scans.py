"""The scan pool: distinct padded scans made from the run's seed by the
frozen ray-cast generators, in a few worker processes, then stacked into
the batches a traffic mix sends.

A configuration's ``scans`` block names the generator and its sizes:

- ``kitti``: a 64-beam HDL-64-like scan (``n_beams`` x ``n_azimuth``
  rays), padded to ``points_cap``: xyz, feats [x, y, z, intensity],
  labels (20 SemanticKITTI train ids), valid;
- ``waymo``: a Waymo top-lidar frame with its second return, padded to
  ``points_cap``: feats [x, y, z, tanh(intensity), tanh(elongation)],
  labels (23 Waymo train ids).

Scan i of a pool is drawn from ``SeedSequence([seed, i])``: the same seed
gives the same pool, on any machine.

A ``Feed`` makes step i of a run from pool batch i % n: where the mix
names an ``augment`` block, every scan of the step is moved by a global
transform of its own, drawn from ``(seed, i, scan)``, so no two steps of a
run send the same points and a cache keyed by the points never hits.
"""
from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

KEYS = ("xyz", "feats", "labels", "valid")
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def scan_seed(seed: int, index: int) -> int:
    return int(np.random.SeedSequence([seed, index]).generate_state(1)[0])


def make_scan(spec: Dict, seed: int) -> Dict[str, np.ndarray]:
    """One padded scan ([Np, ...] arrays) of the generator `spec` names."""
    gen = spec["generator"]
    if gen == "kitti":
        from ..scangen.raycast import pad_scan, raycast_scan
        xyz, feats, labels = raycast_scan(
            seed, n_beams=spec["n_beams"], n_azimuth=spec["n_azimuth"])
        return dict(zip(KEYS, pad_scan(xyz, feats, labels,
                                       spec["points_cap"])))
    if gen == "waymo":
        from ..scangen.raycast_waymo import frame_batch
        b = frame_batch(seed, spec["points_cap"])
        return {k: b[k][0] for k in KEYS}
    raise ValueError(f"unknown scan generator {gen!r}")


def _job(args):
    spec, seed = args
    return make_scan(spec, seed)


class Pool:
    """Makes `n` scans in the background; ``batches(b)`` waits for them
    and stacks them into n // b batches of `b` scans, in order."""

    def __init__(self, spec: Dict, seed: int, n: int, workers: int = 0):
        jobs = [(spec, scan_seed(seed, i)) for i in range(n)]
        # two cores stay free: one for the process that starts torch and
        # builds the task meanwhile, one for the host's own work
        workers = workers or max(1, min(n, (os.cpu_count() or 3) - 2, 6))
        if workers == 1:
            self._scans = [_job(j) for j in jobs]
            self._exe = None
            return
        self._exe = ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"))
        # one thread a worker: the workers fill the host's cores
        saved = {k: os.environ.get(k) for k in THREAD_VARS}
        os.environ.update({k: "1" for k in THREAD_VARS})
        try:
            self._futures = [self._exe.submit(_job, j) for j in jobs]
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        self._scans = None

    def scans(self) -> List[Dict[str, np.ndarray]]:
        if self._scans is None:
            try:
                self._scans = [f.result() for f in self._futures]
            finally:
                self._exe.shutdown(wait=True)
        return self._scans

    def close(self) -> None:
        if self._exe is not None:
            self._exe.shutdown(wait=True, cancel_futures=True)

    def batches(self, b: int) -> List[Dict[str, np.ndarray]]:
        scans = self.scans()
        return [{k: np.stack([s[k] for s in scans[i:i + b]]) for k in KEYS}
                for i in range(0, len(scans) - b + 1, b)]


def transform(aug: Dict, rng: np.random.Generator):
    """(m [3, 3], t [3]) float32 of one scan's global transform, xyz @ m +
    t, drawn as the voxel view's training augmentation draws it
    (``openpcseg_torch/data/augment.py aug_points``): a rotation about z,
    uniform in [0, 2 pi); a scale, uniform in ``aug["scale"]``; one of the
    four flips of x and y; a translation, normal with std ``aug["jitter"]``
    on each axis. A key the block leaves out is not drawn."""
    m = np.eye(3)
    if aug.get("rotate"):
        th = rng.uniform(0, 2 * np.pi)
        c, s = np.cos(th), np.sin(th)
        m = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
    d = np.ones(3)
    if aug.get("scale"):
        d *= rng.uniform(*aug["scale"])
    if aug.get("flip"):
        f = int(rng.integers(0, 4))
        d[0] *= -1.0 if f in (1, 3) else 1.0
        d[1] *= -1.0 if f in (2, 3) else 1.0
    t = (rng.normal(0.0, aug["jitter"], 3) if aug.get("jitter")
         else np.zeros(3))
    return (m * d).astype(np.float32), t.astype(np.float32)


class Feed:
    """Step i of a run: pool batch i % n, every scan moved by its own
    transform (``transform``, drawn from ``[seed, 2, i, scan]``) where
    `aug` is given. ``make(i)`` is pure: the reference remakes any step.
    ``__call__(i)`` returns step i and starts step i + 1 in a thread, as a
    data loader's worker would; ``prime(i)`` starts step i before a
    window opens."""

    def __init__(self, batches: List[Dict[str, np.ndarray]],
                 aug: Optional[Dict], seed: int, ahead: bool = True):
        self.batches, self.aug, self.seed = batches, aug or None, seed
        for b in batches:
            if self.aug and not np.array_equal(b["feats"][..., :3],
                                               b["xyz"]):
                raise ValueError("a transform needs feats that begin with "
                                 "xyz")
        self._exe = ThreadPoolExecutor(1) if ahead else None
        self._ahead = {}

    def make(self, i: int) -> Dict[str, np.ndarray]:
        b = self.batches[i % len(self.batches)]
        if not self.aug:
            return b
        xyz = np.empty_like(b["xyz"])
        for j in range(xyz.shape[0]):
            m, t = transform(self.aug, np.random.default_rng(
                [self.seed, 2, i, j]))
            xyz[j] = b["xyz"][j] @ m             # padding rows stay 0
            np.add(xyz[j], t, out=xyz[j], where=b["valid"][j][:, None])
        feats = b["feats"].copy()
        feats[..., :3] = xyz
        return dict(b, xyz=xyz, feats=feats)

    def prime(self, i: int) -> None:
        if self._exe is not None and i not in self._ahead:
            self._drop()
            self._ahead = {i: self._exe.submit(self.make, i)}

    def _drop(self) -> None:
        """Cancel the step made ahead, or read it, so that no error of
        the thread goes unseen."""
        for fut in self._ahead.values():
            if not fut.cancel():
                fut.result()
        self._ahead = {}

    def __call__(self, i: int) -> Dict[str, np.ndarray]:
        fut = self._ahead.pop(i, None)
        b = fut.result() if fut is not None else self.make(i)
        self.prime(i + 1)
        return b

    def close(self) -> None:
        if self._exe is not None:
            self._drop()
            self._exe.shutdown(wait=True)
