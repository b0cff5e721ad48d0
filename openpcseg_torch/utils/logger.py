"""Logging + meters (reference: tools/utils/common/common_utils.py:82-96
create_logger, :251-266 AverageMeter; TensorBoard scalars are replaced by a
JSONL metrics stream — this environment ships no tensorboard).

A copy of ``openpcseg_tpu/utils/logger.py``, held to it by
tests/test_torch_data.py, apart from the file handling of ``create_logger``.
"""
from __future__ import annotations

import json
import logging
import time
from pathlib import Path


def create_logger(log_file: str | Path | None = None,
                  rank: int = 0) -> logging.Logger:
    """The package logger: console, and `log_file` when given on rank 0
    (the other ranks log warnings to the console only). A later call
    moves the file output to its own `log_file` (closing the earlier
    file), so a second run in one process, as a train then an infer call,
    logs to its own file; the JAX package's logger keeps the first."""
    logger = logging.getLogger("openpcseg_torch")
    logger.setLevel(logging.INFO if rank == 0 else logging.WARNING)
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler):
            logger.removeHandler(h)
            h.close()
    if not logger.handlers:
        console = logging.StreamHandler()
        console.setFormatter(fmt)
        logger.addHandler(console)
    if log_file is not None and rank == 0:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricsWriter:
    """Append-only JSONL scalar stream (TensorBoard replacement)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")

    def write(self, step: int, **scalars) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            rec[k] = float(v)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class AverageMeter:
    """(reference common_utils.py:251-266)"""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)
