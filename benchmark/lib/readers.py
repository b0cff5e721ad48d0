"""What the metric readers of ``benchmark/metrics/`` share: each reads a
window's record and returns its number, or None where the record holds
nothing it can read (another mode, no trace), so the metric is left out
of the line."""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import trace


def scans_per_s(rec, modes) -> Optional[float]:
    if rec.get("mode") not in modes or not rec.get("window_s"):
        return None
    return rec["scans"] / rec["window_s"]


def percentile(values, q: float) -> Optional[float]:
    """The q-th percentile of every value (numpy's linear interpolation
    between the two nearest ranks), None for no values."""
    if not len(values):
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def traced(rec, mode) -> bool:
    return rec.get("mode") == mode and "kernels" in rec


def mfu(rec, mode) -> Optional[float]:
    """Model FLOPs of the traced steps over (the wall of the same steps run
    untraced x the bf16 peak), in percent."""
    if not traced(rec, mode) or "flops" not in rec:
        return None
    return 100.0 * rec["flops"] / (rec["plain_s"] * rec["peak_flops"])


def _split(rec):
    port, tail = 0.0, 0.0
    for name, a, b in rec["kernels"]:
        if rec["port_kernel"].search(name):
            port += b - a
        else:
            tail += b - a
    return port / 1e6, tail / 1e6


def kernel_roofline_share(rec, mode) -> Optional[float]:
    """The summed bound of the program's CUDA kernel calls over their
    summed device time, in percent; None where none ran."""
    if not traced(rec, mode) or "bound_s" not in rec:
        return None
    port, _ = _split(rec)
    return 100.0 * rec["bound_s"] / port if port > 0 else None


def tail_device_ms_per_scan(rec, mode) -> Optional[float]:
    """Device ms of every kernel that is not one of the program's own,
    per scan of the window."""
    if not traced(rec, mode) or not rec.get("scans") or not rec["kernels"]:
        return None
    return 1e3 * _split(rec)[1] / rec["scans"]


def device_idle_share(rec, mode) -> Optional[float]:
    """1 - (union of the device's kernel intervals in the traced window) /
    (the wall of the same steps run untraced), in percent. The traced
    wall holds the profiler's host cost; the kernels' times do not. Not
    clamped: a busy time over the wall reads below 0, a mismatch of the
    two clocks to look at."""
    if not traced(rec, mode) or not rec["kernels"]:
        return None
    busy = trace.busy([(a, b) for _, a, b in rec["kernels"]], rec["t0"],
                      rec["t1"]) / 1e6
    return 100.0 * (1.0 - busy / rec["plain_s"])
