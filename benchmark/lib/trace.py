"""The traced window: a torch.profiler window of its own over a few steps,
reduced to what the per-layer readers take.

Method copied from ``chip_smoke.py`` (``_device_rows``,
``_device_events``): only device kernels count, never an annotation
(host ranges and their device-side copies carry their kernels' time
again). The device's busy time is the union of its kernel intervals;
an idle gap is a stretch of the window between them, named by the host
op that overlapped it most. A kernel is one of the program's own CUDA
kernels where its name holds, as a whole word, the stem of a file in
``benchmark/kernels/``.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Tuple

KERNELS_DIR = Path(__file__).resolve().parents[1] / "kernels"


def port_kernel_pattern(kernels_dir: Path = KERNELS_DIR) -> re.Pattern:
    names = sorted(p.stem for p in kernels_dir.glob("*.json"))
    return re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy(intervals, t0: float, t1: float) -> float:
    """Length of the union of `intervals` inside [t0, t1]."""
    return sum(max(0.0, min(b, t1) - max(a, t0))
               for a, b in merge(intervals))


def gaps(intervals, t0: float, t1: float) -> List[Tuple[float, float]]:
    """The idle stretches of [t0, t1] between the merged intervals."""
    out, at = [], t0
    for a, b in merge(intervals):
        if a > at:
            out.append((at, min(a, t1)))
        at = max(at, b)
        if at >= t1:
            break
    if at < t1:
        out.append((at, t1))
    return [(a, b) for a, b in out if b > a]


def profile(run_steps):
    """torch.profiler (host ops and device kernels) around run_steps(),
    which ends with a device synchronize -> (profile, the window's host
    wall in seconds)."""
    import time

    from torch.profiler import ProfilerActivity, profile as _profile

    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_steps()
        wall = time.perf_counter() - t0
    return prof, wall


def reduce(prof) -> Dict:
    """{kernels: [(name, start_us, end_us)], host: [(name, start_us,
    end_us)] of the top-level host ops, t0, t1: the span of the events}
    of a profile (microseconds from the trace's start)."""
    from torch.autograd import DeviceType

    kernels, host = [], []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue
        r = e.time_range
        if e.device_type == DeviceType.CUDA:
            kernels.append((e.name, r.start, r.end))
        elif e.cpu_parent is None:
            host.append((e.name, r.start, r.end))
    spans = kernels + host
    t0 = min((a for _, a, _ in spans), default=0.0)
    t1 = max((b for _, _, b in spans), default=0.0)
    return dict(kernels=kernels, host=host, t0=t0, t1=t1)


def short(name: str, width: int = 96) -> str:
    """A kernel's name without its return type, cut to `width` letters."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= width else name[:width - 3] + "..."


def breakdown(rec: Dict, top: int = 10) -> Dict:
    """The device ops that took most time and the longest idle gaps, named
    by the host op that overlapped each most (seconds)."""
    by_name: Dict[str, float] = {}
    for name, a, b in rec["kernels"]:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps([(a, b) for _, a, b in rec["kernels"]], rec["t0"],
                       rec["t1"]), key=lambda g: g[0] - g[1])[:top]
    host = sorted(rec["host"], key=lambda h: h[1])
    named = []
    for a, b in idle:
        best, over = "host idle", 0.0
        for name, ha, hb in host:
            if ha >= b:
                break
            o = min(hb, b) - max(ha, a)
            if o > over:
                best, over = name, o
        named.append([short(best), (b - a) / 1e6])
    return {"device_ops": [[short(n), t / 1e6] for n, t in ops],
            "idle_gaps": named}
