"""The traced window split by the program's phases.

The program marks the phases of its steps with spans on the host's clock
(``openpcseg_torch/utils/spans.py``); ``profile`` records them inside the
profiled window, whose first record is the anchor that maps the host's
clock onto the trace's. ``attribute`` then gives:

- each device kernel (every device event ``trace.reduce`` counts) to the
  innermost span open when it was launched: the host's runtime call that
  launched it is found by the profiler's correlation id; a kernel with no
  launch found, or launched outside every span, goes to ``outside``;
- each stretch of device idle between ``t0`` and ``t1`` (the extent
  ``trace.reduce`` gives) to the innermost span open on the host meanwhile,
  split where the host moves from one span to the next;
- each host-blocking runtime call (``SYNCS``) to the innermost span it
  starts in. Calls outside every span (the harness's own synchronize, the
  serving loop's copy of the labels to the host) are listed under ``outside``
  and not counted by ``host_syncs_per_step``.

Kernel time over the phases and ``outside`` sums to the total kernel time,
and idle time to the window's idle time. ``phases`` is keyed by each
span's own name; ``inclusive`` also counts each span's work under the
names of the spans around it (``preprocess`` holds ``voxelize`` and
``geometry``). Times are microseconds from the trace's start until the
table, which gives seconds.
"""
from __future__ import annotations

import bisect
import importlib
from typing import Dict, List, Optional, Sequence, Tuple

from . import trace

ANCHOR = "spans.anchor"
OUTSIDE = "outside"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def profile(run_steps):
    """``trace.profile`` with the program's spans recorded inside the window
    -> (profile, wall in seconds, the span records); the records are None
    where the program has no spans."""
    try:
        spans = importlib.import_module("openpcseg_torch.utils.spans")
    except ImportError:
        prof, wall = trace.profile(run_steps)
        return prof, wall, None
    got = []

    def run():
        with spans.recording() as records:
            got.append(records)
            run_steps()
    prof, wall = trace.profile(run)
    return prof, wall, got[0]


def _runtime(name: str) -> bool:
    """A call of the CUDA runtime or of its lower-level API on the host
    (cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync,
    cudaStreamSynchronize, ...)."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


def events(prof) -> Dict:
    """{kernels: [(start_us, end_us, correlation)], runtime: [(name,
    start_us, end_us, correlation)], anchor_end_us, offset_us} of a
    profile, in microseconds from the trace's start, as ``trace.reduce``
    gives them. The kernels and runtime calls carry the device tracer's
    clock, the host ops and the anchor the profiler's own; ``offset_us``
    is the first less the second (``clock_offset``)."""
    from torch.autograd import DeviceType

    res = prof.profiler.kineto_results
    t_start = res.trace_start_ns()
    kernels, runtime, host, anchor_end = [], [], {}, None
    for e in res.events():
        a = (e.start_ns() - t_start) / 1e3
        b = a + e.duration_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                kernels.append((a, b, e.correlation_id()))
        elif _runtime(e.name()):
            runtime.append((e.name(), a, b, e.correlation_id(),
                            e.linked_correlation_id()))
        else:
            if e.correlation_id():
                host[e.correlation_id()] = (a, b)
            if e.name() == ANCHOR:
                anchor_end = b
    return dict(kernels=kernels,
                runtime=[r[:4] for r in runtime], anchor_end_us=anchor_end,
                offset_us=clock_offset(runtime, host))


def clock_offset(runtime, host) -> float:
    """How far the device tracer's clock runs ahead of the profiler's, in
    microseconds: each runtime call lies inside the host op that made it
    (its linked correlation id), so the offset lies in [call end - op end,
    call start - op start] for every pair; the midpoint of the pairs'
    common range, or the median of their midpoints where jitter leaves
    none; 0 where no call is linked to an op."""
    lo, hi, mids = float("-inf"), float("inf"), []
    for _, a, b, _, link in runtime:
        if link and link in host:
            oa, ob = host[link]
            lo, hi = max(lo, b - ob), min(hi, a - oa)
            mids.append((b - ob + a - oa) / 2)
    if not mids:
        return 0.0
    if lo <= hi:
        return (lo + hi) / 2
    return sorted(mids)[len(mids) // 2]


def mapped(records, anchor_end_us: float, offset_us: float = 0.0
           ) -> List[Tuple]:
    """The spans of a recording as (name, id, parent, step, start_us,
    end_us) on the trace's clock, through the recording's anchor, plus
    `offset_us` (``events``'s, to put them on the device tracer's
    clock)."""
    anc = next(r for r in records if r[0] == ANCHOR)
    shift = anchor_end_us + offset_us - anc[5] / 1e3
    return [(n, i, p, s, a / 1e3 + shift, b / 1e3 + shift)
            for n, i, p, s, a, b in records if n != ANCHOR]


def innermost(spans: Sequence[Tuple]) -> Tuple[List[float], List]:
    """The host's timeline as segments: (starts, ids), where segment k runs
    from starts[k] to starts[k + 1] (the last to the end of time) inside
    the innermost span ids[k], None outside every span. The spans of one
    thread nest, so the innermost open span is the one opened last."""
    edges = sorted([(a, 1, i) for _, i, _, _, a, _ in spans]
                   + [(b, 0, i) for _, i, _, _, _, b in spans])
    starts, ids, open_ = [float("-inf")], [None], []
    for t, opening, i in edges:
        if opening:
            open_.append(i)
        elif i in open_:
            open_.remove(i)
        top = open_[-1] if open_ else None
        if starts[-1] == t:
            ids[-1] = top
        else:
            starts.append(t)
            ids.append(top)
    return starts, ids


def _at(seg, t: float):
    starts, ids = seg
    return ids[bisect.bisect_right(starts, t) - 1]


def _split(seg, a: float, b: float):
    """(span id or None, overlap) of every segment that [a, b) meets."""
    starts, ids = seg
    k = bisect.bisect_right(starts, a) - 1
    while k < len(starts) and starts[k] < b:
        end = starts[k + 1] if k + 1 < len(starts) else float("inf")
        o = min(b, end) - max(a, starts[k])
        if o > 0:
            yield ids[k], o
        k += 1


def attribute(ev: Dict, records, t0: float, t1: float) -> Optional[Dict]:
    """The window's kernel time, idle time and host syncs by phase, from
    ``events(prof)``, the span records and the window's extent [t0, t1]
    (``trace.reduce``'s); None where there is no anchor to map the spans
    by. -> {phases, inclusive: {name: {device_s, idle_s, syncs}},
    kernel_s, unlinked: kernels whose launch was not found}."""
    if not records or ev.get("anchor_end_us") is None or not any(
            r[0] == ANCHOR for r in records):
        return None
    spans = mapped(records, ev["anchor_end_us"], ev.get("offset_us", 0.0))
    seg = innermost(spans)
    name = {i: n for n, i, _, _, _, _ in spans}
    parent = {i: p for _, i, p, _, _, _ in spans}

    def chain(i):
        out = []
        while i is not None:
            if name[i] not in out:
                out.append(name[i])
            i = parent[i]
        return out or [OUTSIDE]

    own: Dict[Optional[int], List[float]] = {}

    def add(i, k, v):
        own.setdefault(i, [0.0, 0.0, 0])[k] += v

    launch = {c: a for _, a, _, c in ev["runtime"]}
    unlinked, total = 0, 0.0
    for a, b, c in ev["kernels"]:
        total += b - a
        if c in launch:
            add(_at(seg, launch[c]), 0, b - a)
        else:
            unlinked += 1
            add(None, 0, b - a)
    for a, b in trace.gaps([(a, b) for a, b, _ in ev["kernels"]], t0, t1):
        for i, o in _split(seg, a, b):
            add(i, 1, o)
    for n, a, _, _ in ev["runtime"]:
        if n in SYNCS:
            add(_at(seg, a), 2, 1)

    phases: Dict[str, Dict] = {}
    inclusive: Dict[str, Dict] = {}
    for i, (dev, idle, syncs) in own.items():
        names = chain(i)
        for table, keys in ((phases, names[:1]), (inclusive, names)):
            for k in keys:
                row = table.setdefault(k, dict(device_s=0.0, idle_s=0.0,
                                               syncs=0))
                row["device_s"] += dev / 1e6
                row["idle_s"] += idle / 1e6
                row["syncs"] += syncs
    return dict(phases=phases, inclusive=inclusive, kernel_s=total / 1e6,
                unlinked=unlinked)


def line(att: Dict) -> str:
    """The ``[phases]`` line: each phase's device ms, idle ms and host
    syncs over the window, most device time first."""
    rows = sorted(att["phases"].items(), key=lambda kv: -kv[1]["device_s"])
    return "[phases] " + "; ".join(
        f"{n} {r['device_s'] * 1e3:.3f} ms device, {r['idle_s'] * 1e3:.3f} "
        f"ms idle, {r['syncs']} syncs" for n, r in rows)


# readers of a window's record that holds ``phases`` (the result of
# ``attribute``), ``scans`` and ``steps``; None where it holds no phases


def _phases(rec, mode) -> Optional[Dict]:
    if rec.get("mode") != mode or not rec.get("phases"):
        return None
    return rec["phases"]


def device_ms_per_scan(rec, mode, phase: str) -> Optional[float]:
    """Device ms of the kernels launched inside `phase` spans (those
    inside them included), per scan of the traced window."""
    att = _phases(rec, mode)
    if att is None or not rec.get("scans"):
        return None
    row = att["inclusive"].get(phase)
    return 1e3 * (row["device_s"] if row else 0.0) / rec["scans"]


def idle_ms_per_scan(rec, mode, phase: str) -> Optional[float]:
    """Device idle ms of the traced window while a `phase` span was open
    on the host, per scan."""
    att = _phases(rec, mode)
    if att is None or not rec.get("scans"):
        return None
    row = att["inclusive"].get(phase)
    return 1e3 * (row["idle_s"] if row else 0.0) / rec["scans"]


def host_syncs_per_step(rec, mode) -> Optional[float]:
    """Host-blocking runtime calls inside the program's spans, per traced
    step."""
    att = _phases(rec, mode)
    if att is None or not rec.get("steps"):
        return None
    return sum(r["syncs"] for n, r in att["phases"].items()
               if n != OUTSIDE) / rec["steps"]
