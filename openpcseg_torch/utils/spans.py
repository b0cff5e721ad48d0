"""Phase spans of the program's steps, on the host's clock.

``span(name)`` marks a phase of a step (``SegTask``'s preprocess,
forward, loss, backward, update, postprocess; the batch's copy to the
device; the trainer's wait on its loader). It records nothing unless
``recording()`` is open: then every span the recording thread opens
appends ``(name, span_id, parent_id, step_id, t0_ns, t1_ns)`` to the list
``recording()`` yields, with times from ``time.perf_counter_ns()``. The
parent is the span open on that thread when it opened (None at the top
level). A top-level span starts a new step once the current step has had
its step span (``STEP_SPANS``), so a step's loader wait and copy share
the id of the step that takes them.

Off, ``span()`` returns one shared object that does nothing: no
allocation, no clock read, no profiler range.

Opened inside an active ``torch.profiler`` window, ``recording()`` first
emits one anchor: a ``record_function("spans.anchor")`` range around no
op, recorded as ``(ANCHOR, 0, None, None, t_in_ns, t_out_ns)``, the
clock read inside the range and the one right after it. The profiler
stamps the range's end as it leaves, so the range's end on the trace's
clock and ``t_out_ns`` are the same instant to a few microseconds:
``to_trace_us`` maps every span onto the trace's timeline through it.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import List, Optional, Tuple

ANCHOR = "spans.anchor"
STEP_SPANS = ("train_step", "eval_step", "predict_step",
              "predict_probs_step")

Record = Tuple[str, int, Optional[int], Optional[int], int, int]


class _Off:
    """The span that records nothing (one instance, shared)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_recorder: Optional["_Recorder"] = None


class _Recorder:
    def __init__(self):
        self.records: List[Record] = []
        self.thread = threading.get_ident()
        self.ids = itertools.count(1)
        self.open: List[int] = []
        self.step = 0
        self.step_rooted = True      # the next top-level span starts a step


class _Span:
    __slots__ = ("rec", "name", "id", "parent", "step", "t0")

    def __init__(self, rec: _Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.parent = rec.open[-1] if rec.open else None
        if self.parent is None:
            if rec.step_rooted:
                rec.step += 1
                rec.step_rooted = False
            if self.name in STEP_SPANS:
                rec.step_rooted = True
        self.id = next(rec.ids)
        self.step = rec.step
        rec.open.append(self.id)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = self.rec
        rec.open.pop()
        rec.records.append((self.name, self.id, self.parent, self.step,
                            self.t0, t1))
        return False


def span(name: str):
    """A context manager around the phase `name`: recorded while
    ``recording()`` is open on this thread, else the shared no-op."""
    rec = _recorder
    if rec is None or rec.thread != threading.get_ident():
        return _OFF
    return _Span(rec, name)


@contextmanager
def recording():
    """Record the spans this thread opens until the block ends; yields the
    list of records (complete once the block has ended). Inside an active
    ``torch.profiler`` window the list starts with the anchor."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("spans are being recorded already")
    rec = _Recorder()
    import torch
    if torch.autograd._profiler_enabled():
        with torch.profiler.record_function(ANCHOR):
            t_in = time.perf_counter_ns()
        rec.records.append((ANCHOR, 0, None, None, t_in,
                            time.perf_counter_ns()))
    _recorder = rec
    try:
        yield rec.records
    finally:
        _recorder = None


def anchor(records) -> Optional[Record]:
    """The anchor of a recording, None where it opened with no profiler."""
    return next((r for r in records if r[0] == ANCHOR), None)


def to_trace_us(t_ns: int, anchor_record: Record, anchor_end_us: float
                ) -> float:
    """A perf_counter_ns reading on the trace's clock (microseconds), given
    the anchor's record and the end of its range on that clock."""
    return anchor_end_us + (t_ns - anchor_record[5]) / 1e3


def merge_chrome_trace(path, records) -> int:
    """Add the spans of `records` to the chrome trace at `path` (an
    exported ``torch.profiler`` trace of the window the recording opened
    in) as complete events on a track of their own, beside the host thread
    that ran them -> the number of spans added. A trace without the
    recording's anchor is left as it was."""
    path = Path(path)
    trace = json.loads(path.read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    anc, mark = anchor(records), None
    if anc is not None:
        mark = next((e for e in events if e.get("name") == ANCHOR
                     and e.get("ph") == "X"), None)
    if mark is None:
        return 0
    end = float(mark["ts"]) + float(mark.get("dur", 0.0))
    pid, tid = mark["pid"], 0
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                   "args": {"name": "phases (spans)"}})
    n = 0
    for name, sid, parent, step, t0, t1 in records:
        if name == ANCHOR:
            continue
        events.append({"ph": "X", "cat": "span", "name": name, "pid": pid,
                       "tid": tid, "ts": to_trace_us(t0, anc, end),
                       "dur": (t1 - t0) / 1e3,
                       "args": {"span": sid, "parent": parent,
                                "step": step}})
        n += 1
    path.write_text(json.dumps(trace))
    return n
