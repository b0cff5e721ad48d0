"""The traced window split by the program's phases (``benchmark/lib/
phases.py``), on a record built by hand: kernels to the span they were
launched in, idle to the innermost span open on the host, syncs outside
every span not counted; then a real profile of a tiny step on the CPU,
and a program without spans."""
from __future__ import annotations

import sys

import pytest
import torch

from benchmark.lib import phases, trace

A = phases.ANCHOR
# the anchor's clock read maps to 0 us: span times in ns are trace us x 1e3
RECORDS = [
    (A, 0, None, None, -5_000, 0),
    ("to_device", 1, None, 1, 0, 10_000),
    ("predict_step", 2, None, 1, 10_000, 100_000),
    ("preprocess", 3, 2, 1, 12_000, 40_000),
    ("voxelize", 4, 3, 1, 12_000, 20_000),
    ("geometry", 5, 3, 1, 20_000, 40_000),
    ("forward", 6, 2, 1, 40_000, 80_000),
    ("postprocess", 7, 2, 1, 80_000, 95_000),
]
EV = dict(
    anchor_end_us=0.0,
    kernels=[(3.0, 4.0, 1), (15.0, 18.0, 2), (26.0, 30.0, 3),
             (46.0, 70.0, 4), (70.0, 75.0, 5), (83.0, 84.0, 6),
             (101.0, 102.0, 7), (103.0, 104.0, 99)],
    runtime=[("cudaMemcpyAsync", 1.0, 1.5, 1),
             ("cudaStreamSynchronize", 2.0, 4.0, 11),
             ("cudaStreamSynchronize", 5.0, 6.0, 12),
             ("cudaLaunchKernel", 14.0, 14.5, 2),
             ("cuLaunchKernel", 25.0, 25.5, 3),
             ("cudaStreamSynchronize", 30.0, 31.0, 13),
             ("cudaMemcpy", 35.0, 36.0, 14),
             ("cudaLaunchKernel", 45.0, 45.5, 4),
             ("cudaLaunchKernel", 50.0, 50.5, 5),
             ("cudaLaunchKernel", 82.0, 82.5, 6),
             ("cudaLaunchKernel", 100.5, 100.7, 7),
             ("cudaStreamSynchronize", 101.0, 102.0, 15)])
T0, T1 = 0.0, 105.0


def _us(table, key):
    return {n: round(r[key] * 1e6, 6) if key != "syncs" else r[key]
            for n, r in table.items() if r[key]}


def test_kernels_go_to_the_span_they_were_launched_in():
    att = phases.attribute(EV, RECORDS, T0, T1)
    assert _us(att["phases"], "device_s") == {
        "to_device": 1.0, "voxelize": 3.0, "geometry": 4.0, "forward": 29.0,
        "postprocess": 1.0, "outside": 2.0}
    total = sum(b - a for a, b, _ in EV["kernels"]) / 1e6
    assert att["kernel_s"] == pytest.approx(total)
    assert sum(r["device_s"] for r in att["phases"].values()) == \
        pytest.approx(total)
    assert att["unlinked"] == 1                # kernel 99: no launch found
    # preprocess holds its children's work
    assert att["inclusive"]["preprocess"]["device_s"] == pytest.approx(7e-6)
    assert att["inclusive"]["predict_step"]["device_s"] == pytest.approx(
        37e-6)


def test_idle_goes_to_the_innermost_span_open_on_the_host():
    att = phases.attribute(EV, RECORDS, T0, T1)
    assert _us(att["phases"], "idle_s") == {
        "to_device": 9.0, "predict_step": 7.0, "voxelize": 5.0,
        "geometry": 16.0, "forward": 11.0, "postprocess": 14.0,
        "outside": 3.0}
    busy = trace.busy([(a, b) for a, b, _ in EV["kernels"]], T0, T1)
    assert sum(r["idle_s"] for r in att["phases"].values()) == \
        pytest.approx((T1 - T0 - busy) / 1e6)


def test_syncs_outside_the_programs_spans_are_not_counted():
    att = phases.attribute(EV, RECORDS, T0, T1)
    assert _us(att["phases"], "syncs") == {"to_device": 2, "geometry": 2,
                                           "outside": 1}
    rec = dict(mode="serve", steps=1, scans=2, phases=att)
    assert phases.host_syncs_per_step(rec, "serve") == 4.0
    assert phases.host_syncs_per_step(dict(rec, steps=2), "serve") == 2.0


def test_readers():
    att = phases.attribute(EV, RECORDS, T0, T1)
    rec = dict(mode="train", steps=1, scans=2, phases=att)
    assert phases.device_ms_per_scan(rec, "train", "preprocess") == \
        pytest.approx(7e-3 / 2)
    assert phases.idle_ms_per_scan(rec, "train", "preprocess") == \
        pytest.approx(21e-3 / 2)
    assert phases.device_ms_per_scan(rec, "train", "loss") == 0.0
    for read in (lambda r: phases.device_ms_per_scan(r, "train", "forward"),
                 lambda r: phases.idle_ms_per_scan(r, "train", "forward"),
                 lambda r: phases.host_syncs_per_step(r, "train")):
        assert read(rec) is not None
        assert read(dict(rec, mode="eval")) is None
        assert read(dict(rec, phases=None)) is None
    assert "[phases] forward 0.029 ms device" in phases.line(att)


def test_the_anchor_maps_any_clock():
    """The same window with the host's clock 5 s later and the trace's
    anchor at 17 us gives the same split."""
    shift_ns, at_us = 5_000_000_000, 17.0
    recs = [(n, i, p, s, a + shift_ns - 17_000, b + shift_ns - 17_000)
            for n, i, p, s, a, b in RECORDS]
    recs[0] = (A, 0, None, None, shift_ns - 1_000, shift_ns)
    ev = dict(EV, anchor_end_us=at_us)
    assert phases.attribute(ev, recs, T0, T1) == phases.attribute(
        EV, RECORDS, T0, T1)
    assert phases.attribute(dict(EV, anchor_end_us=None), RECORDS, T0,
                            T1) is None
    assert phases.attribute(EV, RECORDS[1:], T0, T1) is None
    assert phases.attribute(EV, None, T0, T1) is None


def test_the_device_tracers_clock_is_put_on_the_spans():
    """Runtime calls and kernels 30 us ahead of the host ops that made
    them: the offset is found from the calls' ops, and the split is the
    one of the same window on one clock."""
    host = {101: (0.5, 3.0), 102: (13.0, 16.0), 103: (24.0, 27.0)}
    runtime = [("cudaMemcpyAsync", 31.0, 31.5, 1, 101),
               ("cudaLaunchKernel", 44.0, 44.5, 2, 102),
               ("cuLaunchKernel", 55.0, 55.5, 3, 103),
               ("cudaStreamSynchronize", 32.0, 34.0, 11, 0)]
    # every pair allows 28.5-30.5 us (the calls made 0.5-3 us into their
    # ops): the midpoint
    assert phases.clock_offset(runtime, host) == pytest.approx(29.5)
    assert phases.clock_offset(runtime[3:], host) == 0.0
    ahead = dict(EV, offset_us=30.0,
                 kernels=[(a + 30, b + 30, c) for a, b, c in EV["kernels"]],
                 runtime=[(n, a + 30, b + 30, c)
                          for n, a, b, c in EV["runtime"]])
    assert phases.attribute(ahead, RECORDS, T0 + 30, T1 + 30) == \
        phases.attribute(EV, RECORDS, T0, T1)


def test_segments_of_nested_spans_that_share_an_edge():
    spans = [("a", 1, None, 1, 0.0, 10.0), ("b", 2, 1, 1, 0.0, 5.0),
             ("c", 3, 1, 1, 5.0, 10.0), ("d", 4, None, 2, 10.0, 12.0)]
    seg = phases.innermost(spans)
    got = [phases._at(seg, t) for t in (-1.0, 0.0, 4.9, 5.0, 9.9, 10.0,
                                        12.0)]
    assert got == [None, 2, 2, 3, 3, 4, None]
    assert list(phases._split(seg, 4.0, 11.0)) == [(2, 1.0), (3, 5.0),
                                                   (4, 1.0)]


def _tiny_task():
    from openpcseg_torch.data.raycast import raycast_batch
    from openpcseg_torch.engine.task import SegTask, batch_to_device
    cfgs = {"DATA": {"DATASET": "semantickitti", "VOXEL_SIZE": 0.05},
            "MODEL": {"NAME": "MinkUNet", "BLOCK": "ResBlock",
                      "NUM_LAYER": [1] * 8, "PLANES": [8] * 9, "cr": 1.0},
            "TPU": {"VOXEL_CAP_PER_SCAN": 4096,
                    "VOXEL_CAP_RATIOS": [1.0, 1.0, 0.6, 0.3, 0.15]}}
    task = SegTask(cfgs, 20, device="cpu")
    batch = raycast_batch(0, 1, cap=4096)
    return lambda: task.predict_step(batch_to_device(batch, "cpu"))


def test_a_real_profile_of_a_step_on_the_cpu():
    step = _tiny_task()
    step()
    prof, wall, records = phases.profile(lambda: [step() for _ in range(2)])
    assert wall > 0
    assert sum(r[0] == A for r in records) == 1
    rec = trace.reduce(prof)
    ev = phases.events(prof)
    assert ev["anchor_end_us"] is not None and not ev["kernels"]
    att = phases.attribute(ev, records, rec["t0"], rec["t1"])
    # no device here: the window is idle throughout, split by the spans
    assert att["kernel_s"] == 0.0
    assert sum(r["idle_s"] for r in att["phases"].values()) == \
        pytest.approx((rec["t1"] - rec["t0"]) / 1e6)
    assert {"to_device", "predict_step", "voxelize", "geometry", "forward",
            "postprocess"} <= set(att["phases"])
    assert att["inclusive"]["predict_step"]["idle_s"] > \
        att["inclusive"]["forward"]["idle_s"] > 0
    assert {r[3] for r in records if r[0] != A} == {1, 2}


def test_a_program_without_spans_reads_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "openpcseg_torch.utils.spans", None)
    prof, _, records = phases.profile(lambda: torch.ones(3) + 1)
    assert records is None
    rec = trace.reduce(prof)
    assert phases.attribute(phases.events(prof), records, rec["t0"],
                            rec["t1"]) is None
    assert phases.host_syncs_per_step(dict(mode="train", steps=1,
                                           phases=None), "train") is None
