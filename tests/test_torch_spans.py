"""The port's phase spans (``openpcseg_torch/utils/spans.py``).

On the CPU: off, ``span()`` is one shared object that allocates nothing
and reads no clock; on, spans nest, name their parents and share a step id
with the copy of their step's batch; each step of a tiny MinkUNet and of a
tiny range model yields exactly its phase tree; the anchor is emitted once
inside a profiler and not outside one.

Marked ``cuda`` (skipped where torch sees no CUDA device): on the card the
spans, mapped onto the profiler's clock through the anchor, enclose the
geometry pass's ``aten::sort`` ops within 20 us, and an ``.item()``
planted inside ``forward`` reads as exactly one more host sync a step,
under ``forward``, in the harness's attribution (``benchmark/lib/
phases.py``). On the card:

    python -m pytest -m cuda --noconftest tests/test_torch_spans.py
"""
import itertools
import threading
import time
import tracemalloc

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from openpcseg_torch.config import CfgDict, cfg_from_yaml_file
from openpcseg_torch.data.range_view import synthetic_range_batch
from openpcseg_torch.data.raycast import raycast_batch
from openpcseg_torch.engine.task import SegTask, batch_to_device
from openpcseg_torch.utils import spans

NUM_CLASS = 20
MODEL = {"NAME": "MinkUNet", "IGNORE_LABEL": 0, "IN_FEATURE_DIM": 4,
         "BLOCK": "ResBlock", "NUM_LAYER": [1, 1, 1, 1, 1, 1, 1, 1],
         "PLANES": [8, 8, 8, 8, 8, 8, 8, 8, 8], "cr": 1.0,
         "DROPOUT_P": 0.0}
TPU = {"VOXEL_CAP_PER_SCAN": 4096, "VOXEL_CAP_RATIOS": [1.0, 1.0, 0.6, 0.3,
                                                        0.15]}
OPTIM = {"BATCH_SIZE_PER_GPU": 1, "NUM_EPOCHS": 2, "OPTIMIZER": "sgd",
         "LR_PER_SAMPLE": 0.02, "WEIGHT_DECAY": 0.0001, "MOMENTUM": 0.9,
         "NESTEROV": True, "GRAD_NORM_CLIP": 10,
         "SCHEDULER": "linear_warmup_with_cosdecay", "WARMUP_EPOCH": 1}
RANGE_YAML = "tools/cfgs/range/semantic_kitti/cenet_64x2048.yaml"

PRE = ("preprocess", (("voxelize", ()), ("geometry", ())))
# each step's phase tree: (name, children), children in the order they ran
TREES = {
    "train_step": ("train_step", (PRE, ("forward", ()), ("loss", ()),
                                  ("backward", ()), ("update", ()))),
    "eval_step": ("eval_step", (PRE, ("forward", ()),
                                ("postprocess", ()))),
    "predict_step": ("predict_step", (PRE, ("forward", ()),
                                      ("postprocess", ()))),
    "predict_probs_step": ("predict_probs_step", (PRE, ("forward", ()),
                                                  ("postprocess", ()))),
}
RANGE_TREES = {
    "train_step": ("train_step", (("forward", ()), ("loss", ()),
                                  ("backward", ()), ("update", ()))),
    "eval_step": ("eval_step", (("forward", ()), ("postprocess", ()))),
    "predict_step": ("predict_step", (("forward", ()),
                                      ("postprocess", ()))),
}


def tree(records, root_id):
    """The (name, children) tree under span `root_id`, children by start."""
    kids = sorted((r for r in records if r[2] == root_id),
                  key=lambda r: r[4])
    name = next(r[0] for r in records if r[1] == root_id)
    return (name, tuple(tree(records, r[1]) for r in kids))


def top_level(records):
    """(name, step) of the top-level spans, in the order they opened."""
    return [(r[0], r[3]) for r in sorted(records, key=lambda r: r[4])
            if r[2] is None and r[0] != spans.ANCHOR]


def step_of(task, kind, batch):
    """One `kind` step of `task` on the numpy `batch`, copied with
    ``batch_to_device`` inside the recording."""
    with spans.recording() as records:
        getattr(task, kind)(batch_to_device(batch, "cpu"))
    return records


@pytest.fixture(scope="module")
def mink():
    cfgs = {"DATA": {"DATASET": "semantickitti", "VOXEL_SIZE": 0.05},
            "MODEL": dict(MODEL), "OPTIM": dict(OPTIM), "TPU": dict(TPU)}
    task = SegTask(cfgs, NUM_CLASS, device="cpu", iters_per_epoch=2)
    return task, raycast_batch(0, 1, cap=4096)


@pytest.fixture(scope="module")
def cenet():
    ycfg = CfgDict()
    cfg_from_yaml_file(RANGE_YAML, ycfg)
    cfgs = {"MODALITY": "range",
            "DATA": {"DATASET": "semantickitti", "H": 16, "W": 128},
            "MODEL": dict(ycfg.MODEL, LAYERS=[1, 1, 1, 1]),
            "OPTIM": dict(ycfg.OPTIM, BATCH_SIZE_PER_GPU=1)}
    task = SegTask(cfgs, NUM_CLASS, device="cpu", iters_per_epoch=2)
    return task, synthetic_range_batch(0, 1, h=16, w=128)


def _peak_bytes(make, n=2000):
    """The peak of traced memory over `n` entries of ``with make(name)``,
    above where it started."""
    loop = itertools.repeat(None, n)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        for _ in loop:
            with make("forward"):
                pass
        return tracemalloc.get_traced_memory()[1] - before
    finally:
        tracemalloc.stop()


def test_off_is_one_shared_object_that_allocates_and_reads_nothing(
        monkeypatch):
    shared = spans.span("forward")
    assert shared is spans.span("loss")

    def no_clock():
        raise AssertionError("a span read the clock while off")
    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    with spans.span("a"):
        pass
    # the interpreter's own bytes of the loop are the same with the shared
    # object handed out by a bare lambda; an object made per call shows
    assert _peak_bytes(spans.span) == _peak_bytes(lambda name: shared)
    assert _peak_bytes(lambda name: type(shared)()) > _peak_bytes(
        lambda name: shared)


def test_on_nests_names_parents_and_shares_the_step_id():
    with spans.recording() as records:
        with spans.span("load"):
            pass
        with spans.span("to_device"):
            pass
        with spans.span("train_step"):
            with spans.span("preprocess"):
                with spans.span("voxelize"):
                    pass
            with spans.span("forward"):
                pass
        with spans.span("to_device"):
            pass
        with spans.span("predict_step"):
            pass
    assert spans.span("x") is spans.span("y")          # off again
    by = {r[1]: r for r in records}
    assert [(r[0], r[1], r[2], r[3]) for r in sorted(
        records, key=lambda r: r[1])] == [
        ("load", 1, None, 1), ("to_device", 2, None, 1),
        ("train_step", 3, None, 1), ("preprocess", 4, 3, 1),
        ("voxelize", 5, 4, 1), ("forward", 6, 3, 1),
        ("to_device", 7, None, 2), ("predict_step", 8, None, 2)]
    for _, i, p, _, t0, t1 in records:
        assert t0 <= t1
        if p is not None:
            assert by[p][4] <= t0 and t1 <= by[p][5]
    assert spans.anchor(records) is None           # no profiler: no anchor


def test_recording_does_not_nest_and_other_threads_record_nothing():
    off = spans.span("load")
    with spans.recording() as records:
        with pytest.raises(RuntimeError, match="already"):
            with spans.recording():
                pass
        seen = []
        t = threading.Thread(target=lambda: seen.append(spans.span("load")))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with seen[0]:
            pass
        assert seen[0] is off
    assert records == []
    with spans.recording() as again:           # the switch opens again
        with spans.span("load"):
            pass
    assert [r[0] for r in again] == ["load"]


@pytest.mark.parametrize("kind", sorted(TREES))
def test_minkunet_step_yields_its_phase_tree(mink, kind):
    task, batch = mink
    records = step_of(task, kind, batch)
    assert top_level(records) == [("to_device", 1), (kind, 1)]
    root = next(r[1] for r in records if r[0] == kind)
    assert tree(records, root) == TREES[kind]
    assert {r[3] for r in records} == {1}


@pytest.mark.parametrize("kind", sorted(RANGE_TREES))
def test_range_step_yields_its_phase_tree(cenet, kind):
    task, batch = cenet
    records = step_of(task, kind, batch)
    assert top_level(records) == [("to_device", 1), (kind, 1)]
    root = next(r[1] for r in records if r[0] == kind)
    assert tree(records, root) == RANGE_TREES[kind]


def test_anchor_inside_a_profiler_maps_the_spans_onto_its_clock(mink):
    """One anchor, in the records and in the trace; through it, the host's
    ``aten::sort`` ops of a predict step (the voxelize and geometry passes
    sort, nothing else does) lie inside ``preprocess``. The CPU runs other
    tests' processes beside this one, so the bound here is 1 ms; the
    card's test holds 20 us."""
    from torch.profiler import ProfilerActivity, profile
    task, batch = mink
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        records = step_of(task, "predict_step", batch)
    anc = spans.anchor(records)
    assert anc is not None and sum(r[0] == spans.ANCHOR
                                   for r in records) == 1
    marks = [e for e in prof.events() if e.name == spans.ANCHOR]
    assert len(marks) == 1
    end = marks[0].time_range.end
    pre = [(spans.to_trace_us(r[4], anc, end), spans.to_trace_us(
        r[5], anc, end)) for r in records if r[0] == "preprocess"]
    sorts = [e.time_range for e in prof.events() if e.name == "aten::sort"]
    assert sorts and len(pre) == 1
    a, b = pre[0]
    for r in sorts:
        assert a - 1e3 <= r.start and r.end <= b + 1e3


# on the card


def _cuda_task():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfgs = {"DATA": {"DATASET": "semantickitti", "VOXEL_SIZE": 0.05},
            "MODEL": {"NAME": "MinkUNet", "BLOCK": "ResBlock"},
            "TPU": {"VOXEL_CAP_PER_SCAN": 131072}}
    task = SegTask(cfgs, NUM_CLASS, device="cuda",
                   compute_dtype=torch.bfloat16)
    return task, raycast_batch(0, 1)


def _traced(task, batch, steps):
    """`steps` predict steps under the harness's profiled window -> (the
    window's record as ``trace.reduce`` gives it, the span records, the
    attribution)."""
    from benchmark.lib import phases, trace

    def run():
        for _ in range(steps):
            task.predict_step(batch_to_device(batch, "cuda"))
        torch.cuda.synchronize()
    prof, _, records = phases.profile(run)
    rec = trace.reduce(prof)
    ev = phases.events(prof)
    att = phases.attribute(ev, records, rec["t0"], rec["t1"])
    return prof, rec, ev, records, att


@pytest.mark.cuda
def test_card_spans_enclose_their_ops_and_count_a_planted_sync():
    from benchmark.lib import phases
    task, batch = _cuda_task()
    for _ in range(2):                      # builds the kernels, warms up
        task.predict_step(batch_to_device(batch, "cuda"))
    torch.cuda.synchronize()
    steps = 3
    prof, rec, ev, records, att = _traced(task, batch, steps)

    # every device kernel is attributed, and its launch found
    total = sum(b - a for _, a, b in rec["kernels"]) / 1e6
    split = sum(r["device_s"] for r in att["phases"].values())
    assert att["unlinked"] == 0
    assert split == pytest.approx(total, rel=1e-3)
    assert att["kernel_s"] == pytest.approx(total, rel=1e-3)

    # the geometry pass's sorts lie inside preprocess, within 20 us
    pre = [(a, b) for n, _, _, _, a, b in phases.mapped(
        records, ev["anchor_end_us"]) if n == "preprocess"]
    sorts = [e.time_range for e in prof.events() if e.name == "aten::sort"]
    assert len(pre) == steps and sorts
    for r in sorts:
        assert any(a - 20 <= r.start and r.end <= b + 20 for a, b in pre)

    base = dict(mode="serve", steps=steps, scans=steps, phases=att)
    fwd = att["phases"].get("forward", {}).get("syncs", 0)
    model = task.model
    forward = type(model).forward

    def planted(self, *a, **k):
        out = forward(self, *a, **k)
        (out[0] if isinstance(out, tuple) else out).sum().item()
        return out
    model.forward = planted.__get__(model)
    try:
        *_, att2 = _traced(task, batch, steps)
    finally:
        del model.forward
    more = dict(base, phases=att2)
    assert phases.host_syncs_per_step(more, "serve") - \
        phases.host_syncs_per_step(base, "serve") == 1.0
    assert att2["phases"]["forward"]["syncs"] - fwd == steps
