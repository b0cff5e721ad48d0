"""On the card: each cell of BENCHMARK.json runs briefly and comes out
correct. Here, without a card, the fixture skips them.

    python -m pytest -m cuda benchmark/tests/test_bench_card.py
"""
from __future__ import annotations

import io
import json
from contextlib import redirect_stderr, redirect_stdout

import pytest

from benchmark import run

SPEC = json.loads((run.ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run on the card only")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_is_correct_on_the_card(card, cell):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", "4294967311",
                       "--seconds", "3", "--trace", "0"])
    assert rc == 0, err.getvalue()[-3000:]
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
