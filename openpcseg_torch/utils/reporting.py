"""Eval report tables (no prettytable dependency).

Information-content parity with the reference's evaluation block
(reference train.py:469-490): a titled per-class IoU table and a
row-normalized confusion-matrix table with a Points column.

A copy of ``openpcseg_tpu/utils/reporting.py``, held to it by
tests/test_torch_data.py.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def _render(title: str, field_names: Sequence[str], rows) -> str:
    cols = [list(map(str, field_names))]
    for r in rows:
        cols.append([str(c) for c in r])
    widths = [max(len(row[i]) for row in cols) for i in range(len(cols[0]))]

    def line(ch="-", joint="+"):
        return joint + joint.join(ch * (w + 2) for w in widths) + joint

    def fmt(row):
        return "| " + " | ".join(
            c.ljust(w) for c, w in zip(row, widths)) + " |"

    total_w = len(line())
    out = [line(), "|" + title.center(total_w - 2) + "|", line(),
           fmt(cols[0]), line()]
    out += [fmt(r) for r in cols[1:]]
    out.append(line())
    return "\n".join(out)


def iou_table(miou: float, iou: np.ndarray,
              class_names: Sequence[str]) -> str:
    """Per-class IoU table (reference train.py:469-477: title
    'Validation iou', an 'All' row, then one row per class)."""
    rows = [["All", round(float(miou), 4)]]
    for name, v in zip(class_names, iou):
        rows.append([name, round(float(v), 4)])
    return _render("Validation iou", ["Classes", "IoU"], rows)


def confusion_table(hist: np.ndarray,
                    class_names: Sequence[str]) -> str:
    """Row-normalized confusion matrix in percent + per-row point count
    (reference train.py:479-490). `hist[i, j]` = points of true class i
    predicted as class j; rows/cols follow `class_names` (class 0/ignore
    already cropped by the caller)."""
    rows = []
    for i, name in enumerate(class_names):
        total = float(hist[i].sum())
        row = [name] + [round(v / (total + 1e-8) * 100.0, 2)
                        for v in hist[i]] + [int(total)]
        rows.append(row)
    fields = ["Classes"] + list(class_names) + ["Points"]
    return _render("Confusion matrix", fields, rows)
