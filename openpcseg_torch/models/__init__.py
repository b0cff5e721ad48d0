"""Segmentor registry: MODEL.NAME -> torch module (MinkUNet, SPVCNN and
Cylinder_TS so far; the JAX package's other segmentors raise
NotImplementedError naming the ROADMAP.md Queue 1 item that ports each)."""
from __future__ import annotations

from typing import Any, Dict

from .cylinder3d import Cylinder_TS
from .minkunet import MinkUNet
from .spvcnn import SPVCNN

SEGMENTORS: Dict[str, Any] = {"MinkUNet": MinkUNet, "SPVCNN": SPVCNN,
                              "Cylinder_TS": Cylinder_TS}
_NOT_PORTED = {"RPVNet": 13, "CENet": 14, "FIDNet": 14, "RangeNet": 14,
               "SalsaNext": 14}


def build_segmentor(model_cfgs: Dict[str, Any], num_class: int, **kwargs):
    name = model_cfgs["NAME"]
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"segmentor {name!r} is not ported yet (ROADMAP.md Queue 1 item "
            f"{_NOT_PORTED[name]})")
    if name not in SEGMENTORS:
        raise NotImplementedError(
            f"segmentor {name!r} is not ported yet (have {sorted(SEGMENTORS)})")
    return SEGMENTORS[name](model_cfgs, num_class, **kwargs)
