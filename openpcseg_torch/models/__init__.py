"""Segmentor registry: MODEL.NAME -> torch module (MinkUNet, SPVCNN,
RPVNet, Cylinder_TS and the range-view CENet, FIDNet, RangeNet and
SalsaNext: every segmentor of the JAX registry)."""
from __future__ import annotations

from typing import Any, Dict

from .cylinder3d import Cylinder_TS
from .minkunet import MinkUNet
from .range_cenet import CENet
from .range_fidnet import FIDNet
from .range_rangenet import RangeNet
from .range_salsanext import SalsaNext
from .rpvnet import RPVNet
from .spvcnn import SPVCNN

SEGMENTORS: Dict[str, Any] = {"MinkUNet": MinkUNet, "SPVCNN": SPVCNN,
                              "RPVNet": RPVNet, "Cylinder_TS": Cylinder_TS,
                              "CENet": CENet, "FIDNet": FIDNet,
                              "RangeNet": RangeNet, "SalsaNext": SalsaNext}


def build_segmentor(model_cfgs: Dict[str, Any], num_class: int, **kwargs):
    name = model_cfgs["NAME"]
    if name not in SEGMENTORS:
        raise NotImplementedError(
            f"segmentor {name!r} is not ported yet (have {sorted(SEGMENTORS)})")
    return SEGMENTORS[name](model_cfgs, num_class, **kwargs)
