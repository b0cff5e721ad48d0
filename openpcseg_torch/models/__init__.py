"""Segmentor registry: MODEL.NAME -> torch module (MinkUNet so far)."""
from __future__ import annotations

from typing import Any, Dict

from .minkunet import MinkUNet

SEGMENTORS: Dict[str, Any] = {"MinkUNet": MinkUNet}


def build_segmentor(model_cfgs: Dict[str, Any], num_class: int, **kwargs):
    name = model_cfgs["NAME"]
    if name not in SEGMENTORS:
        raise NotImplementedError(
            f"segmentor {name!r} is not ported yet (have {sorted(SEGMENTORS)})")
    return SEGMENTORS[name](model_cfgs, num_class, **kwargs)
