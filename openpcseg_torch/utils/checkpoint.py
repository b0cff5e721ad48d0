"""Shape-tolerant partial restore of a model (fine-tune workflows).

Counterpart of ``openpcseg_tpu/utils/checkpoint.py merge_matching`` over
flat ``state_dict`` names: every saved tensor whose name and shape match
the freshly built model is kept, the rest is skipped and reported (e.g. a
classifier head of another width). The JAX version also refuses a
checkpoint whose repeated blocks were stacked for ``nn.scan`` while the
model unrolls them (or the other way round); the port has one block
layout, so there is no such check here.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def merge_matching(target: Dict[str, torch.Tensor],
                   saved: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, torch.Tensor], int, List[str]]:
    """Returns (merged state_dict, n_loaded, skipped names): `target` with
    every entry whose name is in `saved` with the same shape replaced by
    the saved tensor (cast to the target's dtype and device)."""
    merged = {}
    loaded = 0
    skipped: List[str] = []
    for k, v in target.items():
        s = saved.get(k)
        if s is not None and tuple(s.shape) == tuple(v.shape):
            merged[k] = s.to(dtype=v.dtype, device=v.device)
            loaded += 1
        else:
            merged[k] = v
            skipped.append(k)
    return merged, loaded, skipped
