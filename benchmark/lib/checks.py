"""The comparisons that decide ``correct``, and the control's rounding.

Training (the first three steps of the object the window drives): each
step's loss against the reference's, relative, the worst step; the norm
of each leaf's first gradient as the optimizer gets it (after the clip),
and of each leaf's change after the three steps, as the gap between the
program's norm and the reference's over the larger of the reference's
norm of that leaf and of the median leaf, read at the median leaf and at
the worst. The worst leaf is a BN scale or shift or a first conv of
levels 0-1, whose gradient is a small residue of sums over a million
voxels: bf16 rounding alone moves it by a tenth and more, as the
reference rounded to bf16 shows (PERF.md). Leaves whose reference
gradient is under a thousandth of the median leaf's are left out of
both. The train driver names the numbers it holds to limits.

Serving and evaluation: the widest gap by which the reference's logit of
a served label lies below the reference's best logit of that point, over
the points of the requests compared, in units of the standard deviation
of the reference's logits there.
"""
from __future__ import annotations

from typing import Dict, List

import torch

TINY_LEAF = 1e-3


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.float())) for n, t in d.items()}


def _median(vals: List[float]) -> float:
    v = sorted(vals)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1]
                                                   + v[len(v) // 2])


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep) -> Dict[str, float]:
    """Each leaf's gap of norms, over the larger of its reference norm and
    the median leaf's, for the leaves in `keep`."""
    med = _median([ref[n] for n in keep])
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in keep}


def train_readings(prog_losses, ref_losses, prog_grads, ref_grads,
                   prog_delta, ref_delta) -> Dict:
    """{loss_gap, grad_gap, change_gap (median leaf), grad_worst,
    change_worst, grad_leaf, change_leaf (the worst leaf), left_out}."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(prog_losses, ref_losses))
    rg = _norms(ref_grads)
    med = _median(list(rg.values()))
    keep = [n for n in rg if rg[n] >= TINY_LEAF * med]
    out = dict(loss_gap=loss_gap, left_out=sorted(set(rg) - set(keep)))
    for name, gaps in (("grad", leaf_gaps(_norms(prog_grads), rg, keep)),
                       ("change", leaf_gaps(_norms(prog_delta),
                                            _norms(ref_delta), keep))):
        leaf = max(gaps, key=gaps.get)
        out.update({f"{name}_gap": _median(list(gaps.values())),
                    f"{name}_worst": gaps[leaf], f"{name}_leaf": leaf})
    return out


def leaf_table(prog_grads, ref_grads, prog_delta, ref_delta):
    """{leaf: [program gradient norm, reference's, program change norm,
    reference's, elements]}: what the readings are made of."""
    pg, rg = _norms(prog_grads), _norms(ref_grads)
    pd, rd = _norms(prog_delta), _norms(ref_delta)
    return {n: [pg[n], rg[n], pd[n], rd[n], ref_grads[n].numel()]
            for n in rg}


def label_gap(ref_logits: torch.Tensor, served: torch.Tensor) -> float:
    """max over rows of (best reference logit - the served label's), over
    the std of the reference logits; `served` [N] labels, one per row of
    ref_logits [N, C]."""
    best = ref_logits.max(dim=1).values
    got = ref_logits.gather(1, served.long().clamp(0, ref_logits.shape[1]
                                                   - 1)[:, None])[:, 0]
    gap = torch.where((served >= 0) & (served < ref_logits.shape[1]),
                      best - got, torch.full_like(best, float("inf")))
    return float(gap.max() / ref_logits.std().clamp(min=1e-30))


def bf16_quant():
    """Rounding to bf16 of every matmul operand, forward and backward: the
    reference made to round as the configuration's compute type does, as a
    witness of what bf16 alone does to the numbers compared."""
    def f(t):
        return t.to(torch.bfloat16).to(t.dtype)
    return f, f


def fp8_quant():
    """The control's rounding, one precision below bf16: per-tensor scaled
    float8 e4m3 for forward operands, e5m2 for gradients (the usual fp8
    training recipe); values stay float32 around it."""
    def q(dtype):
        top = torch.finfo(dtype).max

        def f(t):
            s = t.abs().max().clamp(min=1e-30) / top
            return (t / s).to(dtype).to(t.dtype) * s
        return f
    return q(torch.float8_e4m3fn), q(torch.float8_e5m2)
