"""The work of a MinkUNet step, counted from the reference's geometry.

Arithmetic copied from ``chip_smoke.py`` (``gemm_work``, ``dw_work``,
``parent_work``, ``devox_work``, ``devox_bwd_work``, ``bound``) and
counted here from the reference's exact voxel lists and pair lists, never
from the program's maps, so a change to the program's tables cannot move
it. Each call's bound is the larger of the bytes it must move over the
HBM rate and its operations over the peak rate of their type; a byte is
counted once per input read and once per output written, at the least
width the call could use: bf16 features and weights, one 4-byte row
index per hit, f32 for a weight gradient's output and for the
devoxelize's corner weights.

Peaks: NVIDIA's published H100 SXM figures (dense, no sparsity), at a
700 W power limit; the run prints the card's own limit beside them.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12       # bf16 tensor cores: the gather-GEMMs, dW
F32_FLOPS = 67e12            # float32 on the CUDA cores: K7, K8

Call = Tuple[str, float, float, float]    # (kind, bytes, operations, peak)


def _widths(model_cfg) -> List[int]:
    cr = model_cfg.get("cr", 1.0)
    return [int(cr * x) for x in model_cfg["PLANES"]]


def convs(model_cfg):
    """[(kind, level, cin, cout, first)] of every conv of MinkUNet
    (ResBlock), kind subm, down (level -> level + 1), up (level + 1 ->
    level) or 1x1; `first` marks the one conv whose input needs no
    gradient."""
    cs, nl = _widths(model_cfg), model_cfg["NUM_LAYER"]
    out = [("subm", 0, model_cfg["IN_FEATURE_DIM"], cs[0], True),
           ("subm", 0, cs[0], cs[0], False)]

    def blocks(level, cin, cout, n):
        for j in range(n):
            c_in = cin if j == 0 else cout
            out.append(("subm", level, c_in, cout, False))
            out.append(("subm", level, cout, cout, False))
            if c_in != cout:
                out.append(("1x1", level, c_in, cout, False))

    c, skips = cs[0], []
    for i in range(4):
        skips.append(c)
        out.append(("down", i, c, c, False))
        blocks(i + 1, c, cs[i + 1], nl[i])
        c = cs[i + 1]
    for i in range(4):
        planes = cs[5 + i]
        out.append(("up", 3 - i, c, planes, False))
        blocks(3 - i, planes + skips[3 - i], planes, nl[4 + i])
        c = planes
    return out


def geometry_counts(geo) -> Dict:
    """The counts the work depends on: voxels and subm hits per level,
    and the live devoxelize corners per devoxelized level."""
    return dict(
        voxels=[lv.n for lv in geo.levels],
        subm_hits=[sum(int(i.numel()) for _, i, _ in lv.subm)
                   for lv in geo.levels],
        devox_live={l: int((idx >= 0).sum()) for l, (idx, _) in
                    geo.devox.items()})


def step_work(counts: Dict, model_cfg, num_class: int, train: bool):
    """(model FLOPs, [calls the program's CUDA kernels must make]) of one
    step over a batch with these `counts`. Model FLOPs are 2 x hits x Cin
    x Cout over every sparse conv (a 1x1 conv hits each voxel once) and
    the classifier, times 3 in training."""
    n, hits = counts["voxels"], counts["subm_hits"]
    flops, calls = 0.0, []
    for kind, lvl, cin, cout, first in convs(model_cfg):
        if kind == "subm":
            h, n_in, n_out, k = hits[lvl], n[lvl], n[lvl], 27
        elif kind == "down":
            h, n_in, n_out, k = n[lvl], n[lvl], n[lvl + 1], 8
        elif kind == "up":
            h, n_in, n_out, k = n[lvl], n[lvl + 1], n[lvl], 8
        else:
            flops += 2.0 * n[lvl] * cin * cout
            continue
        mm = 2.0 * h * cin * cout
        flops += mm
        w = 2.0 * k * cin * cout
        calls.append((f"{kind}_fwd", 4.0 * h + 2.0 * n_in * cin
                      + 2.0 * n_out * cout + w, mm, BF16_TC_FLOPS))
        if train:
            if not first:
                calls.append((f"{kind}_dfeats", 4.0 * h + 2.0 * n_out * cout
                              + 2.0 * n_in * cin + w, mm, BF16_TC_FLOPS))
            calls.append((f"{kind}_dw", 4.0 * h + 2.0 * n_in * cin
                          + 2.0 * n_out * cout + 2.0 * w, mm, BF16_TC_FLOPS))
    cs = _widths(model_cfg)
    width = {4: cs[4], 2: cs[6]}
    for lvl, live in counts["devox_live"].items():
        c = width[lvl]
        moved = 8.0 * live + 2.0 * n[lvl] * c + 2.0 * n[0] * c
        calls.append(("devox_fwd", moved, 2.0 * live * c, F32_FLOPS))
        if train:
            calls.append(("devox_bwd", moved, 2.0 * live * c, F32_FLOPS))
    flops += 2.0 * n[0] * (cs[4] + cs[6] + cs[8]) * num_class
    return flops * (3 if train else 1), calls


def bound_s(call: Call) -> float:
    """The least seconds a call can take on the card."""
    _, moved, ops, peak = call
    return max(moved / HBM_BYTES_PER_S, ops / peak)
