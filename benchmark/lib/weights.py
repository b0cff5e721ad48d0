"""The weights of a run, made by the benchmark from the seed on the device
and handed to both sides.

Every conv and the classifier draw from one normal sample of all their
elements on the device (one call, a torch.Generator on the card seeded
with the run's seed), clipped to two standard deviations and scaled by
variance scaling, std = sqrt(1 / fan_in) / 0.8796 (the std of a unit
normal clipped to [-2, 2]: flax's default the program follows). Each BN's
scale is 1 + 0.2 n and its shift 0.2 n, n from the same clipped sample;
the classifier's bias is 0.

BN's running statistics are those of data, as a trained model's are:
where a batch's geometry is given (serving and evaluation, whose BN
normalises with them), the reference runs that batch once in float32
with BN on the batch's statistics, the drawn scales and shifts applied,
and each BN takes the mean and (biased) variance it saw there. Otherwise
(training, whose BN normalises with the batch's own) they are 0 and 1.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

CLIPPED_STD = 0.87962566103423978
BN_SPREAD = 0.2


def make(spec, seed: int, device, model_cfg=None,
         calib=None) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on `device` for every entry of a reference
    ``param_spec``; `calib`, a reference Geometry, sets BN's running
    statistics (with `model_cfg`, the MODEL block)."""
    drawn = [(n, s, fan) for n, s, fan, kind in spec
             if kind in ("conv", "fc", "bn_w", "bn_b")]
    total = sum(math.prod(s) for _, s, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    flat = torch.randn(total, generator=gen, device=device).clamp_(-2.0, 2.0)
    kinds = {n: kind for n, _, _, kind in spec}
    out, at = {}, 0
    for n, s, fan in drawn:
        k = math.prod(s)
        x = flat[at:at + k].view(s)
        at += k
        if kinds[n] == "bn_w":
            out[n] = 1.0 + BN_SPREAD * x
        elif kinds[n] == "bn_b":
            out[n] = BN_SPREAD * x
        else:
            out[n] = x * (math.sqrt(1.0 / fan) / CLIPPED_STD)
    fill = {"bn_var": 1.0, "bn_mean": 0.0, "bias": 0.0}
    for n, s, _, kind in spec:
        if kind in fill:
            out[n] = torch.full(s, fill[kind], device=device)
    if calib is not None:
        from ..reference import minkunet as R
        stats = {}
        with torch.no_grad():
            R.Net(model_cfg, out, train=True, stats=stats)(calib)
        for name, (mean, var) in stats.items():
            out[f"{name}.running_mean"] = mean.clone()
            out[f"{name}.running_var"] = var.clone()
    return out


def for_cell(config, traffic, seed: int, device, batches):
    """A cell's weights: BN's running statistics from the pool's first
    scan as it was cast, untransformed, where the mix does not train."""
    from ..reference import geometry as G, minkunet as R
    spec = R.param_spec(config["MODEL"], config["num_class"])
    calib = None
    if traffic["mode"] != "train":
        first = [torch.as_tensor(batches[0][k][:1]).to(device)
                 for k in ("xyz", "feats", "labels", "valid")]
        calib = G.build(*first, voxel_size=config["DATA"]["VOXEL_SIZE"])
    return make(spec, seed, device, config["MODEL"], calib)
