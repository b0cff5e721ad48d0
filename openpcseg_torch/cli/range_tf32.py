"""Estimate on the CPU how far TF32 convs move the range models' eval
logits and train steps: the predictions that ``chip_smoke.py``'s range
reference phases hold the card to.

    python -m openpcseg_torch.cli.range_tf32 [--train] [--out PATH]

For each range yaml at full width (64 x 2048), with chip_smoke's numpy
weights (``seed_range_weights``) on its scan (``range_request``), it runs
the eval forward in float32 and again with every conv's input and kernel
rounded to TF32's 10 mantissa bits (round to nearest even; the products
summed in float32, as the tensor cores do), and prints max|diff| /
max|float32| and the share of pixels whose argmax agrees. It models the
operand rounding only, not cuDNN's summation order. It also prints each
forward's conv GFLOP (2 x the multiply-adds of every conv and transposed
conv) and its count of convs and BNs.

With ``--train`` it reads one train step instead, for each range yaml
(AdamW + onecycle, chip_smoke's ``range_step``: numpy weights, scan SEED,
dropout off) and for RPVNet mk34_cr17_5 (SGD, chip_smoke's training
reference draws, float32 voxel branch): the float32 step against the
same step with every 2-D conv's operands rounded to TF32, forward and in
both backward products (dL/dx from dL/dy and the kernel, dL/dW from dL/dy
and the input), the products summed in float32, on DRAWS inputs (one
draw of TF32's rounding each). It prints and writes to ``--out``
(JSON) the worst over the draws, what chip_smoke's bounds take: for the
range models (loss rel, whole-gradient cosine, worst held tensor's
cosine, update rel; ``RANGE_TF32_TRAIN``), for RPVNet (loss rel,
whole-gradient cosine, worst conv cosine; ``RPV_TF32_READING``).
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[2]
# inputs a train step is read on: the loss difference of one draw ranges
# over an order of magnitude, so the bounds take the worst of five
DRAWS = 5


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), as float32."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF).view(torch.float32)


class _TF32Conv(torch.autograd.Function):
    """A 2-D conv or transposed conv whose operands are rounded to TF32 in
    the forward and in both products of the backward."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation, transposed,
                output_padding, groups):
        ctx.save_for_backward(x, w)
        ctx.cfg = (stride, padding, dilation, transposed, output_padding,
                   groups)
        ctx.bias = None if b is None else b.shape
        return torch.ops.aten.convolution(tf32(x), tf32(w), b, *ctx.cfg)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx, gw, gb = torch.ops.aten.convolution_backward(
            tf32(g), tf32(x), tf32(w), ctx.bias, *ctx.cfg,
            [True, True, ctx.bias is not None])
        return gx, gw, gb, None, None, None, None, None, None


def _pairs(v):
    return list(v) if isinstance(v, (tuple, list)) else [v, v]


def _tf32_conv2d(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    return _TF32Conv.apply(x, w, b, _pairs(stride), _pairs(padding),
                           _pairs(dilation), False, [0, 0], groups)


def _tf32_conv_t(x, w, b=None, stride=1, padding=0, output_padding=0,
                 groups=1, dilation=1):
    return _TF32Conv.apply(x, w, b, _pairs(stride), _pairs(padding),
                           _pairs(dilation), True, _pairs(output_padding),
                           groups)


def _worst(readings, high):
    """Per field the worst of several readings: the largest where a high
    value is worse (`high`), else the smallest."""
    return tuple(max(v) if h else min(v)
                 for v, h in zip(zip(*readings), high))


def train_readings(cs, draws: int = DRAWS) -> dict:
    """The float32 step against the TF32-emulated one, per range model
    and for RPVNet, on `draws` inputs each (the scan, then copies whose
    features are scaled by 1 + 1e-3 N(0, 1): each is one draw of TF32's
    rounding); the worst over the draws (see the module docstring)."""
    import numpy as np

    from openpcseg_torch.engine.task import SegTask, batch_to_device
    from openpcseg_torch.models.layers import SparseConv

    conv2d, conv_t = F.conv2d, F.conv_transpose2d

    def emulated(fn):
        F.conv2d, F.conv_transpose2d = _tf32_conv2d, _tf32_conv_t
        try:
            return fn()
        finally:
            F.conv2d, F.conv_transpose2d = conv2d, conv_t

    req = cs.range_request(cs.SEED)
    scan = req["scan"]
    rng = np.random.default_rng(cs.SEED)
    batches = []
    for d in range(draws):
        s = scan.copy()
        if d:      # the continuous channels; the mask (5) stays 0 / 1
            s[..., :5] *= 1 + 1e-3 * rng.standard_normal(s[..., :5].shape)
        batches.append({"scan": s.astype(np.float32), "label": req["label"],
                        "mask": req["mask"]})
    out = {}
    for name in cs.RANGE_MODELS:
        t0 = time.time()
        cfgs = cs.range_cfgs(name)
        got = []
        for d, batch in enumerate(batches):
            ref = cs.range_step(cfgs, batch, "cpu")
            run = emulated(lambda: cs.range_step(cfgs, batch, "cpu"))
            got.append(cs.range_step_reading(run, ref))
            rel, cos_all, cos_worst, upd, worst = got[-1]
            print(f"{name} draw {d}: TF32 step against float32: loss rel "
                  f"{rel:.4e}, whole-gradient cosine {cos_all:.8f}, worst "
                  f"held tensor cosine {cos_worst:.8f} ({worst}), update "
                  f"rel {upd:.4e}", flush=True)
        w = _worst([g[:4] for g in got], (True, False, False, True))
        out[name] = dict(draws=got, worst=w)
        print(f"{name}: worst over {draws} draws: loss rel {w[0]:.4e}, "
              f"whole-gradient cosine {w[1]:.8f}, worst held tensor cosine "
              f"{w[2]:.8f}, update rel {w[3]:.4e} ({time.time() - t0:.0f} s "
              f"on the CPU)", flush=True)

    t0 = time.time()

    def step(draw):
        t = SegTask(cs.RPV_TRAIN_CFGS, cs.NUM_CLASS, device="cpu",
                    seed=cs.SEED, voxel_cap_per_scan=8192,
                    iters_per_epoch=cs.ITERS_PER_EPOCH)
        cs.seed_weights(t.model, cs.SEED)
        cs.no_dropout(t.model)
        loss = float(t.train_step(batch_to_device(draw, "cpu"))["loss"])
        convs = [n + ".weight" for n, m in t.model.named_modules()
                 if isinstance(m, (SparseConv, torch.nn.Conv2d))]
        return loss, {n: p.grad.double().reshape(-1)
                      for n, p in t.model.named_parameters()}, convs

    def cos(a, b):
        return float(a @ b / (a.norm() * b.norm()).clamp(min=1e-300))
    got = []
    for d, draw in enumerate(cs.rpv_train_ref_draws()[:draws]):
        rloss, rg, convs = step(draw)
        loss, g, _ = emulated(lambda: step(draw))
        got.append((abs(loss - rloss) / abs(rloss),
                    cos(torch.cat([g[n] for n in rg]),
                        torch.cat(list(rg.values()))),
                    min(cos(g[n], rg[n]) for n in convs)))
        print(f"RPVNet draw {d}: TF32 range convs against float32: loss rel "
              f"{got[-1][0]:.4e}, whole-gradient cosine {got[-1][1]:.8f}, "
              f"worst conv cosine {got[-1][2]:.8f}", flush=True)
    w = _worst(got, (True, False, False))
    out["RPVNet"] = dict(draws=got, worst=w)
    print(f"RPVNet: worst over {draws} draws: loss rel {w[0]:.4e}, "
          f"whole-gradient cosine {w[1]:.8f}, worst conv cosine {w[2]:.8f} "
          f"({time.time() - t0:.0f} s on the CPU)", flush=True)
    return out


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", action="store_true",
                    help="read one train step per model instead")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    if args.train:
        out = train_readings(cs)
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(out, indent=1))
        return 0
    from openpcseg_torch.engine.task import SegTask, batch_to_device

    conv2d, conv_t = F.conv2d, F.conv_transpose2d
    batch = batch_to_device(cs.range_request(cs.SEED), "cpu")
    for name in cs.RANGE_MODELS:
        t0 = time.time()
        task = SegTask(cs.range_cfgs(name), cs.NUM_CLASS, device="cpu",
                       seed=cs.SEED)
        cs.seed_range_weights(task.model, cs.SEED)
        macs, n_conv = [0], [0]

        def count(m, inputs, out):
            k = m.kernel_size[0] * m.kernel_size[1]
            if isinstance(m, torch.nn.ConvTranspose2d):
                macs[0] += inputs[0].numel() * m.out_channels * k
            else:
                macs[0] += out.numel() * m.in_channels * k
            n_conv[0] += 1
        hooks = [m.register_forward_hook(count) for m in task.model.modules()
                 if isinstance(m, (torch.nn.Conv2d,
                                   torch.nn.ConvTranspose2d))]
        ref = task.range_logits(batch)
        for h in hooks:
            h.remove()
        n_bn = sum(type(m).__name__ == "BatchNorm2d"
                   for m in task.model.modules())
        F.conv2d = lambda x, w, *a, **k: conv2d(tf32(x), tf32(w), *a, **k)
        F.conv_transpose2d = lambda x, w, *a, **k: conv_t(tf32(x), tf32(w),
                                                          *a, **k)
        try:
            got = task.range_logits(batch)
        finally:
            F.conv2d, F.conv_transpose2d = conv2d, conv_t
        err = float((got - ref).abs().max() / ref.abs().max())
        agree = float((got.argmax(1) == ref.argmax(1)).float().mean())
        print(f"{name}: {2 * macs[0] / 1e9:.1f} conv GFLOP a forward, "
              f"{n_conv[0]} convs, {n_bn} BNs", flush=True)
        print(f"{name}: TF32 operands against float32: max|diff|/max|ref| "
              f"{err:.3e}, argmax agreement {agree:.5f} "
              f"({time.time() - t0:.0f} s on the CPU)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
