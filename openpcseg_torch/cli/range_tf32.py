"""Estimate on the CPU how far TF32 convs move the range models' eval
logits: the prediction that ``chip_smoke.py``'s range reference phase
holds the card to (RANGE_REF_TOL, RANGE_REF_AGREE).

    python -m openpcseg_torch.cli.range_tf32

For each range yaml at full width (64 x 2048), with chip_smoke's numpy
weights (``seed_range_weights``) on its scan (``range_request``), it runs
the eval forward in float32 and again with every conv's input and kernel
rounded to TF32's 10 mantissa bits (round to nearest even; the products
summed in float32, as the tensor cores do), and prints max|diff| /
max|float32| and the share of pixels whose argmax agrees. It models the
operand rounding only, not cuDNN's summation order. It also prints each
forward's conv GFLOP (2 x the multiply-adds of every conv and transposed
conv) and its count of convs and BNs.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[2]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), as float32."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF).view(torch.float32)


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
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
