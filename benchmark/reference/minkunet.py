"""Plain reference MinkUNet (ResBlock): forward, loss, backward and the SGD
update, in float32 PyTorch with TF32 off.

The network is OpenPCSeg's MinkUNet as its yamls configure it (PLANES,
cr, NUM_LAYER, IN_FEATURE_DIM; BLOCK ResBlock): a stem of two 3x3x3
conv-BN-ReLU blocks; four down stages (a k2/s2 conv-BN-ReLU block, then
residual blocks); four up stages (a k2/s2 transposed conv, BN, ReLU, the
skip of the same level concatenated after it, then residual blocks); a
linear classifier over the devoxelized features of levels 4, 2 and 0.
A residual block is conv-BN-ReLU-conv-BN plus the input (through a 1x1
conv and BN where the width changes), then ReLU. BN normalises with the
batch's statistics (biased variance, eps 1e-5) in training and with its
running statistics in evaluation. Parameters are named as the program's
checkpoints name them, so the benchmark hands one dict to both sides.

The loss is cross-entropy with label smoothing plus Lovász-softmax
(Berman et al. 2018, the classes present) over the level-0 voxels whose
label is not the ignored one; the update clips the gradients to a total
norm and takes torch's SGD step (L2 term added to the gradient, then
Nesterov momentum) at the schedule's rate.

``quant`` puts every value the configuration computes in its compute type
through a rounding function, forward values and backward gradients apart:
the operands of every conv and 1x1 matmul, and the activations the
program keeps in that type (the input features, each conv's, BN's and
residual sum's output, each devoxelized level). The benchmark's control
runs the reference so, one precision below the configuration's.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import geometry as G

Quant = Optional[Tuple[Callable, Callable]]   # (forward operands, gradients)


def _widths(model_cfg) -> List[int]:
    cr = model_cfg.get("cr", 1.0)
    return [int(cr * x) for x in model_cfg["PLANES"]]


def param_spec(model_cfg, num_class: int):
    """[(name, shape, fan_in or None, kind)] of every parameter and BN
    buffer, in the program's checkpoint names; kind is conv, fc, bn_w,
    bn_b, bn_mean, bn_var or bias."""
    cs = _widths(model_cfg)
    nl = model_cfg["NUM_LAYER"]
    spec = []

    def conv(name, k, cin, cout):
        shape = (cin, cout) if k == 1 else (k, cin, cout)
        spec.append((name, shape, k * cin, "conv"))

    def bn(name, c):
        for leaf, kind in (("weight", "bn_w"), ("bias", "bn_b"),
                           ("running_mean", "bn_mean"),
                           ("running_var", "bn_var")):
            spec.append((f"{name}.{leaf}", (c,), None, kind))

    def blocks(prefix, cin, cout, n):
        for j in range(n):
            c_in = cin if j == 0 else cout
            conv(f"{prefix}.{j}.conv1.weight", 27, c_in, cout)
            bn(f"{prefix}.{j}.bn1", cout)
            conv(f"{prefix}.{j}.conv2.weight", 27, cout, cout)
            bn(f"{prefix}.{j}.bn2", cout)
            if c_in != cout:
                conv(f"{prefix}.{j}.shortcut.weight", 1, c_in, cout)
                bn(f"{prefix}.{j}.bn_sc", cout)

    in_dim = model_cfg["IN_FEATURE_DIM"]
    conv("stem.0.conv.weight", 27, in_dim, cs[0])
    bn("stem.0.bn", cs[0])
    conv("stem.1.conv.weight", 27, cs[0], cs[0])
    bn("stem.1.bn", cs[0])
    c, skips = cs[0], []
    for i in range(4):
        skips.append(c)
        conv(f"downs.{i}.conv.weight", 8, c, c)
        bn(f"downs.{i}.bn", c)
        blocks(f"down_blocks.{i}", c, cs[i + 1], nl[i])
        c = cs[i + 1]
    for i in range(4):
        planes = cs[5 + i]
        conv(f"ups.{i}.weight", 8, c, planes)
        bn(f"up_bns.{i}", planes)
        blocks(f"up_blocks.{i}", planes + skips[3 - i], planes, nl[4 + i])
        c = planes
    width = cs[4] + cs[6] + cs[8]
    spec.append(("classifier.weight", (num_class, width), width, "fc"))
    spec.append(("classifier.bias", (num_class,), None, "bias"))
    return spec


def is_buffer(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


class _Conv(torch.autograd.Function):
    """out[o] += q(x[i]) @ q(W[k]) over the (k, i, o) pairs; the backward
    gathers again instead of keeping the gathered rows."""

    @staticmethod
    def forward(ctx, x, w, pairs, n_out, quant):
        ctx.save_for_backward(x, w)
        ctx.pairs, ctx.quant = pairs, quant
        qf = quant[0] if quant else (lambda t: t)
        out = x.new_zeros((n_out, w.shape[-1]))
        for k, i, o in pairs:
            if i.numel():
                out.index_add_(0, o, qf(x[i]) @ qf(w[k]))
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        qf, qb = ctx.quant if ctx.quant else (lambda t: t, lambda t: t)
        dx = torch.zeros_like(x) if ctx.needs_input_grad[0] else None
        dw = torch.zeros_like(w)
        for k, i, o in ctx.pairs:
            if not i.numel():
                continue
            g = qb(dy[o])
            if dx is not None:
                dx.index_add_(0, i, g @ qf(w[k]).t())
            dw[k] = qf(x[i]).t() @ g
        return dx, dw, None, None, None


def _mm(x, w, quant):
    if quant:
        return _Mm.apply(x, w, quant)
    return x @ w


class _Mm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, quant):
        ctx.save_for_backward(x, w)
        ctx.quant = quant
        return quant[0](x) @ quant[0](w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        qf, qb = ctx.quant
        g = qb(dy)
        return g @ qf(w).t(), qf(x).t() @ g, None


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, quant):
        ctx.quant = quant
        return quant[0](x)

    @staticmethod
    def backward(ctx, dy):
        return ctx.quant[1](dy), None


class Net:
    """The forward pass over one batch's Geometry with parameters `p`
    (name -> tensor)."""

    def __init__(self, model_cfg, p: Dict[str, torch.Tensor],
                 train: bool, quant: Quant = None, stats=None):
        self.cfg, self.p, self.train, self.quant = model_cfg, p, train, quant
        self.stats = stats       # name -> (batch mean, batch var) in training

    def r(self, x):
        """x rounded as the compute type rounds it (the identity in
        float32)."""
        return _Round.apply(x, self.quant) if self.quant else x

    def conv(self, x, name, pairs, n_out):
        return self.r(_Conv.apply(x, self.p[name], pairs, n_out, self.quant))

    def bn(self, x, name):
        if self.train:
            mean = x.mean(0)
            var = ((x - mean) ** 2).mean(0)
            if self.stats is not None:
                self.stats[name] = (mean.detach(), var.detach())
        else:
            mean = self.p[f"{name}.running_mean"]
            var = self.p[f"{name}.running_var"]
        return self.r((x - mean) * torch.rsqrt(var + 1e-5)
                      * self.p[f"{name}.weight"] + self.p[f"{name}.bias"])

    def block(self, x, prefix, lv):
        y = torch.relu(self.bn(self.conv(x, f"{prefix}.conv1.weight",
                                         lv.subm, lv.n), f"{prefix}.bn1"))
        y = self.bn(self.conv(y, f"{prefix}.conv2.weight", lv.subm, lv.n),
                    f"{prefix}.bn2")
        sc = x
        if f"{prefix}.shortcut.weight" in self.p:
            sc = self.bn(self.r(_mm(x, self.p[f"{prefix}.shortcut.weight"],
                                    self.quant)), f"{prefix}.bn_sc")
        return torch.relu(self.r(y + sc))

    def blocks(self, x, prefix, n, lv):
        for j in range(n):
            x = self.block(x, f"{prefix}.{j}", lv)
        return x

    def devox(self, x, idx, w):
        out = 0.0
        for c in range(idx.shape[0]):
            out = out + x[idx[c].clamp(min=0)] * w[c][:, None]
        return self.r(out)

    def __call__(self, geo: G.Geometry) -> torch.Tensor:
        lv, nl = geo.levels, self.cfg["NUM_LAYER"]
        in_dim = self.cfg["IN_FEATURE_DIM"]
        dt = self.p["classifier.weight"].dtype
        x = self.r(geo.feats[:, :in_dim].to(dt))
        for s in range(2):
            x = torch.relu(self.bn(self.conv(
                x, f"stem.{s}.conv.weight", lv[0].subm, lv[0].n),
                f"stem.{s}.bn"))
        feats = [x]
        for i in range(4):
            x = torch.relu(self.bn(self.conv(
                x, f"downs.{i}.conv.weight", lv[i].updown, lv[i + 1].n),
                f"downs.{i}.bn"))
            x = self.blocks(x, f"down_blocks.{i}", nl[i], lv[i + 1])
            feats.append(x)
        z = [self.devox(x, *geo.devox[4])]
        for i in range(4):
            fine = lv[3 - i]
            up = [(k, c, f) for k, f, c in fine.updown]
            x = self.conv(x, f"ups.{i}.weight", up, fine.n)
            x = torch.relu(self.bn(x, f"up_bns.{i}"))
            x = self.blocks(torch.cat([x, feats[3 - i]], dim=1),
                            f"up_blocks.{i}", nl[4 + i], fine)
            if i == 1:
                z.append(self.devox(x, *geo.devox[2]))
        z.append(x)
        h = torch.cat(z, dim=1)
        return h @ self.p["classifier.weight"].t() + self.p["classifier.bias"]


def lovasz_softmax(probs, labels):
    """Mean over the classes present of the Lovász extension of the
    Jaccard loss; probs [N, C], labels [N] (kept rows only)."""
    c = probs.shape[1]
    fg = (labels[None, :] == torch.arange(c, device=labels.device)[:, None])
    fg = fg.float()
    errors = (fg - probs.t()).abs()
    errors_sorted, perm = torch.sort(errors, dim=1, descending=True,
                                     stable=True)
    fg_sorted = fg.gather(1, perm)
    gts = fg_sorted.sum(1, keepdim=True)
    inter = gts - fg_sorted.cumsum(1)
    union = gts + (1.0 - fg_sorted).cumsum(1)
    jac = 1.0 - inter / union
    grad = torch.cat([jac[:, :1], jac[:, 1:] - jac[:, :-1]], dim=1)
    present = fg.sum(1) > 0
    return (errors_sorted * grad).sum(1)[present].mean()


def seg_loss(logits, labels, model_cfg):
    """CE with label smoothing + Lovász-softmax over the kept voxels."""
    ignore = model_cfg.get("IGNORE_LABEL", 0)
    c = logits.shape[1]
    keep = (labels != ignore) & (labels >= 0) & (labels < c)
    lg, lb = logits[keep], labels[keep]
    ce = torch.nn.functional.cross_entropy(
        lg, lb, label_smoothing=model_cfg.get("LABEL_SMOOTHING", 0.0))
    return ce + lovasz_softmax(torch.softmax(lg, dim=1), lb)


def lr_at(step: int, optim_cfg, batch: int, iters_per_epoch: int) -> float:
    """linear_warmup_with_cosdecay (OpenPCSeg's, floor 1e-5 of the peak)
    at the linear scaling rule's peak LR_PER_SAMPLE x batch."""
    if optim_cfg.get("SCHEDULER") != "linear_warmup_with_cosdecay":
        raise NotImplementedError(optim_cfg.get("SCHEDULER"))
    base = optim_cfg["LR_PER_SAMPLE"] * batch
    warm = optim_cfg.get("WARMUP_EPOCH", 1) * iters_per_epoch
    total = optim_cfg["NUM_EPOCHS"] * iters_per_epoch
    lo = 1e-5
    if step < warm:
        f = (1 - lo) * step / max(warm, 1) + lo
    else:
        f = (1 - lo) * 0.5 * (1 + math.cos(math.pi * (step - warm) / total)) + lo
    return base * f


def train_steps(p0: Dict[str, torch.Tensor], geos: List[G.Geometry],
                model_cfg, optim_cfg, batch: int, iters_per_epoch: int,
                quant: Quant = None, dtype=torch.float32):
    """SGD steps from parameters `p0`, one a batch of `geos` ->
    (losses, the clipped gradients of step 1, the parameters after the
    last step), all in `dtype` (float32; float64 for the tests' exact
    reading)."""
    if optim_cfg["OPTIMIZER"] != "sgd":
        raise NotImplementedError(optim_cfg["OPTIMIZER"])
    names = [n for n in p0 if not is_buffer(n)]
    p = {n: t.detach().to(dtype).clone() for n, t in p0.items()}
    for n in names:
        p[n].requires_grad_(True)
    mom, wd = optim_cfg["MOMENTUM"], optim_cfg["WEIGHT_DECAY"]
    nesterov = optim_cfg.get("NESTEROV", False)
    clip = optim_cfg.get("GRAD_NORM_CLIP")
    bufs, losses, grads1 = {}, [], None
    for step, geo in enumerate(geos):
        logits = Net(model_cfg, p, train=True, quant=quant)(geo)
        loss = seg_loss(logits, geo.labels, model_cfg)
        grads = torch.autograd.grad(loss, [p[n] for n in names])
        losses.append(float(loss.detach()))
        del logits, loss
        total = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        if clip:
            coef = (float(clip) / (total + 1e-6)).clamp(max=1.0)
            grads = [g * coef for g in grads]
        if step == 0:
            grads1 = {n: g.detach().clone() for n, g in zip(names, grads)}
        lr = lr_at(step, optim_cfg, batch, iters_per_epoch)
        with torch.no_grad():
            for n, g in zip(names, grads):
                d = g + wd * p[n] if wd else g
                if n in bufs:
                    bufs[n].mul_(mom).add_(d)
                else:
                    bufs[n] = d.clone()
                d = d + mom * bufs[n] if nesterov else bufs[n]
                p[n].sub_(lr * d)
        del grads
    return losses, grads1, {n: p[n].detach() for n in names}


@torch.no_grad()
def eval_logits(p: Dict[str, torch.Tensor], geo: G.Geometry,
                model_cfg, quant: Quant = None) -> torch.Tensor:
    """[N0, num_class] logits of the level-0 voxels, running-statistics BN."""
    return Net(model_cfg, p, train=False, quant=quant)(geo)
