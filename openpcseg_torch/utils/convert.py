"""Load JAX (flax) MinkUNet, SPVCNN and Cylinder_TS variables into the
port's models.

``jax_params_to_torch(params, batch_stats, model)`` takes the numpy pytrees
(nested dicts) of ``TrainState.params`` / ``.batch_stats`` and fills every
parameter and buffer of an ``openpcseg_torch.models.MinkUNet``, ``SPVCNN``
or ``Cylinder_TS``:

- a conv ``kernel`` [K*Cin, Cout] becomes the weight [K, Cin, Cout] in
  ``kernel_offsets`` order (layers.py:104-105); 1x1 kernels stay [Cin, Cout];
- flax auto-names modules per class in creation order (BasicConvBlock_i,
  ResidualBlock_i, SparseConv_i, MaskedBatchNorm_i, StackedBlocks_i and
  SPVCNN's PointTransform_i; Cylinder3D's Dense_i, ResContextBlock_0,
  CylResBlock_i, CylUpBlock_i, ReconBlock_0 and their ConvActBN_j /
  AsymSubmConv_j), which the walks below reproduce; a Dense ``kernel``
  [Cin, Cout] is the Linear weight transposed, a conv ``bias`` the
  SparseConv's;
- blocks 2..n of a stage with n >= 3 live in ``StackedBlocks_j`` with every
  leaf stacked on axis 0 (layers.py:347-356) and are unstacked here.

It raises if any flax leaf goes unused or any torch tensor stays unfilled.
Plain numpy + torch: the caller converts jax arrays with ``np.asarray``.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]


def _flatten(tree: Dict[str, Any], prefix: Path = ()) -> Dict[Path, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):   # dict or FrozenDict
            out.update(_flatten(dict(v.items()), prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


class _Loader:
    def __init__(self, params, batch_stats, model):
        self.src = {("params",) + p: v for p, v in _flatten(params).items()}
        self.src.update({("batch_stats",) + p: v
                         for p, v in _flatten(batch_stats).items()})
        self.used = set()
        self.filled = set()
        self.names = {id(t): n for n, t in
                      list(model.named_parameters()) + list(model.named_buffers())}
        self.counters = defaultdict(int)

    def next(self, cls: str) -> str:
        i = self.counters[cls]
        self.counters[cls] += 1
        return f"{cls}_{i}"

    def take(self, col: str, path: Path, stack: int | None) -> np.ndarray:
        key = (col,) + path
        if key not in self.src:
            raise KeyError(f"flax variable {'/'.join(key)} not found")
        self.used.add(key)
        v = self.src[key]
        return v[stack] if stack is not None else v

    def put(self, t: torch.Tensor, value: np.ndarray) -> None:
        v = torch.as_tensor(np.array(value), dtype=t.dtype)
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"{self.names[id(t)]}: flax shape "
                             f"{tuple(v.shape)} != torch {tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(v)
        self.filled.add(id(t))

    def conv(self, conv, path: Path, stack=None) -> None:
        w = self.take("params", path + ("kernel",), stack)
        self.put(conv.weight, w.reshape(conv.weight.shape))
        if conv.bias is not None:
            self.put(conv.bias, self.take("params", path + ("bias",), stack))

    def bn(self, bn, path: Path, stack=None) -> None:
        self.put(bn.weight, self.take("params", path + ("scale",), stack))
        self.put(bn.bias, self.take("params", path + ("bias",), stack))
        self.put(bn.running_mean, self.take("batch_stats", path + ("mean",),
                                            stack))
        self.put(bn.running_var, self.take("batch_stats", path + ("var",),
                                           stack))

    def basic(self, blk, path: Path) -> None:
        self.conv(blk.conv, path + ("SparseConv_0",))
        self.bn(blk.bn, path + ("MaskedBatchNorm_0",))

    def residual(self, blk, path: Path, stack=None) -> None:
        self.conv(blk.conv1, path + ("SparseConv_0",), stack)
        self.bn(blk.bn1, path + ("MaskedBatchNorm_0",), stack)
        self.conv(blk.conv2, path + ("SparseConv_1",), stack)
        self.bn(blk.bn2, path + ("MaskedBatchNorm_1",), stack)
        if blk.shortcut is not None:
            self.conv(blk.shortcut, path + ("SparseConv_2",), stack)
            self.bn(blk.bn_sc, path + ("MaskedBatchNorm_2",), stack)

    def blocks(self, blocks, scan_blocks: bool) -> None:
        """repeated_blocks: first unrolled; the rest unrolled when there is
        one of them (or scanning is off), else one StackedBlocks."""
        self.residual(blocks[0], (self.next("ResidualBlock"),))
        rest = list(blocks)[1:]
        if len(rest) == 1 or (rest and not scan_blocks):
            for b in rest:
                self.residual(b, (self.next("ResidualBlock"),))
        elif rest:
            base = (self.next("StackedBlocks"), "Scan_ScanBody_0",
                    "ResidualBlock_0")
            depth = self.take("params", base + ("SparseConv_0", "kernel"),
                              None).shape[0]
            if depth != len(rest):
                raise ValueError(f"{base[0]} stacks {depth} blocks, the "
                                 f"torch stage has {len(rest)}")
            for j, b in enumerate(rest):
                self.residual(b, base, stack=j)


    def dense(self, linear, path: Path) -> None:
        self.put(linear.weight, self.take("params", path + ("kernel",),
                                          None).T)
        self.put(linear.bias, self.take("params", path + ("bias",), None))

    def point_transform(self, pt) -> None:
        path = (self.next("PointTransform"),)
        self.dense(pt.linear, path + ("Dense_0",))
        self.bn(pt.bn, path + ("MaskedBatchNorm_0",))

    def up(self, model, i: int, scan_blocks: bool) -> None:
        self.conv(model.ups[i], (self.next("SparseConv"),))
        self.bn(model.up_bns[i], (self.next("MaskedBatchNorm"),))
        self.blocks(model.up_blocks[i], scan_blocks)


    def conv_act_bn(self, blk, path: Path) -> None:
        self.conv(blk.conv.conv, path + ("AsymSubmConv_0", "SparseConv_0"))
        self.bn(blk.bn, path + ("MaskedBatchNorm_0",))

    def cylinder(self, model) -> None:
        """Cylinder_TS.__call__'s creation order: the point MLP (its BN on
        the raw features first), the 16-wide compression, the UNet blocks,
        the head, the refinement head."""
        self.bn(model.point_bns[0], (self.next("MaskedBatchNorm"),))
        for lin, bn in zip(model.point_linears[:3], model.point_bns[1:]):
            self.dense(lin, (self.next("Dense"),))
            self.bn(bn, (self.next("MaskedBatchNorm"),))
        self.dense(model.point_linears[3], (self.next("Dense"),))
        self.dense(model.compress, (self.next("Dense"),))
        path = (self.next("ResContextBlock"),)
        for j, blk in enumerate(model.context.convs):
            self.conv_act_bn(blk, path + (f"ConvActBN_{j}",))
        for down in model.downs:
            path = (self.next("CylResBlock"),)
            for j, blk in enumerate(down.convs):
                self.conv_act_bn(blk, path + (f"ConvActBN_{j}",))
            self.conv(down.pool, path + ("SparseConv_0",))
        for up in model.ups:
            path = (self.next("CylUpBlock"),)
            self.conv_act_bn(up.pre, path + ("ConvActBN_0",))
            self.conv(up.up, path + ("SparseConv_0",))
            for j, blk in enumerate(up.post, start=1):
                self.conv_act_bn(blk, path + (f"ConvActBN_{j}",))
        path = (self.next("ReconBlock"),)
        for j, (conv, bn) in enumerate(zip(model.recon.convs,
                                           model.recon.bns)):
            self.conv(conv.conv, path + (f"AsymSubmConv_{j}", "SparseConv_0"))
            self.bn(bn, path + (f"MaskedBatchNorm_{j}",))
        self.conv(model.head, (self.next("SparseConv"),))
        if model.point_refinement:
            self.dense(model.refine, (self.next("Dense"),))
            self.bn(model.refine_bn, (self.next("MaskedBatchNorm"),))
            self.dense(model.point_head, (self.next("Dense"),))


def _check(ld) -> None:
    unused = sorted("/".join(k) for k in set(ld.src) - ld.used)
    if unused:
        raise ValueError(f"flax variables left unused: {unused}")
    unfilled = sorted(n for i, n in ld.names.items() if i not in ld.filled)
    if unfilled:
        raise ValueError(f"torch tensors left unfilled: {unfilled}")


def jax_params_to_torch(params, batch_stats, model,
                        scan_blocks: bool = True):
    """Fill `model` (openpcseg_torch MinkUNet, SPVCNN or Cylinder_TS) from
    flax variables; returns the model. scan_blocks=False matches
    OPENPCSEG_SCAN_BLOCKS=0 trees. The walk is flax's creation order: for
    SPVCNN the point MLPs come after the down stages and after up stages
    1 and 3."""
    ld = _Loader(params, batch_stats, model)
    if type(model).__name__ == "Cylinder_TS":
        ld.cylinder(model)
        _check(ld)
        return model
    pts = list(getattr(model, "point_transforms", ()))
    for blk in model.stem:
        ld.basic(blk, (ld.next("BasicConvBlock"),))
    for down, blocks in zip(model.downs, model.down_blocks):
        ld.basic(down, (ld.next("BasicConvBlock"),))
        ld.blocks(blocks, scan_blocks)
    for i in range(len(model.ups)):
        if pts and i in (0, 2):
            ld.point_transform(pts[i // 2])
        ld.up(model, i, scan_blocks)
    if pts:
        ld.point_transform(pts[2])
    ld.dense(model.classifier, ("classifier",))
    _check(ld)
    return model
