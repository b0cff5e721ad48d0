"""Load JAX (flax) MinkUNet, SPVCNN, RPVNet, Cylinder_TS and range-model
(CENet, FIDNet, RangeNet, SalsaNext) variables into the port's models.

``jax_params_to_torch(params, batch_stats, model)`` takes the numpy pytrees
(nested dicts) of ``TrainState.params`` / ``.batch_stats`` and fills every
parameter and buffer of an ``openpcseg_torch.models.MinkUNet``, ``SPVCNN``,
``RPVNet``, ``Cylinder_TS``, ``CENet``, ``FIDNet``, ``RangeNet`` or
``SalsaNext``:

- a conv ``kernel`` [K*Cin, Cout] becomes the weight [K, Cin, Cout] in
  ``kernel_offsets`` order (layers.py:104-105); 1x1 kernels stay [Cin, Cout];
- flax auto-names modules per class in creation order (BasicConvBlock_i,
  ResidualBlock_i, SparseConv_i, MaskedBatchNorm_i, StackedBlocks_i and
  SPVCNN's PointTransform_i; RPVNet's RPVResContext_i, RPVResBlock_i and
  RPVUpBlock_i; Cylinder3D's Dense_i, ResContextBlock_0,
  CylResBlock_i, CylUpBlock_i, ReconBlock_0 and their ConvActBN_j /
  AsymSubmConv_j), which the walks below reproduce; a Dense ``kernel``
  [Cin, Cout] is the Linear weight transposed, a conv ``bias`` the
  SparseConv's;
- blocks 2..n of a stage with n >= 3 live in ``StackedBlocks_j`` with every
  leaf stacked on axis 0 (layers.py:347-356) and are unstacked here; a
  Bottleneck stage's are ``Bottleneck_i`` unrolled and
  ``StackedBlocks_j/Scan_ScanBody_0/Bottleneck_0`` scanned;
- a range model's (and RPVNet's range branch's) 2-D conv kernel [kh, kw,
  Cin, Cout] (HWIO) becomes the
  weight [Cout, Cin, kh, kw] (OIHW); RangeNet's transposed conv kernel
  [1, 4, Cin, Cout] becomes [Cin, Cout, 1, 4] flipped along both spatial
  axes (flax's ``ConvTranspose`` does not flip its kernel, torch's
  transposed conv is the adjoint of a correlation, which does); BN scale,
  bias, mean and var carry across.

It raises if any flax leaf goes unused or any torch tensor stays unfilled.
Plain numpy + torch: the caller converts jax arrays with ``np.asarray``.

``jax_state_to_torch`` carries a whole JAX training state (weights, BN
statistics, optax's moments, the step, EQLv2's loss state) into the
checkpoint payload of the port's Trainer, the moments through the same
walk as their parameters.
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
    """The walk's state. With a `sink` dict, `put` keeps each value there
    under its tensor's id and leaves the model as it is."""

    def __init__(self, params, batch_stats, model, sink=None):
        self.sink = sink
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
        if self.sink is not None:
            self.sink[id(t)] = v.to(t.device)
        else:
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

    def bottleneck(self, blk, path: Path, stack=None) -> None:
        """layers.py Bottleneck: SparseConv_0 / MaskedBatchNorm_0 the
        first 1x1, _1 the 3^3 conv, _2 the expanding 1x1, _3 the
        shortcut's, where there is one."""
        for j, (conv, bn) in enumerate(((blk.conv1, blk.bn1),
                                        (blk.conv2, blk.bn2),
                                        (blk.conv3, blk.bn3))):
            self.conv(conv, path + (f"SparseConv_{j}",), stack)
            self.bn(bn, path + (f"MaskedBatchNorm_{j}",), stack)
        if blk.shortcut is not None:
            self.conv(blk.shortcut, path + ("SparseConv_3",), stack)
            self.bn(blk.bn_sc, path + ("MaskedBatchNorm_3",), stack)

    def blocks(self, blocks, scan_blocks: bool) -> None:
        """repeated_blocks: first unrolled; the rest unrolled when there is
        one of them (or scanning is off), else one StackedBlocks, whose
        _ScanBody holds the stacked block as `<class>_0`. flax names a
        ResidualBlock `ResidualBlock_i`, a Bottleneck `Bottleneck_i`."""
        cls = ("Bottleneck" if type(blocks[0]).__name__ == "Bottleneck"
               else "ResidualBlock")
        walk = self.bottleneck if cls == "Bottleneck" else self.residual
        walk(blocks[0], (self.next(cls),))
        rest = list(blocks)[1:]
        if len(rest) == 1 or (rest and not scan_blocks):
            for b in rest:
                walk(b, (self.next(cls),))
        elif rest:
            base = (self.next("StackedBlocks"), "Scan_ScanBody_0",
                    f"{cls}_0")
            depth = self.take("params", base + ("SparseConv_0", "kernel"),
                              None).shape[0]
            if depth != len(rest):
                raise ValueError(f"{base[0]} stacks {depth} blocks, the "
                                 f"torch stage has {len(rest)}")
            for j, b in enumerate(rest):
                walk(b, base, stack=j)


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


    # ----------------------------------------------- dense range models --

    def conv2d(self, conv, path: Path) -> None:
        w = self.take("params", path + ("kernel",), None)
        self.put(conv.weight, w.transpose(3, 2, 0, 1))
        if conv.bias is not None:
            self.put(conv.bias, self.take("params", path + ("bias",), None))

    def conv_transpose2d(self, conv, path: Path) -> None:
        w = self.take("params", path + ("kernel",), None)
        self.put(conv.weight, w[::-1, ::-1].transpose(2, 3, 0, 1))
        self.put(conv.bias, self.take("params", path + ("bias",), None))

    def convs_bns(self, pairs, path: Path = ()) -> None:
        """(conv, bn or None) pairs in flax's creation order, named
        Conv_i / ConvTranspose_i and BatchNorm_j under `path`."""
        counters = defaultdict(int)

        def name(cls):
            i = counters[cls]
            counters[cls] += 1
            return path + (f"{cls}_{i}",)
        for conv, bn in pairs:
            if conv is not None:
                if type(conv).__name__ == "ConvTranspose2d":
                    self.conv_transpose2d(conv, name("ConvTranspose"))
                else:
                    self.conv2d(conv, name("Conv"))
            if bn is not None:
                self.bn(bn, name("BatchNorm"))

    def basic_block(self, blk, path: Path) -> None:
        pairs = [(blk.conv1, blk.bn1), (blk.conv2, blk.bn2)]
        if blk.downsample is not None:
            pairs.append((blk.downsample[0], blk.downsample[1]))
        self.convs_bns(pairs, path)

    def cenet(self, model) -> None:
        for blk in model.stem:
            self.convs_bns([(blk.conv, blk.bn)], (self.next("BasicConv2d"),))
        for stage in model.stages:
            for blk in stage:
                self.basic_block(blk, (self.next("BasicBlock"),))
        for blk in (model.conv_1, model.conv_2):
            self.convs_bns([(blk.conv, blk.bn)], (self.next("BasicConv2d"),))
        self.conv2d(model.semantic_output, ("semantic_output",))
        for i, head in enumerate(model.aux_heads):
            self.conv2d(head, (f"aux_head{i + 1}",))

    def fidnet(self, model) -> None:
        pairs = [(b.conv, b.bn) for b in model.stem]
        for stage in model.stages:
            for blk in stage:
                self.basic_block(blk, (self.next("BasicBlock"),))
        self.convs_bns(pairs + [(b.conv, b.bn) for b in model.head])
        self.conv2d(model.semantic_output, ("semantic_output",))

    def salsanext(self, model) -> None:
        bb = model.backbone
        root = ("SalsaNextBackbone_0",)
        for i, b in enumerate(bb.stem):
            self.convs_bns([(b.conv1, None), (b.conv2, b.bn1),
                            (b.conv3, b.bn2)],
                           root + (f"ResContextBlock_{i}",))
        for i, b in enumerate(bb.downs):
            self.convs_bns([(b.conv1, None), (b.conv2, b.bn1),
                            (b.conv3, b.bn2), (b.conv4, b.bn3),
                            (b.conv5, b.bn4)],
                           root + (f"SalsaResBlock_{i}",))
        for i, b in enumerate(bb.ups):
            self.convs_bns([(b.conv1, b.bn1), (b.conv2, b.bn2),
                            (b.conv3, b.bn3), (b.conv4, b.bn4)],
                           root + (f"SalsaUpBlock_{i}",))
        self.conv2d(model.logits, ("logits",))

    def rpvnet(self, model, scan_blocks: bool) -> None:
        """RPVNet.__call__'s creation order: the voxel stem, the range
        stem, the gate-0 point MLP, the voxel down stages, the range down
        blocks, then per gate the point MLP after two voxel up stages and
        two range up blocks; the classifier last."""
        pts = model.point_transforms
        for blk in model.stem:
            self.basic(blk, (self.next("BasicConvBlock"),))
        for b in model.range_stem:
            self.convs_bns([(b.conv1, None), (b.conv2, b.bn1),
                            (b.conv3, b.bn2)], (self.next("RPVResContext"),))
        self.point_transform(pts[0])
        for down, blocks in zip(model.downs, model.down_blocks):
            self.basic(down, (self.next("BasicConvBlock"),))
            self.blocks(blocks, scan_blocks)
        for b in model.range_downs:
            self.convs_bns([(b.conv1, None), (b.conv2, b.bn)],
                           (self.next("RPVResBlock"),))
        for gate in (1, 2):
            self.point_transform(pts[gate])
            for i in (2 * gate - 2, 2 * gate - 1):
                self.up(model, i, scan_blocks)
            for b in model.range_ups[2 * gate - 2:2 * gate]:
                self.convs_bns([(b.conv, b.bn)], (self.next("RPVUpBlock"),))
        self.point_transform(pts[3])
        self.dense(model.classifier, ("classifier",))

    def rangenet(self, model) -> None:
        """Top-level convs, transposed convs and BNs share flax's
        per-class counters across the encoder and decoder."""
        pairs = [(model.stem.conv, model.stem.bn)]
        for stage in list(model.encoder) + list(model.decoder):
            pairs.append((stage[0].conv, stage[0].bn))
            for blk in list(stage)[1:]:
                self.convs_bns([(blk.conv1, blk.bn1), (blk.conv2, blk.bn2)],
                               (self.next("DarkBasicBlock"),))
        self.convs_bns(pairs)
        self.conv2d(model.head, ("head",))


def _check(ld) -> None:
    unused = sorted("/".join(k) for k in set(ld.src) - ld.used)
    if unused:
        raise ValueError(f"flax variables left unused: {unused}")
    unfilled = sorted(n for i, n in ld.names.items() if i not in ld.filled)
    if unfilled:
        raise ValueError(f"torch tensors left unfilled: {unfilled}")


def _walk(ld, model, scan_blocks: bool) -> None:
    """Every variable of `model` in flax's creation order, then _check.
    For SPVCNN the point MLPs come after the down stages and after up
    stages 1 and 3."""
    if type(model).__name__ == "RPVNet":
        ld.rpvnet(model, scan_blocks)
        _check(ld)
        return
    walk = {"Cylinder_TS": ld.cylinder, "CENet": ld.cenet,
            "FIDNet": ld.fidnet, "SalsaNext": ld.salsanext,
            "RangeNet": ld.rangenet}.get(type(model).__name__)
    if walk is not None:
        walk(model)
        _check(ld)
        return
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


def jax_params_to_torch(params, batch_stats, model,
                        scan_blocks: bool = True):
    """Fill `model` (openpcseg_torch MinkUNet, SPVCNN, RPVNet, Cylinder_TS,
    CENet, FIDNet, RangeNet or SalsaNext) from flax variables; returns the
    model. scan_blocks=False matches OPENPCSEG_SCAN_BLOCKS=0 trees."""
    _walk(_Loader(params, batch_stats, model), model, scan_blocks)
    return model


def _moved(tree, batch_stats, model, scan_blocks: bool):
    """{parameter: tensor} of a tree shaped as flax's params (an optimizer
    moment), each leaf moved into its parameter's layout by the walk that
    fills the parameters: a reshape, a transpose, a flip or one slice of a
    stack only moves values, so the moments land exactly where their
    parameters do. The model is left as it was."""
    ld = _Loader(tree, batch_stats, model, sink={})
    _walk(ld, model, scan_blocks)
    return {p: ld.sink[id(p)] for p in model.parameters()}


def _state_tree(tree, like, path: str):
    """The numpy loss-state `tree` as tensors shaped and typed as `like`
    (the port's own loss state); a key or shape that differs raises and
    names its path."""
    if hasattr(like, "items"):
        if not hasattr(tree, "items") or set(tree) != set(like):
            raise ValueError(
                f"loss_state{path}: JAX holds "
                f"{sorted(tree) if hasattr(tree, 'items') else type(tree)}, "
                f"the port {sorted(like)}")
        return {k: _state_tree(tree[k], like[k], f"{path}/{k}")
                for k in like}
    v = torch.as_tensor(np.array(tree), dtype=like.dtype)
    if tuple(v.shape) != tuple(like.shape):
        raise ValueError(f"loss_state{path}: JAX shape {tuple(v.shape)} != "
                         f"the port's {tuple(like.shape)}")
    return v


def jax_state_to_torch(state, task, epoch: int, seed: int,
                       scan_blocks: bool = True) -> Dict[str, Any]:
    """A JAX run's training state as the checkpoint payload the port's
    ``Trainer.save_checkpoint`` writes and ``Trainer.restore`` /
    ``load_pretrained`` read: ``model``, ``optimizer`` (state dicts),
    ``step``, ``epoch``, ``generator`` and ``loss_state``.

    `state` holds numpy trees: ``params`` and ``batch_stats`` (flax's),
    ``step`` (int), ``loss_state`` (EQLv2's buffers, or {}) and ``opt``,
    the optax state as ``{"kind": "trace", "trace": tree}`` (sgd, sgd_fc)
    or ``{"kind": "adam", "count": int, "mu": tree, "nu": tree}`` (adam,
    adamw, adam_onecycle; tools/scripts/jax_ckpt_to_torch.py reads it
    from an orbax checkpoint). `task` is the port's ``SegTask`` of the same
    config: its model is filled (``jax_params_to_torch``) and its
    optimizer given, for every parameter by identity (sgd_fc keeps the
    classifier in a group of its own), optax's trace as SGD's
    ``momentum_buffer``, or mu, nu and count as Adam's / AdamW's
    ``exp_avg``, ``exp_avg_sq`` and ``step``; every buffer is set, at step
    0 too (torch makes them at the first step, optax's start at zeros).
    Any flax leaf left unused, tensor left unfilled or shape that differs
    raises and names it.

    ``generator`` is the run's `seed`, not a generator's state: JAX's
    PRNG key has no torch counterpart (dropout masks never matched bit for
    bit), so ``Trainer.restore`` seeds the task's generator with it on
    whatever device the task runs."""
    model, opt = task.model, task.optimizer
    if opt is None:
        raise ValueError("jax_state_to_torch needs a task with an OPTIM "
                         "block")
    jax_params_to_torch(state["params"], state["batch_stats"], model,
                        scan_blocks)
    o = state["opt"]
    sgd = isinstance(opt, torch.optim.SGD)
    if o["kind"] != ("trace" if sgd else "adam") or not (
            sgd or isinstance(opt, (torch.optim.Adam, torch.optim.AdamW))):
        raise ValueError(f"the JAX optimizer state is optax's {o['kind']}, "
                         f"the port's optimizer {type(opt).__name__}")
    moments = {k: _moved(o[k], state["batch_stats"], model, scan_blocks)
               for k in (("trace",) if sgd else ("mu", "nu"))}
    opt.state.clear()
    for group in opt.param_groups:
        for p in group["params"]:
            if sgd:
                opt.state[p] = {"momentum_buffer": moments["trace"][p]}
            else:
                opt.state[p] = {
                    "step": torch.tensor(float(o["count"]),
                                         dtype=torch.float32),
                    "exp_avg": moments["mu"][p],
                    "exp_avg_sq": moments["nu"][p]}
    return {"model": model.state_dict(), "optimizer": opt.state_dict(),
            "step": int(state["step"]), "epoch": int(epoch),
            "generator": int(seed),
            "loss_state": _state_tree(state.get("loss_state", {}),
                                      task.loss_state, "")}
