"""SegTask: the train / eval core for one (config, model) pair, voxel
modality.

Counterpart of ``openpcseg_tpu/engine/task.py`` (``default_caps``,
``preprocess``, ``train_step``, ``eval_step``, ``predict_step``), all on
`device`:

- one train step = voxelize + geometry pass + MinkUNet forward with
  batch-statistics BN + the configured losses (CE with label smoothing +
  Lovász-softmax) + backward through the kernels' backward passes +
  gradient clipping + the optimizer update at the scheduled lr;
- one eval step = the same forward with running-statistics BN + argmax
  re-projected to every point through the inverse map + confusion matrix.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..core.batch import voxelize_points_batch
from ..core.geometry import build_pyramid
from ..losses import Losses
from ..models import build_segmentor
from ..ops.coords import Keys
from ..optim import build_optimizer
from ..utils.metrics import confusion_matrix


def default_caps(voxel_cap0: int, num_levels: int,
                 ratios: Optional[Sequence[float]] = None) -> list:
    """Capacity per pyramid level, rounded up to multiples of 128."""
    if ratios is None:
        ratios = [1.0, 0.7, 0.38, 0.2, 0.11, 0.06, 0.03][:num_levels]
    caps = []
    for l in range(num_levels):
        r = ratios[l] if l < len(ratios) else ratios[-1] / (
            2 ** (l - len(ratios) + 1))
        c = max(256, int(voxel_cap0 * r))
        caps.append((c + 127) // 128 * 128)
    return caps


def batch_to_device(batch: Dict[str, np.ndarray],
                    device) -> Dict[str, torch.Tensor]:
    """numpy batch dict (data.raycast schema) -> tensors on `device`."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


class SegTask:
    """Model + geometry schedule + losses + optimizer + the step functions.

    cfgs is a plain dict with the yaml config's blocks (MODEL, DATA, the
    optional OPTIM block for training, and the optional TPU block for
    VOXEL_CAP_PER_SCAN / VOXEL_CAP_RATIOS); the caps hold
    `batch_per_device` scans, overflow shows in voxel_overflow. The model's
    weights are drawn from a torch.Generator seeded with `seed`, and so is
    dropout (a generator on `device`); load trained or converted weights
    into ``task.model`` afterwards. Without an OPTIM block the task only
    evaluates. The task runs on the card unless `device` says otherwise;
    without a card, a CUDA device raises here (the plain versions run only
    where the caller asks for the CPU)."""

    def __init__(self, cfgs: Dict[str, Any], num_class: int, *,
                 compute_dtype: torch.dtype = torch.float32,
                 device="cuda", voxel_cap_per_scan: Optional[int] = None,
                 seed: int = 0, batch_per_device: int = 1,
                 num_devices: int = 1, iters_per_epoch: int = 1000,
                 total_epochs: Optional[int] = None):
        self.cfgs = cfgs
        self.num_class = num_class
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"SegTask: device {self.device} asked for, but torch sees no "
                f"CUDA device (pass device='cpu' to run on the CPU)")
        self.compute_dtype = compute_dtype
        if cfgs.get("MODALITY", "voxel") != "voxel":
            raise NotImplementedError("only the voxel modality is ported")
        self.voxel_size = float(cfgs["DATA"]["VOXEL_SIZE"])
        model_cfg = cfgs["MODEL"]
        self.model = build_segmentor(model_cfg, num_class,
                                     compute_dtype=compute_dtype)
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(self.device).eval()
        spec = type(self.model).geometry_spec()
        self.devox_levels = spec["devox_levels"]
        tpu_cfg = cfgs.get("TPU", {})
        cap0 = voxel_cap_per_scan or tpu_cfg.get("VOXEL_CAP_PER_SCAN", 98304)
        self.caps = default_caps(cap0 * batch_per_device, spec["num_levels"],
                                 tpu_cfg.get("VOXEL_CAP_RATIOS", None))

        loss_cfg = model_cfg.get("LOSS_CONFIG", {}) or {}
        self.losses = Losses(
            loss_cfg.get("LOSS_TYPES", ["CELoss", "LovLoss"]),
            loss_cfg.get("LOSS_WEIGHTS", [1.0, 1.0]),
            ignore_index=model_cfg.get("IGNORE_LABEL", 0),
            label_smoothing=model_cfg.get("LABEL_SMOOTHING", 0.0))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.step = 0
        self.optimizer = self.lr_fn = None
        if "OPTIM" in cfgs:
            # LR linear scaling rule (reference train.py:251)
            self.optim_cfg = dict(cfgs["OPTIM"])
            self.optim_cfg.setdefault(
                "LR", self.optim_cfg["LR_PER_SAMPLE"] * batch_per_device
                * num_devices)
            total_epochs = total_epochs or self.optim_cfg.get(
                "NUM_EPOCHS", 36)
            self.optimizer, self.lr_fn = build_optimizer(
                self.optim_cfg, self.model.parameters(), iters_per_epoch,
                total_epochs)

    def preprocess(self, batch: Dict[str, torch.Tensor]):
        """Voxelize + geometry pass -> (VoxelBatch, VoxelPyramid)."""
        vb = voxelize_points_batch(
            batch["xyz"], batch["feats"], batch["labels"], batch["valid"],
            voxel_size=self.voxel_size, voxel_cap=self.caps[0])
        pyr = build_pyramid(
            vb.voxel_coords, vb.voxel_valid, self.caps,
            level0_keys=Keys(vb.voxel_keys_hi, vb.voxel_keys_lo),
            devox_levels=self.devox_levels)
        return vb, pyr

    def voxel_overflow(self, vb, pyr) -> torch.Tensor:
        """Voxels dropped over ALL pyramid levels; level 0 counts against
        the pre-dedup true count (task.py:377-380)."""
        caps = torch.as_tensor(self.caps, device=pyr.level_counts.device)
        lvl = (pyr.level_counts - caps).clamp(min=0).sum()
        return (vb.num_voxels - self.caps[0]).clamp(min=0) + lvl

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """One optimizer step on `batch` -> {loss, lr, num_voxels,
        voxel_overflow, grad_norm} (device tensors, except the float lr).
        The clipped gradients stay in each parameter's ``.grad``."""
        if self.optimizer is None:
            raise RuntimeError("SegTask.train_step needs an OPTIM block")
        self.model.train()
        vb, pyr = self.preprocess(batch)
        self.optimizer.zero_grad(set_to_none=True)
        logits = self.model(vb.voxel_feats, pyr, generator=self.generator)
        loss = self.losses(logits, vb.voxel_labels, vb.voxel_valid)
        loss.backward()
        params = [p for p in self.model.parameters() if p.grad is not None]
        clip = self.optim_cfg.get("GRAD_NORM_CLIP", None)
        grad_norm = torch.nn.utils.clip_grad_norm_(
            params, float(clip) if clip else float("inf"))
        lr = self.lr_fn(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        return {"loss": loss.detach(), "lr": lr,
                "num_voxels": vb.num_voxels,
                "voxel_overflow": self.voxel_overflow(vb, pyr),
                "grad_norm": grad_norm.detach()}

    @torch.no_grad()
    def forward(self, batch: Dict[str, torch.Tensor]):
        """Eval forward (running-statistics BN) -> (VoxelBatch,
        VoxelPyramid, voxel logits [V, num_class] f32)."""
        self.model.eval()
        vb, pyr = self.preprocess(batch)
        return vb, pyr, self.model(vb.voxel_feats, pyr)

    def _point_pred(self, vb, logits) -> torch.Tensor:
        voxel_pred = logits.argmax(dim=-1).to(torch.int32)
        inv = vb.inverse_map
        return torch.where(inv >= 0, voxel_pred[inv.clamp(min=0).long()],
                           torch.zeros_like(inv))

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """Forward + point re-projection + confusion matrix."""
        vb, pyr, logits = self.forward(batch)
        hist = confusion_matrix(self._point_pred(vb, logits),
                                vb.point_labels, vb.point_valid,
                                self.num_class)
        return {"hist": hist, "voxel_overflow": self.voxel_overflow(vb, pyr),
                "level_counts": pyr.level_counts}

    @torch.no_grad()
    def predict_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Per-point predictions [B, Np] int32."""
        vb, _, logits = self.forward(batch)
        return self._point_pred(vb, logits).reshape(batch["xyz"].shape[0], -1)
