"""SegTask: the train / eval core for one (config, model) pair: the voxel
and fusion modalities of the voxel-input segmentors (MinkUNet, SPVCNN) and
the cylinder modality of the point-input Cylinder3D.

Counterpart of ``openpcseg_tpu/engine/task.py`` (``default_caps``,
``preprocess``, ``train_step``, ``eval_step``, ``predict_step``), all on
`device`:

- one train step = voxelize (or the cylindrical partition) + geometry
  pass + the model's forward with batch-statistics BN + the configured
  losses (CE with label smoothing + Lovász-softmax; plus Cylinder3D's
  point-refinement CE) + backward through the kernels' backward passes +
  gradient clipping + the optimizer update at the scheduled lr;
- one eval step = the same forward with running-statistics BN + argmax
  re-projected to every point through the inverse map + confusion matrix.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..core.batch import cylinder_points_batch, voxelize_points_batch
from ..core.geometry import build_pyramid
from ..losses import Losses
from ..losses.ce import cross_entropy
from ..models import build_segmentor
from ..ops.coords import Keys
from ..optim import build_optimizer
from ..utils.metrics import confusion_matrix


# the JAX package's other modality and the ROADMAP.md Queue 1 item that
# ports it; "fusion" runs here for the models whose input is the voxel
# features (SPVCNN; RPVNet, whose input also takes the range image, is
# item 13 and not in the registry)
_NOT_PORTED = {"range": 14}


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
        modality = cfgs.get("MODALITY", "voxel")
        if modality in _NOT_PORTED:
            raise NotImplementedError(
                f"the {modality} modality is not ported yet (ROADMAP.md "
                f"Queue 1 item {_NOT_PORTED[modality]})")
        self.modality = modality
        data = cfgs["DATA"]
        if modality == "cylinder":
            self.cylinder = dict(
                space_min=tuple(data["CYLINDER_SPACE_MIN"]),
                space_max=tuple(data["CYLINDER_SPACE_MAX"]),
                grid_size=tuple(data["CYLINDER_GRID_SIZE"]))
        else:
            self.voxel_size = float(data["VOXEL_SIZE"])
        model_cfg = cfgs["MODEL"]
        self.model = build_segmentor(model_cfg, num_class,
                                     compute_dtype=compute_dtype)
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(self.device).eval()
        spec = type(self.model).geometry_spec()
        self.geometry = {k: v for k, v in spec.items() if k != "num_levels"}
        self.point_input = getattr(type(self.model), "INPUT_MODE",
                                   "voxel") == "point"
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
        """Voxelize (or partition the cylinder) + geometry pass ->
        (VoxelBatch, VoxelPyramid)."""
        if self.modality == "cylinder":
            vb = cylinder_points_batch(
                batch["xyz"], batch["feats"][..., 3:], batch["labels"],
                batch["valid"], voxel_cap=self.caps[0],
                num_class=self.num_class, **self.cylinder)
            points = dict(point_coords=vb.point_grid,
                          point_batch=vb.point_batch.clamp(min=0),
                          point_valid=vb.point_valid,
                          point_to_voxel0=vb.inverse_map)
        else:
            vb = voxelize_points_batch(
                batch["xyz"], batch["feats"], batch["labels"],
                batch["valid"], voxel_size=self.voxel_size,
                voxel_cap=self.caps[0])
            points = {}
        pyr = build_pyramid(
            vb.voxel_coords, vb.voxel_valid, self.caps,
            level0_keys=Keys(vb.voxel_keys_hi, vb.voxel_keys_lo),
            **self.geometry, **points)
        return vb, pyr

    def _run_model(self, vb, pyr, **kw):
        """The model's outputs on its input (the points' features for a
        point-input model, else the voxels'): (voxel logits, aux dict)."""
        x = vb.point_feats if self.point_input else vb.voxel_feats
        out = self.model(x, pyr, **kw)
        return out if isinstance(out, tuple) else (out, {})

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
        logits, aux = self._run_model(vb, pyr, generator=self.generator)
        loss = self.losses(logits, vb.voxel_labels, vb.voxel_valid)
        if "point_refine_logits" in aux:
            # Cylinder3D's auxiliary point-refinement CE (JAX
            # _loss_from_outputs)
            loss = loss + cross_entropy(
                aux["point_refine_logits"], vb.point_labels, vb.point_valid,
                ignore_index=self.losses.ignore_index,
                label_smoothing=self.losses.label_smoothing)
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
        return vb, pyr, self._run_model(vb, pyr)[0]

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
