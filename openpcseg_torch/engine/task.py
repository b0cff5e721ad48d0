"""SegTask: the train / eval core for one (config, model) pair: the voxel
and fusion modalities of the voxel-input segmentors (MinkUNet, SPVCNN;
RPVNet, whose fusion input adds the batch's range image, and whose range
tables the geometry pass builds from each voxel's pxpy),
the cylinder modality of the point-input Cylinder3D and the range
modality of the dense range-image CNNs (CENet, FIDNet, RangeNet,
SalsaNext).

Counterpart of ``openpcseg_tpu/engine/task.py`` (``default_caps``,
``preprocess``, ``train_step``, ``eval_step``, ``predict_step``,
``predict_probs_step``), all on `device`:

- one train step = voxelize (or the cylindrical partition) + geometry
  pass + the model's forward with batch-statistics BN + the configured
  losses (any of ``losses.KNOWN``, by default CE with label smoothing +
  Lovász-softmax; plus Cylinder3D's point-refinement CE) + backward
  through the kernels' backward passes + gradient clipping + the
  optimizer update at the scheduled lr (each param group's: sgd_fc's
  classifier at 10x);
- one eval step = the same forward with running-statistics BN + argmax
  re-projected to every point through the inverse map + confusion matrix.

A stateful loss (EQLv2) keeps its buffers in ``loss_state``, device
tensors the train step replaces. MODEL.EXTEND_HEAD_FOR_GROUPS widens a
voxel model's head to the extended GroupSoftmax layout; the class scores
of every argmax and softmax are then ``group_softmax_activation``'s
(``class_scores``), and the histograms stay over num_class.

A range step runs the model on the batch's range image [B, H, W, 6]
(float32, the model's aux heads in training) with the range losses of the
MODEL block (``losses/range_losses.py``); its eval re-projects the pixel
argmax to the batch's points (``p_*``), KNN-refined unless
MODEL.KNN_POST is off, or counts pixels where the batch has no points;
MODEL.POST_CRF first refines the pixel softmax with the locally
connected CRF (``ops/range_postproc.py``) and takes the argmax of its
log.

Data parallel (``group``, JAX's ``axis_name``): each rank steps on its own
slice of the global batch; the model's MaskedBatchNorms sum their
statistics over the ranks, the gradients are averaged before the clip,
the loss is averaged and num_voxels / voxel_overflow are summed, rank 0's
buffers are taken after each step, and the eval histograms are summed
(``parallel/ddp.py``). Without a group no collective runs.

Each step marks its phases with ``utils/spans.py``'s spans (recorded only
inside ``spans.recording()``): the step's own span (``train_step``,
``eval_step``, ``predict_step``, ``predict_probs_step``) holds
``preprocess`` (``voxelize``, ``geometry``), ``forward``, ``loss``,
``backward``, ``update`` (``allreduce`` with a group) and
``postprocess``; ``batch_to_device`` is ``to_device``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..core.batch import cylinder_points_batch, voxelize_points_batch
from ..core.geometry import build_pyramid
from ..data import dataset_meta
from ..losses import Losses
from ..losses.ce import cross_entropy
from ..losses.longtail import (group_softmax_activation,
                               group_softmax_channel_num)
from ..models import build_segmentor
from ..ops.coords import Keys
from ..optim import build_optimizer, set_step
from ..parallel import ddp
from ..utils.metrics import confusion_matrix
from ..utils.spans import span


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
    with span("to_device"):
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
    where the caller asks for the CPU). `model` shares an existing model
    (its weights, not a copy) instead of drawing one, as test-time
    augmentation's task of its own does. `group` is a process group to
    train and evaluate data-parallel over; `num_devices` its size."""

    def __init__(self, cfgs: Dict[str, Any], num_class: int, *,
                 compute_dtype: torch.dtype = torch.float32,
                 device="cuda", voxel_cap_per_scan: Optional[int] = None,
                 seed: int = 0, batch_per_device: int = 1,
                 num_devices: int = 1, iters_per_epoch: int = 1000,
                 total_epochs: Optional[int] = None,
                 model: Optional[torch.nn.Module] = None, group=None):
        self.cfgs = cfgs
        self.num_class = num_class
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"SegTask: device {self.device} asked for, but torch sees no "
                f"CUDA device (pass device='cpu' to run on the CPU)")
        modality = cfgs.get("MODALITY", "voxel")
        self.modality = modality
        self.is_range = modality == "range"
        # the range models compute in float32 whatever `compute_dtype`, as
        # the JAX modules do
        self.compute_dtype = torch.float32 if self.is_range else compute_dtype
        data = cfgs["DATA"]
        model_cfg = cfgs["MODEL"]
        if modality == "cylinder":
            self.cylinder = dict(
                space_min=tuple(data["CYLINDER_SPACE_MIN"]),
                space_max=tuple(data["CYLINDER_SPACE_MAX"]),
                grid_size=tuple(data["CYLINDER_GRID_SIZE"]))
        elif not self.is_range:
            self.voxel_size = float(data["VOXEL_SIZE"])
        # the extended GroupSoftmax head (JAX task.py:95-108); metrics and
        # eval stay over num_class
        self.extended_group_head = bool(
            model_cfg.get("EXTEND_HEAD_FOR_GROUPS", False))
        self.group_version = model_cfg.get("GROUP_VERSION", "bgfg")
        head_out = num_class
        if self.extended_group_head:
            if self.is_range:
                raise ValueError("EXTEND_HEAD_FOR_GROUPS supports the "
                                 "sparse segmentors only")
            head_out = group_softmax_channel_num(num_class,
                                                 self.group_version)
        if model is None:
            model = build_segmentor(model_cfg, head_out,
                                    compute_dtype=compute_dtype)
            model.reset_parameters(torch.Generator().manual_seed(seed))
            model.to(self.device).eval()
        self.model = model
        self.group = group
        if group is not None:
            ddp.sync_batchnorm(model, group)
        if self.is_range:
            crf = model_cfg.get("POST_CRF", None)
            kw = crf if isinstance(crf, dict) else {}
            self.crf = dict(
                iters=int(kw.get("ITER", 3)), lcn_h=int(kw.get("LCN_H", 3)),
                lcn_w=int(kw.get("LCN_W", 5)),
                xyz_coef=float(kw.get("XYZ_COEF", 0.1)),
                xyz_sigma=float(kw.get("XYZ_SIGMA", 0.7))) if crf else None
            # the loss knobs of the MODEL block (JAX task.py:128-137)
            self.range_loss_kwargs = dict(
                loss_kind=model_cfg.get("LOSS", "wce"),
                top_k_percent=float(model_cfg.get("TOP_K_PERCENT_PIXELS",
                                                  1.0)),
                if_ls=bool(model_cfg.get("IF_LS_LOSS", True)),
                if_bd=bool(model_cfg.get("IF_BD_LOSS", True)),
                ignore_index=model_cfg.get("IGNORE_LABEL", 0))
            knn = model_cfg.get("KNN_POST", True)
            kw = knn if isinstance(knn, dict) else {}
            self.knn = dict(k=int(kw.get("K", 5)),
                            search=int(kw.get("SEARCH", 5)),
                            cutoff=float(kw.get("CUTOFF", 1.0))) if knn \
                else None
        else:
            spec = type(self.model).geometry_spec()
            self.geometry = {k: v for k, v in spec.items()
                             if k != "num_levels"}
            mode = getattr(type(self.model), "INPUT_MODE", "voxel")
            self.point_input = mode == "point"
            self.fusion_input = mode == "fusion"
            tpu_cfg = cfgs.get("TPU", {})
            cap0 = voxel_cap_per_scan or tpu_cfg.get("VOXEL_CAP_PER_SCAN",
                                                     98304)
            self.caps = default_caps(cap0 * batch_per_device,
                                     spec["num_levels"],
                                     tpu_cfg.get("VOXEL_CAP_RATIOS", None))

        # class names and counts from the dataset (JAX task.py:144-165)
        loss_cfg = model_cfg.get("LOSS_CONFIG", {}) or {}
        names, num_pts = dataset_meta(data.get("DATASET", "semantickitti"))
        self.losses = Losses(
            loss_cfg.get("LOSS_TYPES", ["CELoss", "LovLoss"]),
            loss_cfg.get("LOSS_WEIGHTS", [1.0, 1.0]),
            cls_num_pts=num_pts, class_names=names, num_class=num_class,
            ignore_index=model_cfg.get("IGNORE_LABEL", 0),
            label_smoothing=model_cfg.get("LABEL_SMOOTHING", 0.0),
            extended_group_head=self.extended_group_head,
            group_version=self.group_version, group=group)
        if self.losses.stateful and self.extended_group_head:
            # JAX sizes EQLv2's buffers by num_class and its logits by the
            # head, and fails at its first step on the mismatch
            raise ValueError("EQLv2 takes the num_class-wide head: it "
                             "cannot run with EXTEND_HEAD_FOR_GROUPS")
        self.loss_state = self.losses.init_state(num_class, self.device)
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
                self.optim_cfg, self.model.named_parameters(),
                iters_per_epoch, total_epochs)

    def preprocess(self, batch: Dict[str, torch.Tensor]):
        """Voxelize (or partition the cylinder) + geometry pass ->
        (VoxelBatch, VoxelPyramid); for a fusion-input model also the
        range tables of each resolution its gates use
        (``VoxelPyramid.range``), from each voxel's pxpy."""
        with span("preprocess"):
            with span("voxelize"):
                if self.modality == "cylinder":
                    vb = cylinder_points_batch(
                        batch["xyz"], batch["feats"][..., 3:],
                        batch["labels"], batch["valid"],
                        voxel_cap=self.caps[0], num_class=self.num_class,
                        **self.cylinder)
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
            with span("geometry"):
                pyr = build_pyramid(
                    vb.voxel_coords, vb.voxel_valid, self.caps,
                    level0_keys=Keys(vb.voxel_keys_hi, vb.voxel_keys_lo),
                    **self.geometry, **points)
                if self.fusion_input:
                    from ..ops.range_fusion import range_tables
                    b, h, w, _ = batch["range_image"].shape
                    pyr.range = range_tables(
                        self.voxel_pxpy(vb, batch), pyr.points.batch,
                        pyr.points.valid, b, h, w, self.model.RANGE_SCALES)
        return vb, pyr

    @staticmethod
    def voxel_pxpy(vb, batch) -> torch.Tensor:
        """Each voxel's pxpy [V, 2]: its representative (first) point's,
        0 on padding rows (JAX ``_model_inputs``)."""
        flat = batch["pxpy"].reshape(-1, 2)
        rep = flat[vb.voxel_rep.clamp(min=0).long()]
        return torch.where(vb.voxel_valid[:, None], rep, 0.0)

    def _run_model(self, vb, pyr, batch=None, **kw):
        """The model's outputs on its input (the points' features for a
        point-input model; for a fusion-input one the voxels' features
        and the batch's range image, the range tables in `pyr`; else the
        voxels' features): (voxel logits, aux dict)."""
        if self.fusion_input:
            x = {"voxel_feats": vb.voxel_feats,
                 "range_image": batch["range_image"]}
        else:
            x = vb.point_feats if self.point_input else vb.voxel_feats
        with span("forward"):
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
        with span("train_step"):
            self.model.train()
            if self.is_range:
                return self._range_train_step(batch)
            return self._voxel_train_step(batch)

    def _voxel_train_step(self, batch: Dict[str, torch.Tensor]):
        """The step of a voxel-, point- or fusion-input model: the geometry
        pass, the model, the configured losses, clip and update."""
        vb, pyr = self.preprocess(batch)
        self.optimizer.zero_grad(set_to_none=True)
        logits, aux = self._run_model(vb, pyr, batch,
                                      generator=self.generator)
        with span("loss"):
            loss = self.losses(logits, vb.voxel_labels, vb.voxel_valid,
                               state=self.loss_state if self.losses.stateful
                               else None, generator=self.generator)
            if self.losses.stateful:     # JAX task.py:341, :360-394
                loss, self.loss_state = loss
            if "point_refine_logits" in aux:
                # Cylinder3D's auxiliary point-refinement CE (JAX
                # _loss_from_outputs)
                loss = loss + cross_entropy(
                    aux["point_refine_logits"], vb.point_labels,
                    vb.point_valid, ignore_index=self.losses.ignore_index,
                    label_smoothing=self.losses.label_smoothing)
        lr, grad_norm = self._update(loss)
        return self._reduced({"loss": loss.detach(), "lr": lr,
                              "num_voxels": vb.num_voxels,
                              "voxel_overflow": self.voxel_overflow(vb, pyr),
                              "grad_norm": grad_norm})

    def _reduced(self, metrics):
        """A train step's metrics over the ranks (JAX task.py:383-385)."""
        if self.group is None:
            return metrics
        return ddp.reduce_train_metrics(metrics, self.group)

    def _update(self, loss: torch.Tensor):
        """Backward, the gradients' mean over the ranks, clip, the optimizer
        step at the scheduled lr and rank 0's buffers -> (lr, the gradient
        norm before clipping)."""
        with span("backward"):
            loss.backward()
        with span("update"):
            if self.group is not None:      # JAX task.py:381-382, :424
                with span("allreduce"):
                    ddp.average_gradients(self.model.parameters(), self.group)
            params = [p for p in self.model.parameters()
                      if p.grad is not None]
            clip = self.optim_cfg.get("GRAD_NORM_CLIP", None)
            grad_norm = torch.nn.utils.clip_grad_norm_(
                params, float(clip) if clip else float("inf"))
            lr = set_step(self.optimizer, self.lr_fn, self.step)
            self.optimizer.step()
            if self.group is not None:
                ddp.broadcast_buffers(self.model, self.group)
        self.step += 1
        return lr, grad_norm.detach()

    def _range_train_step(self, batch: Dict[str, torch.Tensor]):
        """JAX ``_range_train_step``: the model with its aux heads, the
        range losses, clip and update; no voxels, so 0 voxels and 0
        overflow."""
        from ..losses.range_losses import range_seg_loss

        self.optimizer.zero_grad(set_to_none=True)
        with span("forward"):
            logits, aux = self.model(batch["scan"], generator=self.generator)
        with span("loss"):
            loss = range_seg_loss(logits, aux, batch["label"],
                                  **self.range_loss_kwargs)
        lr, grad_norm = self._update(loss)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        return self._reduced({"loss": loss.detach(), "lr": lr,
                              "num_voxels": zero, "voxel_overflow": zero,
                              "grad_norm": grad_norm})

    @torch.no_grad()
    def range_logits(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Eval forward of a range model -> logits [B, num_class, H, W]."""
        self.model.eval()
        with span("forward"):
            return self.model(batch["scan"])[0]

    def crf_logits(self, batch: Dict[str, torch.Tensor],
                   logits: torch.Tensor) -> torch.Tensor:
        """MODEL.POST_CRF (JAX task.py:505-525): the log of the CRF-refined
        softmax of range logits [B, C, H, W], over the scan's xyz scaled
        by (50, 50, 3) and its channel-5 mask."""
        from ..ops.range_postproc import crf_refine
        scan = batch["scan"]
        xyz = torch.cat([scan[..., :2] * 50.0, scan[..., 2:3] * 3.0], -1)
        sm = torch.softmax(logits.float(), dim=1).permute(0, 2, 3, 1)
        sm = crf_refine(xyz, sm, scan[..., 5] > 0.5, **self.crf)
        return torch.log(sm.clamp(min=1e-12)).permute(0, 3, 1, 2)

    @torch.no_grad()
    def _range_eval_step(self, batch: Dict[str, torch.Tensor]):
        """JAX ``_range_eval_step``: with the batch's points (``p_label``,
        ``p_px``, ``p_py``, ``p_range``, ``p_valid``), the pixel argmax
        re-projected to each point, KNN-refined unless MODEL.KNN_POST is
        off, and a per-point histogram; else a per-pixel one. With
        MODEL.POST_CRF the argmax is the CRF-refined one's."""
        logits = self.range_logits(batch)
        with span("postprocess"):
            if self.crf is not None:
                logits = self.crf_logits(batch, logits)
            hist = self.range_hist(batch, logits)
        return self._summed(hist, torch.zeros((), dtype=torch.int64,
                                              device=self.device))

    def range_hist(self, batch: Dict[str, torch.Tensor],
                   logits: torch.Tensor) -> torch.Tensor:
        """This rank's confusion matrix of range logits [B, C, H, W]: per
        point (KNN-refined unless MODEL.KNN_POST is off) where the batch
        has its points, else per pixel."""
        pred_img = logits.argmax(1).to(torch.int32)
        if "p_label" not in batch:
            labels = batch["label"].reshape(-1)
            return confusion_matrix(
                pred_img.reshape(-1), labels,
                torch.ones_like(labels, dtype=torch.bool), self.num_class)
        if self.knn is not None:
            from ..ops.range_knn import knn_postprocess
            point_pred = knn_postprocess(
                batch["scan"][..., 4] * 80.0, pred_img, batch["p_range"],
                batch["p_px"], batch["p_py"], batch["p_valid"],
                num_class=self.num_class, **self.knn)
        else:
            w = pred_img.shape[-1]
            point_pred = pred_img.reshape(pred_img.shape[0], -1).gather(
                1, (batch["p_py"] * w + batch["p_px"]).long())
        return confusion_matrix(
            point_pred.reshape(-1), batch["p_label"].reshape(-1),
            batch["p_valid"].reshape(-1), self.num_class)

    def _summed(self, hist, overflow, **extra):
        """An eval step's histogram and voxel overflow, summed over the
        ranks (JAX task.py:564, :592) in one reduce."""
        if self.group is not None:
            n = hist.numel()
            tot = ddp.all_reduce_sum(torch.cat(
                [hist.reshape(-1), overflow.reshape(1).to(hist.dtype)]),
                self.group)
            hist, overflow = tot[:n].view_as(hist), tot[n]
        return {"hist": hist, "voxel_overflow": overflow, **extra}

    @torch.no_grad()
    def forward(self, batch: Dict[str, torch.Tensor]):
        """Eval forward (running-statistics BN) -> (VoxelBatch,
        VoxelPyramid, voxel logits [V, head width] f32: num_class, or the
        extended head's)."""
        self.model.eval()
        vb, pyr = self.preprocess(batch)
        return vb, pyr, self._run_model(vb, pyr, batch)[0]

    def class_scores(self, logits: torch.Tensor) -> torch.Tensor:
        """Head logits -> per-class scores for argmax and softmax: the
        logits, or an extended head's group-softmax activation (JAX
        ``_class_scores``, task.py:303-315)."""
        if not self.extended_group_head:
            return logits
        return group_softmax_activation(
            logits, num_class=self.num_class,
            class_names=self.losses.class_names, version=self.group_version)

    def _point_pred(self, vb, logits) -> torch.Tensor:
        voxel_pred = self.class_scores(logits).argmax(dim=-1).to(torch.int32)
        inv = vb.inverse_map
        return torch.where(inv >= 0, voxel_pred[inv.clamp(min=0).long()],
                           torch.zeros_like(inv))

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """Forward + point re-projection + confusion matrix."""
        with span("eval_step"):
            if self.is_range:
                return self._range_eval_step(batch)
            vb, pyr, logits = self.forward(batch)
            with span("postprocess"):
                hist = confusion_matrix(self._point_pred(vb, logits),
                                        vb.point_labels, vb.point_valid,
                                        self.num_class)
            return self._summed(hist, self.voxel_overflow(vb, pyr),
                                level_counts=pyr.level_counts)

    @torch.no_grad()
    def predict_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Per-point predictions [B, Np] int32 (a range model's: per pixel,
        [B, H, W])."""
        with span("predict_step"):
            if self.is_range:
                logits = self.range_logits(batch)
                with span("postprocess"):
                    return logits.argmax(1).to(torch.int32)
            vb, _, logits = self.forward(batch)
            with span("postprocess"):
                return self._point_pred(vb, logits).reshape(
                    batch["xyz"].shape[0], -1)

    @torch.no_grad()
    def predict_probs_step(self, batch: Dict[str, torch.Tensor]
                           ) -> torch.Tensor:
        """Per-point float32 softmax probabilities [B, Np, num_class] for
        test-time augmentation's vote (JAX ``predict_probs_step``,
        task.py:459-490): a voxel model's voxel probabilities gathered to
        the points through the inverse map (0 where a point has no voxel);
        a range model's pixel probabilities gathered at each vote's own
        ``p_py * W + p_px`` (0 where ``p_valid`` is False; no KNN)."""
        with span("predict_probs_step"):
            if self.is_range:
                logits = self.range_logits(batch)
                with span("postprocess"):
                    probs = torch.softmax(logits.float(), dim=1)
                    v, c, h, w = probs.shape
                    lin = (batch["p_py"] * w + batch["p_px"]).long()  # [V, N]
                    ppt = probs.reshape(v, c, h * w).gather(
                        2, lin[:, None, :].expand(v, c, lin.shape[1]))
                    return torch.where(batch["p_valid"][..., None],
                                       ppt.transpose(1, 2), 0.0)
            vb, _, logits = self.forward(batch)
            with span("postprocess"):
                probs = torch.softmax(self.class_scores(logits).float(),
                                      dim=-1)
                inv = vb.inverse_map
                point = torch.where((inv >= 0)[:, None],
                                    probs[inv.clamp(min=0).long()], 0.0)
                return point.reshape(batch["xyz"].shape[0], -1,
                                     self.num_class)
