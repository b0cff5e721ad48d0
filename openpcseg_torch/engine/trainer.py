"""Trainer: the train / eval / checkpoint harness around SegTask.

Counterpart of ``openpcseg_tpu/engine/trainer.py``:

- the experiment tree ``<log_dir>/<EXP_GROUP_PATH>/<TAG>/<extra_tag>``
  with a log file, ``metrics.jsonl``, TensorBoard event files and ``ckp/``;
- per epoch: the train loader (resampled after the epoch), a checkpoint
  and an eval with the per-class IoU table and confusion matrix;
- checkpoints are one ``torch.save`` file per epoch, ``ckp/<epoch>.pt``,
  holding the model and optimizer ``state_dict``s, ``SegTask.step`` (so
  the LR schedule goes on where it stopped), the epoch and the dropout
  generator's state; the newest ``max_ckp_save_num`` files are kept, and a
  run without ``--ckp`` resumes from the latest epoch.

Host syncs: a step's outputs stay on the device and are read once per
``log_interval`` steps (one copy of every pending step's scalars), never
per step; an eval reads its histogram once, after the last batch.

The trainer runs on one card (``args.device``, default ``cuda``; it raises
without one unless the caller asks for the CPU). Data parallel training
and test-time augmentation are not ported yet (ROADMAP.md Queue 1 items 10
and 15) and raise.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import CfgDict, log_config_to_file
from ..data import build_dataloader, num_classes_for, rank_and_world
from ..data.semantickitti_meta import CLASS_NAMES
from ..utils.checkpoint import merge_matching
from ..utils.logger import AverageMeter, MetricsWriter, create_logger
from ..utils.metrics import crop_hist, miou_from_hist
from ..utils.reporting import confusion_table, iou_table
from ..utils.tb_writer import TBWriter
from .task import SegTask, batch_to_device

PROFILE_STEPS = (20, 25)   # --profile_dir traces these steps of an epoch


class Trainer:
    def __init__(self, args, cfgs: CfgDict):
        self.args = args
        self.cfgs = cfgs
        self.device = torch.device(getattr(args, "device", "cuda"))
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Trainer: device {self.device} asked for, but torch sees no "
                "CUDA device (--device cpu runs on the CPU)")
        if (getattr(args, "num_devices", 0) or 1) > 1:
            raise NotImplementedError(
                "--num_devices > 1: data parallel training is not ported yet "
                "(ROADMAP.md Queue 1 item 10)")
        self.log_interval = getattr(args, "log_interval", 50)
        self.profile_dir = getattr(args, "profile_dir", None)
        self._profiler = None

        root = Path(getattr(args, "log_dir", "logs"))
        self.exp_dir = root / cfgs.get("EXP_GROUP_PATH", "exp") / cfgs.get(
            "TAG", "default") / getattr(args, "extra_tag", "default")
        self.ckp_dir = self.exp_dir / "ckp"
        self.ckp_dir.mkdir(parents=True, exist_ok=True)
        self.logger = create_logger(
            self.exp_dir / f"log_train_{int(time.time())}.txt")
        self.metrics = MetricsWriter(self.exp_dir / "metrics.jsonl")
        self.tb = (TBWriter(self.exp_dir / "tensorboard")
                   if rank_and_world()[0] == 0 else None)
        log_config_to_file(cfgs, logger=self.logger)

        self.batch_per_device = int(
            getattr(args, "batch_size", 0) or cfgs.OPTIM.BATCH_SIZE_PER_GPU)
        self.max_ckp = getattr(args, "max_ckp_save_num", 5)

        modality = cfgs.get("MODALITY", "voxel")
        self.num_class = num_classes_for(cfgs.DATA.DATASET)
        point_cap = cfgs.get("TPU", {}).get("POINT_CAP_PER_SCAN", 131072)
        seed = getattr(args, "seed", 0)
        workers = getattr(args, "workers", 4)
        self.train_set, self.train_loader = build_dataloader(
            cfgs.DATA, modality, self.batch_per_device, training=True,
            point_cap=point_cap, num_workers=workers, seed=seed)
        self.val_set, self.val_loader = build_dataloader(
            cfgs.DATA, modality, self.batch_per_device, training=False,
            point_cap=point_cap, num_workers=workers, seed=seed)

        self.total_epochs = int(
            getattr(args, "epochs", 0) or cfgs.OPTIM.NUM_EPOCHS)
        compute_dtype = (
            torch.bfloat16
            if cfgs.get("TPU", {}).get("COMPUTE_DTYPE", "bfloat16")
            == "bfloat16" and self.device.type == "cuda" else torch.float32)
        self.task = SegTask(
            cfgs, self.num_class, device=self.device,
            compute_dtype=compute_dtype, seed=seed,
            batch_per_device=self.batch_per_device,
            iters_per_epoch=max(1, len(self.train_loader)),
            total_epochs=self.total_epochs)
        self.ready = False
        self.start_epoch = 0
        self.cur_epoch = 0

    # ------------------------------------------------------------- setup --

    def _device_batch(self, batch):
        """The arrays of a loader batch on the device (scan names stay)."""
        return batch_to_device({k: v for k, v in batch.items()
                                if k != "name"}, self.device)

    def init_or_resume(self) -> None:
        """Pretrained weights (--pretrained_ckp), then --ckp or the latest
        checkpoint of the experiment; once per run."""
        if self.ready:
            return
        self.ready = True
        if getattr(self.args, "pretrained_ckp", None):
            self.load_pretrained(self.args.pretrained_ckp)
        if getattr(self.args, "ckp", None):
            self.restore(self.args.ckp)
        else:
            latest = self.latest_checkpoint()
            if latest is not None:
                self.restore(latest)

    def load_pretrained(self, path) -> None:
        """Shape-tolerant partial load for fine-tuning: every saved tensor
        whose name and shape match the model; the optimizer stays fresh."""
        payload = torch.load(path, map_location="cpu", weights_only=True)
        saved = payload.get("model", payload)
        merged, n, skipped = merge_matching(self.task.model.state_dict(),
                                            saved)
        self.task.model.load_state_dict(merged)
        self.logger.info(
            f"pretrained load: {n} tensors matched"
            + (f"; skipped (missing/shape-mismatch): {skipped[:8]}"
               f"{'...' if len(skipped) > 8 else ''}" if skipped else ""))

    # ------------------------------------------------------- checkpointing --

    def checkpoints(self) -> list:
        """(epoch, path) of the experiment's checkpoints, oldest first."""
        out = []
        for p in self.ckp_dir.glob("*.pt"):
            if p.stem.isdigit():
                out.append((int(p.stem), p))
        return sorted(out)

    def latest_checkpoint(self) -> Optional[Path]:
        ckps = self.checkpoints()
        return ckps[-1][1] if ckps else None

    def save_checkpoint(self, epoch: int) -> Path:
        task = self.task
        payload = {"model": task.model.state_dict(),
                   "optimizer": task.optimizer.state_dict(),
                   "step": task.step, "epoch": epoch,
                   "generator": task.generator.get_state()}
        path = self.ckp_dir / f"{epoch}.pt"
        tmp = path.with_suffix(".pt.tmp")
        torch.save(payload, tmp)
        tmp.replace(path)
        for _, old in self.checkpoints()[:-self.max_ckp]:
            old.unlink()
        self.logger.info(f"checkpoint saved @ epoch {epoch}")
        return path

    def restore(self, path) -> None:
        """Model, optimizer (its momentum buffers on the model's device),
        step, generator and epoch from a checkpoint file."""
        payload = torch.load(path, map_location=self.device,
                             weights_only=True)
        task = self.task
        task.model.load_state_dict(payload["model"])
        task.optimizer.load_state_dict(payload["optimizer"])
        task.step = int(payload["step"])
        task.generator.set_state(payload["generator"].cpu())
        self.start_epoch = int(payload["epoch"]) + 1
        self.logger.info(f"resumed from epoch {int(payload['epoch'])} "
                         f"({path}, step {task.step})")

    # --------------------------------------------------------------- train --

    def _profile(self, it: int) -> None:
        """--profile_dir: a torch.profiler trace of steps PROFILE_STEPS of
        the first trained epoch, once per run."""
        if not self.profile_dir:
            return
        from torch.profiler import ProfilerActivity, profile
        if it == PROFILE_STEPS[0] and self._profiler is None:
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            self._profiler.start()
        elif it == PROFILE_STEPS[1] and self._profiler is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._profiler.stop()
            out = Path(self.profile_dir)
            out.mkdir(parents=True, exist_ok=True)
            trace = out / f"trace_{int(time.time())}.json"
            self._profiler.export_chrome_trace(str(trace))
            self._profiler = None
            self.profile_dir = None
            self.logger.info(f"profiler trace written to {trace}")

    def _flush(self, pending, epoch: int, it: int, t_data, interval_t0,
               loss_meter) -> None:
        """One copy of every pending step's scalars to the host; log the
        interval."""
        vals = torch.stack([torch.stack([
            m["loss"].float(), m["voxel_overflow"].float(),
            m["num_voxels"].float(), m["grad_norm"].float()])
            for m in pending]).cpu().numpy()
        n_int = len(pending)
        lr = pending[-1]["lr"]
        pending.clear()
        int_loss = float(vals[:, 0].mean())
        overflow = int(vals[:, 1].max())
        loss_meter.update(int_loss, n=n_int)
        step_time = (time.time() - interval_t0) / n_int
        if overflow > 0:
            self.logger.warning(f"voxel overflow: {overflow} voxels dropped "
                                "(raise TPU.VOXEL_CAP_PER_SCAN)")
        step = self.task.step
        mem = ({"max_memory_allocated":
                torch.cuda.max_memory_allocated(self.device)}
               if self.device.type == "cuda" else {})
        self.metrics.write(step, loss=int_loss, lr=lr,
                           num_voxels=vals[-1, 2], grad_norm=vals[-1, 3],
                           voxel_overflow=overflow, data_time=t_data.avg,
                           step_time=step_time,
                           scans_per_s=self.batch_per_device / step_time,
                           **mem)
        if self.tb is not None:
            self.tb.add_scalars({"train/loss": int_loss, "train/lr": lr,
                                 "train/step_time_ms": step_time * 1e3},
                                step)
        self.logger.info(
            f"epoch {epoch} it {it + 1}/{len(self.train_loader)} "
            f"loss {int_loss:.4f} lr {lr:.5f} step {step_time * 1e3:.0f}ms "
            f"data {t_data.avg * 1e3:.0f}ms")

    def train_one_epoch(self, epoch: int) -> None:
        self.init_or_resume()
        loss_meter, t_data = AverageMeter(), AverageMeter()
        last = interval_t0 = time.time()
        pending = []
        for it, batch in enumerate(self.train_loader):
            db = self._device_batch(batch)
            t_data.update(time.time() - last)
            self._profile(it)
            pending.append(self.task.train_step(db))
            if (it + 1) % self.log_interval == 0:
                self._flush(pending, epoch, it, t_data, interval_t0,
                            loss_meter)
                interval_t0 = time.time()
            last = time.time()
        self.train_set.resample()

    def evaluate(self, prefix: str = "val") -> float:
        """Full-loader eval -> mIoU (%); padded tail samples add nothing."""
        self.init_or_resume()
        hist = torch.zeros(self.num_class, self.num_class, dtype=torch.int64,
                           device=self.device)
        overflow = torch.zeros((), dtype=torch.int64, device=self.device)
        for batch in self.val_loader:
            out = self.task.eval_step(self._device_batch(batch))
            hist += out["hist"]
            overflow = torch.maximum(overflow, out["voxel_overflow"].long())
        hist = hist.cpu().numpy()
        overflow = int(overflow)

        unique_label = np.arange(self.num_class - 1)
        miou, iou = miou_from_hist(hist, unique_label)
        names = getattr(self.val_set, "class_names", CLASS_NAMES)
        eval_names = list(names[1:self.num_class])
        self.logger.info(f"{prefix} mIoU: {miou:.2f}\n"
                         + iou_table(miou, iou, eval_names))
        self.logger.info("\n" + confusion_table(
            crop_hist(hist, unique_label), eval_names))
        if overflow > 0:
            self.logger.warning(f"{prefix}: voxel overflow {overflow}")
        self.metrics.write(self.task.step, **{
            f"{prefix}_miou": miou, f"{prefix}_voxel_overflow": overflow})
        if self.tb is not None:
            self.tb.add_scalars({f"{prefix}/{n}": float(v)
                                 for n, v in zip(eval_names, iou)},
                                self.cur_epoch + 1)
            self.tb.add_scalar(f"{prefix}_miou", miou, self.cur_epoch + 1)
        return miou

    def evaluate_tta(self, voting: int = 10) -> float:
        raise NotImplementedError(
            "test-time augmentation is not ported yet (ROADMAP.md Queue 1 "
            "item 15)")

    def train(self) -> None:
        eval_interval = getattr(self.args, "eval_interval", 1)
        ckp_interval = getattr(self.args, "ckp_save_interval", 1)
        if len(self.train_loader) == 0:
            raise RuntimeError(
                f"empty train loader: batch {self.batch_per_device} exceeds "
                f"the {len(self.train_set)}-scan train set (drop_last); "
                "lower --batch_size or add data")
        self.init_or_resume()
        for epoch in range(self.start_epoch, self.total_epochs):
            self.cur_epoch = epoch
            self.train_one_epoch(epoch)
            if (epoch + 1) % ckp_interval == 0:
                self.save_checkpoint(epoch)
            if (epoch + 1) % eval_interval == 0 or (
                    epoch == self.total_epochs - 1):
                self.evaluate(prefix="val")

    def close(self) -> None:
        self.metrics.close()
        if self.tb is not None:
            self.tb.close()
