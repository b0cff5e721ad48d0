"""Trainer: the train / eval / checkpoint harness around SegTask.

Counterpart of ``openpcseg_tpu/engine/trainer.py``:

- the experiment tree ``<log_dir>/<EXP_GROUP_PATH>/<TAG>/<extra_tag>``
  with a log file, ``metrics.jsonl``, TensorBoard event files and ``ckp/``;
- per epoch: the train loader (resampled after the epoch), a checkpoint
  and an eval with the per-class IoU table and confusion matrix;
- checkpoints are one ``torch.save`` file per epoch, ``ckp/<epoch>.pt``,
  holding the model and optimizer ``state_dict``s, ``SegTask.step`` (so
  the LR schedule goes on where it stopped), the epoch, the dropout
  generator's state and the loss state (EQLv2's buffers; {} otherwise); the newest ``max_ckp_save_num`` files are kept, and a
  run without ``--ckp`` resumes from the latest epoch.

Host syncs: a step's outputs stay on the device and are read once per
``log_interval`` steps (one copy of every pending step's scalars), never
per step; an eval reads its histogram once, after the last batch.

The trainer runs on one card (``args.device``, default ``cuda``; it raises
without one unless the caller asks for the CPU), or data-parallel on one
process per rank when torch.distributed is initialised (``cli/
dist_train.sh``; ``parallel/ddp.py``): each rank loads its
``batch_per_device`` slice of the global batch ``batch_per_device x
world`` (the LR scales with the global batch), the steps run their
collectives, and rank 0 alone writes the checkpoints, ``metrics.jsonl``,
the TensorBoard events and the log file; a barrier follows each
checkpoint, and every rank resumes from the same file. Eval tails are
padded to the global batch (``pad_last``) and add nothing.

``evaluate_tta`` is JAX's 10-vote test-time augmentation
(``tta_histogram``): each scan's votes in one batched forward of a task of
its own, whose caps hold the votes and which shares the model.
"""
from __future__ import annotations

import itertools
import time
from contextlib import ExitStack
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import CfgDict, log_config_to_file
from ..data import build_dataloader, collate, num_classes_for, rank_and_world
from ..data.semantickitti_meta import CLASS_NAMES
from ..parallel.ddp import all_reduce_sum, shard_train_step
from ..utils import spans
from ..utils.checkpoint import barrier, merge_matching, write_atomic
from ..utils.logger import AverageMeter, MetricsWriter, create_logger
from ..utils.metrics import confusion_matrix, crop_hist, miou_from_hist
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
        self.rank, self.world = rank_and_world()
        n_dev = getattr(args, "num_devices", 0) or self.world
        if n_dev != self.world:
            raise ValueError(
                f"--num_devices {n_dev}, but this run has {self.world} "
                "process(es) (WORLD_SIZE): launch one process per device, "
                f"e.g. openpcseg_torch/cli/dist_train.sh {n_dev}")
        self.is_main = self.rank == 0
        self.log_interval = getattr(args, "log_interval", 50)
        self.profile_dir = getattr(args, "profile_dir", None)
        self._profiler = self._spans = self._records = None

        root = Path(getattr(args, "log_dir", "logs"))
        self.exp_dir = root / cfgs.get("EXP_GROUP_PATH", "exp") / cfgs.get(
            "TAG", "default") / getattr(args, "extra_tag", "default")
        self.ckp_dir = self.exp_dir / "ckp"
        self.ckp_dir.mkdir(parents=True, exist_ok=True)
        self.logger = create_logger(
            self.exp_dir / f"log_train_{int(time.time())}.txt", self.rank)
        self.metrics = (MetricsWriter(self.exp_dir / "metrics.jsonl")
                        if self.is_main else None)
        self.tb = (TBWriter(self.exp_dir / "tensorboard") if self.is_main
                   else None)
        log_config_to_file(cfgs, logger=self.logger)
        if dist.is_available() and dist.is_initialized():
            self.logger.info(f"data parallel: {self.world} rank(s) over "
                             f"{dist.get_backend()}, rank 0 on {self.device}")

        self.batch_per_device = int(
            getattr(args, "batch_size", 0) or cfgs.OPTIM.BATCH_SIZE_PER_GPU)
        # the loaders take the global batch, each rank its slice of it
        # (JAX trainer.py:77-91)
        self.global_batch = self.batch_per_device * self.world
        self.max_ckp = getattr(args, "max_ckp_save_num", 5)

        modality = cfgs.get("MODALITY", "voxel")
        self.num_class = num_classes_for(cfgs.DATA.DATASET)
        point_cap = cfgs.get("TPU", {}).get("POINT_CAP_PER_SCAN", 131072)
        seed = getattr(args, "seed", 0)
        workers = getattr(args, "workers", 4)
        self.train_set, self.train_loader = build_dataloader(
            cfgs.DATA, modality, self.global_batch, training=True,
            point_cap=point_cap, num_workers=workers, seed=seed)
        self.val_set, self.val_loader = build_dataloader(
            cfgs.DATA, modality, self.global_batch, training=False,
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
            batch_per_device=self.batch_per_device, num_devices=self.world,
            iters_per_epoch=max(1, len(self.train_loader)),
            total_epochs=self.total_epochs,
            group=dist.group.WORLD if self.world > 1 else None)
        self._train_step = None
        self._tta_tasks: dict = {}
        self.tta_hist: Optional[np.ndarray] = None
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
        checkpoint of the experiment (every rank the same file); once per
        run. Then the train step, which starts every rank from rank 0's
        state."""
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
        self._train_step = shard_train_step(self.task)

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
        """Rank 0 writes ckp/<epoch>.pt and prunes the oldest; every rank
        then waits at a barrier."""
        path = self.ckp_dir / f"{epoch}.pt"
        if self.is_main:
            task = self.task
            write_atomic({"model": task.model.state_dict(),
                          "optimizer": task.optimizer.state_dict(),
                          "step": task.step, "epoch": epoch,
                          "generator": task.generator.get_state(),
                          "loss_state": task.loss_state}, path)
            for _, old in self.checkpoints()[:-self.max_ckp]:
                old.unlink()
            self.logger.info(f"checkpoint saved @ epoch {epoch}")
        barrier()
        return path

    def restore(self, path) -> None:
        """Model, optimizer (its momentum buffers on the model's device),
        step, generator, loss state and epoch from a checkpoint file. A
        checkpoint carried over from a JAX run (``utils/convert.py
        jax_state_to_torch``) holds the run's seed in place of a
        generator's state: the task's generator is seeded with it."""
        payload = torch.load(path, map_location=self.device,
                             weights_only=True)
        task = self.task
        task.model.load_state_dict(payload["model"])
        task.optimizer.load_state_dict(payload["optimizer"])
        task.step = int(payload["step"])
        if isinstance(payload["generator"], int):
            task.generator.manual_seed(payload["generator"])
        else:
            task.generator.set_state(payload["generator"].cpu())
        task.loss_state = payload.get("loss_state", task.loss_state)
        self.start_epoch = int(payload["epoch"]) + 1
        self.logger.info(f"resumed from epoch {int(payload['epoch'])} "
                         f"({path}, step {task.step})")

    # --------------------------------------------------------------- train --

    def _profile(self, it: int) -> None:
        """--profile_dir: a torch.profiler trace of steps PROFILE_STEPS of
        the first trained epoch (their loader waits and copies included),
        once per run, with the steps' phase spans recorded and merged into
        the trace on a track of their own."""
        if not self.profile_dir:
            return
        from torch.profiler import ProfilerActivity, profile
        if it == PROFILE_STEPS[0] and self._profiler is None:
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            self._profiler.start()
            self._spans = ExitStack()
            self._records = self._spans.enter_context(spans.recording())
        elif it == PROFILE_STEPS[1] and self._profiler is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._spans.close()
            self._profiler.stop()
            out = Path(self.profile_dir)
            out.mkdir(parents=True, exist_ok=True)
            trace = out / f"trace_{int(time.time())}.json"
            self._profiler.export_chrome_trace(str(trace))
            n = spans.merge_chrome_trace(trace, self._records)
            self._profiler = self._spans = self._records = None
            self.profile_dir = None
            self.logger.info(f"profiler trace written to {trace} ({n} "
                             "phase spans)")

    def _flush(self, pending, epoch: int, it: int, t_data, t_h2d,
               interval_t0, loss_meter) -> None:
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
        self._write_metrics(step, loss=int_loss, lr=lr,
                            num_voxels=vals[-1, 2], grad_norm=vals[-1, 3],
                            voxel_overflow=overflow, data_time=t_data.avg,
                            h2d_time=t_h2d.avg, step_time=step_time,
                            scans_per_s=self.global_batch / step_time,
                            **mem)
        if self.tb is not None:
            self.tb.add_scalars({"train/loss": int_loss, "train/lr": lr,
                                 "train/step_time_ms": step_time * 1e3},
                                step)
        self.logger.info(
            f"epoch {epoch} it {it + 1}/{len(self.train_loader)} "
            f"loss {int_loss:.4f} lr {lr:.5f} step {step_time * 1e3:.0f}ms "
            f"data {t_data.avg * 1e3:.0f}ms h2d {t_h2d.avg * 1e3:.0f}ms")

    def train_one_epoch(self, epoch: int) -> None:
        """One epoch of train steps. ``data_time`` is the wait on the loader
        alone (the ``load`` span), ``h2d_time`` the batch's pageable copy
        to the device (``to_device``), which waits for the card to finish
        the step before."""
        self.init_or_resume()
        loss_meter, t_data, t_h2d = (AverageMeter(), AverageMeter(),
                                     AverageMeter())
        interval_t0 = time.time()
        pending = []
        batches = iter(self.train_loader)
        for it in itertools.count():
            self._profile(it)
            t0 = time.time()
            with spans.span("load"):
                batch = next(batches, None)
            if batch is None:
                break
            t1 = time.time()
            db = self._device_batch(batch)
            t2 = time.time()
            t_data.update(t1 - t0)
            t_h2d.update(t2 - t1)
            pending.append(self._train_step(db))
            if (it + 1) % self.log_interval == 0:
                self._flush(pending, epoch, it, t_data, t_h2d, interval_t0,
                            loss_meter)
                interval_t0 = time.time()
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
        self._write_metrics(self.task.step, **{
            f"{prefix}_miou": miou, f"{prefix}_voxel_overflow": overflow})
        if self.tb is not None:
            self.tb.add_scalars({f"{prefix}/{n}": float(v)
                                 for n, v in zip(eval_names, iou)},
                                self.cur_epoch + 1)
            self.tb.add_scalar(f"{prefix}_miou", miou, self.cur_epoch + 1)
        return miou

    def tta_task(self, voting: int) -> SegTask:
        """Test-time augmentation's task for `voting` votes, made once per
        `voting`: its caps hold a batch of `voting` scans (they scale with
        the batch), and it shares the trainer's model (JAX
        trainer.py:355-369)."""
        if voting not in self._tta_tasks:
            cfgs = {k: v for k, v in self.cfgs.items() if k != "OPTIM"}
            self._tta_tasks[voting] = SegTask(
                cfgs, self.num_class, device=self.device,
                compute_dtype=self.task.compute_dtype,
                batch_per_device=voting, model=self.task.model)
        return self._tta_tasks[voting]

    def evaluate_tta(self, voting: int = 10) -> float:
        """`voting`-vote test-time augmentation over the val split ->
        mIoU (%) (JAX ``Trainer.evaluate_tta``, trainer.py:336-438): every
        rank takes its own scans, the histograms are summed over the ranks;
        the histogram stays in ``tta_hist``."""
        self.init_or_resume()
        hist = tta_histogram(self.tta_task(voting), self.val_set, voting,
                             self.rank, self.world)
        self.tta_hist = hist
        unique_label = np.arange(self.num_class - 1)
        miou, iou = miou_from_hist(hist, unique_label)
        names = getattr(self.val_set, "class_names", CLASS_NAMES)
        eval_names = list(names[1:self.num_class])
        self.logger.info(f"TTA val mIoU: {miou:.2f} ({voting} votes)\n"
                         + iou_table(miou, iou, eval_names))
        self._write_metrics(self.task.step, val_tta_miou=miou)
        if self.tb is not None:
            self.tb.add_scalar("val_tta_miou", miou, self.cur_epoch + 1)
        return miou

    def _write_metrics(self, step: int, **scalars) -> None:
        if self.metrics is not None:
            self.metrics.write(step, **scalars)

    def train(self) -> None:
        eval_interval = getattr(self.args, "eval_interval", 1)
        ckp_interval = getattr(self.args, "ckp_save_interval", 1)
        if len(self.train_loader) == 0:
            raise RuntimeError(
                f"empty train loader: global batch {self.global_batch} "
                f"({self.batch_per_device} a device x {self.world}) exceeds "
                f"the {len(self.train_set)}-scan train set (drop_last); "
                "lower --batch_size / --num_devices or add data")
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
        if self.metrics is not None:
            self.metrics.close()
        if self.tb is not None:
            self.tb.close()


def tta_scan_hist(task: SegTask, votes, counted: bool = True
                  ) -> torch.Tensor:
    """One scan's test-time augmentation on the device: its votes (a list
    of view samples, ``dataset.get_tta_sample``) in one batched forward
    (``task.predict_probs_step``), the mean of their probabilities, its
    argmax and the histogram (int64 [C, C]) against the scan's labels;
    all zero where not `counted` (a padded round)."""
    lab_key, val_key = (("p_label", "p_valid") if task.is_range
                        else ("labels", "valid"))
    db = batch_to_device({k: v for k, v in collate(votes).items()
                          if k != "name"}, task.device)
    probs = task.predict_probs_step(db)              # [voting, N, C]
    pred = probs.mean(0).argmax(-1).to(torch.int32)
    valid = db[val_key][0] if counted else torch.zeros_like(db[val_key][0])
    return confusion_matrix(pred, db[lab_key][0], valid, task.num_class)


def tta_histogram(task: SegTask, dataset, voting: int, rank: int = 0,
                  world: int = 1) -> np.ndarray:
    """The confusion matrix of `voting`-vote test-time augmentation over
    `dataset` (int64 [C, C]; JAX ``Trainer.evaluate_tta``, trainer.py:
    336-438), one scan at a time through ``tta_scan_hist``. Rank r of
    `world` forwards scans start + r; the tail repeats the last scan,
    uncounted, and the ranks' histograms are summed once at the end (JAX
    psums each round's; the sum is the same). A vote's scale is drawn from
    the view's generator, so every rank draws the votes of every scan of a
    round, in JAX's order, and forwards its own: the votes, and so the
    histogram, are the same at every world size. The price: a rank builds
    `world` scans' votes on the host for each scan it forwards."""
    c, n = task.num_class, len(dataset)
    hist = torch.zeros(c, c, dtype=torch.int64, device=task.device)
    for start in range(0, n, world):
        votes = [dataset.get_tta_sample(min(start + r, n - 1), voting=voting)
                 for r in range(world)][rank]
        hist += tta_scan_hist(task, votes, counted=start + rank < n)
    if world > 1:
        hist = all_reduce_sum(hist, dist.group.WORLD)
    return hist.cpu().numpy()
