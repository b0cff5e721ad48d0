"""Inference / evaluation CLI of the port, with the flags of the JAX
package's infer.py: evaluate a checkpoint on the val split, and with
``--save_pred`` dump one prediction file per scan into DATA.OUTPUT_DIR
(default ``<experiment>/preds``):

    python -m openpcseg_torch.cli.infer \\
        --cfg_file tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10.yaml \\
        --ckp logs/.../ckp/35.pt --save_pred --save_raw_ids \\
        --set DATA.DATA_PATH <kitti>/sequences

Without ``--ckp`` it takes the experiment's latest checkpoint. ``--tta``
evaluates with 10-vote test-time augmentation instead
(``Trainer.evaluate_tta``); ``--save_pred`` still dumps the plain
predictions, as JAX's infer.py does. Data parallel over N processes:
``sh openpcseg_torch/cli/dist_infer.sh N --cfg_file ... [--tta]``; each
rank evaluates and dumps its own scans.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from openpcseg_torch.config import CfgDict, cfg_from_list, cfg_from_yaml_file


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description="OpenPCSeg-torch inference")
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=0)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--ckp", type=str, default=None)
    parser.add_argument("--log_dir", type=str, default="logs")
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--num_devices", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--save_pred", action="store_true",
                        help="dump per-scan .npy predictions to "
                             "DATA.OUTPUT_DIR")
    parser.add_argument("--save_raw_ids", action="store_true",
                        help="with --save_pred: remap train ids back to raw "
                             "dataset label ids (inverse LEARNING_MAP) in the "
                             "benchmark's submission layout: SemanticKITTI "
                             ".label files under sequences/<seq>/"
                             "predictions/, nuScenes lidarseg/val/"
                             "<token>_lidarseg.bin")
    parser.add_argument("--tta", action="store_true",
                        help="evaluate with 10-vote test-time augmentation")
    parser.add_argument("--log_interval", type=int, default=50)
    parser.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER,
                        default=None)
    args = parser.parse_args(argv)

    cfgs = CfgDict()
    cfg_from_yaml_file(args.cfg_file, cfgs)
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfgs)
    return args, cfgs


def dump_predictions(trainer, out_dir: Path, raw_ids: bool = False) -> int:
    """Per-scan argmax of the val split, one file per scan: ``<seq>_<frame>
    .npy`` (int32 train ids; ``<count>.npy`` for a scan whose name is not
    ``<seq>/velodyne/<frame>.bin``, as each frame of a Waymo sequence), or
    with raw_ids a benchmark's submission layout: SemanticKITTI's
    ``sequences/<seq>/predictions/<frame>.label`` (uint32 raw ids through
    the inverse LEARNING_MAP), nuScenes-lidarseg's
    ``lidarseg/val/<sample_data_token>_lidarseg.bin`` (uint8 raw category
    ids). A voxel model's predictions are per valid point, a range model's
    per pixel of its H x W image. Padded eval tails are skipped; under
    data parallelism each rank writes its own scans, and ``<count>`` is the
    scan's place in the val split. Returns the number of files this
    process wrote."""
    inv_lut = None
    nusc_tokens = None
    if raw_ids:
        ds = trainer.cfgs.DATA.DATASET
        if ds in ("semantickitti", "scribblekitti"):
            from openpcseg_torch.data.semantickitti_meta import (
                LEARNING_MAP_INV_LUT)
            inv_lut = LEARNING_MAP_INV_LUT
        elif ds == "nuscenes":
            from openpcseg_torch.data.nuscenes_meta import LEARNING_MAP_INV
            inv_lut = LEARNING_MAP_INV
            src = getattr(trainer.val_set, "source", trainer.val_set)
            nusc_tokens = {r["path"]: r["token"]
                           for r in getattr(src, "annos", [])}
        else:
            raise SystemExit(f"--save_raw_ids: no inverse label map for "
                             f"dataset '{ds}'")

    trainer.init_or_resume()
    out_dir.mkdir(parents=True, exist_ok=True)
    def place(bi, i):
        """Scan i of this rank's batch bi: its place in the val split."""
        return (bi * trainer.global_batch
                + trainer.rank * trainer.batch_per_device + i)

    count = 0
    for bi, batch in enumerate(trainer.val_loader):
        preds = trainer.task.predict_step(
            trainer._device_batch(batch)).cpu().numpy()
        valid = batch.get("valid")
        for i, name in enumerate(batch.get("name", range(len(preds)))):
            if str(name) == "<pad>":
                continue  # eval padding (BatchLoader pad_last)
            # a range model's predictions are its image's pixels, [H, W]
            # in row order, as JAX's infer.py writes them
            p = preds[i] if valid is None else preds[i][np.asarray(
                valid[i])]
            parts = str(name).replace("\\", "/").split("/")
            named = len(parts) >= 3 and parts[-1].endswith(".bin")
            if nusc_tokens is not None:
                tok = nusc_tokens.get(str(name))
                if tok is None:
                    continue
                pdir = out_dir / "lidarseg" / "val"
                pdir.mkdir(parents=True, exist_ok=True)
                raw = inv_lut[p.astype(np.int64)].astype(np.uint8)
                raw.tofile(pdir / f"{tok}_lidarseg.bin")
            elif inv_lut is not None:
                seq = parts[-3] if named else "00"
                frame = parts[-1][:-4] if named else f"{place(bi, i):06d}"
                pdir = out_dir / "sequences" / seq / "predictions"
                pdir.mkdir(parents=True, exist_ok=True)
                raw = inv_lut[p.astype(np.int64)].astype(np.uint32)
                raw.tofile(pdir / f"{frame}.label")
            else:
                fname = (f"{parts[-3]}_{parts[-1][:-4]}.npy" if named
                         else f"{place(bi, i):06d}.npy")
                np.save(out_dir / fname, p.astype(np.int32))
            count += 1
    return count


def main(argv=None) -> int:
    from openpcseg_torch.engine.trainer import Trainer
    from openpcseg_torch.parallel import init_distributed, shutdown

    args, cfgs = parse_config(argv)
    args.device = str(init_distributed(args.device)[2])
    trainer = Trainer(args, cfgs)
    try:
        if args.tta:
            trainer.evaluate_tta()
        else:
            trainer.evaluate(prefix="val")
        if args.save_pred:
            out_dir = Path(cfgs.DATA.get("OUTPUT_DIR",
                                         trainer.exp_dir / "preds"))
            n = dump_predictions(trainer, out_dir, raw_ids=args.save_raw_ids)
            trainer.logger.info(f"saved {n} prediction files to {out_dir}")
    finally:
        trainer.close()
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
