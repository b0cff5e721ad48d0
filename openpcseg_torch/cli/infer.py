"""Inference / evaluation CLI of the port, with the flags of the JAX
package's infer.py: evaluate a checkpoint on the val split, and with
``--save_pred`` dump one prediction file per scan into DATA.OUTPUT_DIR
(default ``<experiment>/preds``):

    python -m openpcseg_torch.cli.infer \\
        --cfg_file tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10.yaml \\
        --ckp logs/.../ckp/35.pt --save_pred --save_raw_ids \\
        --set DATA.DATA_PATH <kitti>/sequences

Without ``--ckp`` it takes the experiment's latest checkpoint. ``--tta``
raises: test-time augmentation is not ported yet.
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
                             "dataset label ids (inverse LEARNING_MAP) and "
                             "write SemanticKITTI submission-format .label "
                             "files under sequences/<seq>/predictions/")
    parser.add_argument("--tta", action="store_true",
                        help="10-vote test-time augmentation (not ported "
                             "yet: raises)")
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
    .npy`` (int32 train ids), or with raw_ids the SemanticKITTI submission
    layout ``sequences/<seq>/predictions/<frame>.label`` (uint32 raw ids
    through the inverse LEARNING_MAP). Padded eval tails are skipped.
    Returns the number of files written."""
    inv_lut = None
    if raw_ids:
        ds = trainer.cfgs.DATA.DATASET
        if ds not in ("semantickitti", "scribblekitti"):
            raise SystemExit(f"--save_raw_ids: no inverse label map for "
                             f"dataset '{ds}' in the port")
        from openpcseg_torch.data.semantickitti_meta import (
            LEARNING_MAP_INV_LUT)
        inv_lut = LEARNING_MAP_INV_LUT

    trainer.init_or_resume()
    out_dir.mkdir(parents=True, exist_ok=True)
    count = 0
    for batch in trainer.val_loader:
        preds = trainer.task.predict_step(
            trainer._device_batch(batch)).cpu().numpy()
        valid = np.asarray(batch["valid"])
        for i, name in enumerate(batch.get("name", range(len(preds)))):
            if str(name) == "<pad>":
                continue  # eval padding (BatchLoader pad_last)
            p = preds[i][valid[i]]
            parts = str(name).replace("\\", "/").split("/")
            named = len(parts) >= 3 and parts[-1].endswith(".bin")
            if inv_lut is not None:
                seq = parts[-3] if named else "00"
                frame = parts[-1][:-4] if named else f"{count:06d}"
                pdir = out_dir / "sequences" / seq / "predictions"
                pdir.mkdir(parents=True, exist_ok=True)
                raw = inv_lut[p.astype(np.int64)].astype(np.uint32)
                raw.tofile(pdir / f"{frame}.label")
            else:
                fname = (f"{parts[-3]}_{parts[-1][:-4]}.npy" if named
                         else f"{count:06d}.npy")
                np.save(out_dir / fname, p.astype(np.int32))
            count += 1
    return count


def main(argv=None) -> int:
    from openpcseg_torch.engine.trainer import Trainer

    args, cfgs = parse_config(argv)
    if args.tta:
        raise NotImplementedError(
            "--tta: test-time augmentation is not ported yet (ROADMAP.md "
            "Queue 1 item 15)")
    trainer = Trainer(args, cfgs)
    try:
        trainer.evaluate(prefix="val")
        if args.save_pred:
            out_dir = Path(cfgs.DATA.get("OUTPUT_DIR",
                                         trainer.exp_dir / "preds"))
            n = dump_predictions(trainer, out_dir, raw_ids=args.save_raw_ids)
            trainer.logger.info(f"saved {n} prediction files to {out_dir}")
    finally:
        trainer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
