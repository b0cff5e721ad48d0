"""Training CLI of the port, with the flags of the JAX package's train.py:

    python -m openpcseg_torch.cli.train \\
        --cfg_file tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10.yaml \\
        --set DATA.DATA_PATH <kitti>/sequences

Trains on one card (``--device``, default ``cuda``); ``--device cpu`` runs
the kernels' plain versions on the CPU. A rerun with the same experiment
(``--log_dir``, ``--extra_tag``) resumes from its latest checkpoint.
Data parallel over N processes, one a card (``--num_devices`` is the world
size and must equal torchrun's WORLD_SIZE; ``--batch_size`` stays per
card):

    sh openpcseg_torch/cli/dist_train.sh N --cfg_file ... [--set ...]

Each rank's device is ``cuda:{LOCAL_RANK % device_count}``
(``parallel.ddp.init_distributed``), or the CPU with ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys

from openpcseg_torch.config import CfgDict, cfg_from_list, cfg_from_yaml_file


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description="OpenPCSeg-torch training")
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=0,
                        help="batch size per card (default: from cfg)")
    parser.add_argument("--epochs", type=int, default=0)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--ckp", type=str, default=None,
                        help="a checkpoint file (ckp/<epoch>.pt) to resume")
    parser.add_argument("--pretrained_ckp", type=str, default=None,
                        help="shape-tolerant partial init from a saved "
                             "checkpoint (fine-tune workflows)")
    parser.add_argument("--log_dir", type=str, default="logs")
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--num_devices", type=int, default=0,
                        help="the data-parallel world size (torchrun's "
                             "WORLD_SIZE; 0: whatever it is)")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--eval_interval", type=int, default=1)
    parser.add_argument("--ckp_save_interval", type=int, default=1)
    parser.add_argument("--max_ckp_save_num", type=int, default=5)
    parser.add_argument("--log_interval", type=int, default=50)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of training "
                             "steps 20-25 here (chrome trace JSON)")
    parser.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER,
                        default=None, help="dotted-key config overrides")
    args = parser.parse_args(argv)

    cfgs = CfgDict()
    cfg_from_yaml_file(args.cfg_file, cfgs)
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfgs)
    return args, cfgs


def main(argv=None) -> int:
    from openpcseg_torch.engine.trainer import Trainer
    from openpcseg_torch.parallel import init_distributed, shutdown

    args, cfgs = parse_config(argv)
    args.device = str(init_distributed(args.device)[2])
    trainer = Trainer(args, cfgs)
    try:
        if args.eval:
            trainer.evaluate(prefix="val")
        else:
            trainer.train()
    finally:
        trainer.close()
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
