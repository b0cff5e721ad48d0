#!/usr/bin/env bash
# Data-parallel training of the port: N processes on this host through
# torchrun, one a card (NCCL; gloo where ranks share a card or with
# --device cpu), each loading its slice of the global batch
# (--batch_size per card x N).
#
#   sh openpcseg_torch/cli/dist_train.sh <N> --cfg_file ... [cli.train args]
set -e
NGPUS=$1
shift
exec "${PYTHON:-python3}" -m torch.distributed.run --standalone \
    --nproc_per_node "$NGPUS" -m openpcseg_torch.cli.train \
    --num_devices "$NGPUS" "$@"
