#!/usr/bin/env bash
# Data-parallel evaluation of the port (cli.infer; --tta for 10-vote
# test-time augmentation): N processes on this host through torchrun, each
# evaluating its own scans; the histograms are summed over the ranks.
#
#   sh openpcseg_torch/cli/dist_infer.sh <N> --cfg_file ... [cli.infer args]
set -e
NGPUS=$1
shift
exec "${PYTHON:-python3}" -m torch.distributed.run --standalone \
    --nproc_per_node "$NGPUS" -m openpcseg_torch.cli.infer \
    --num_devices "$NGPUS" "$@"
