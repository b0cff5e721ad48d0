"""Data parallelism over torch.distributed (``ddp``) and the worker that
drives a data-parallel step in several processes (``worker``)."""
from .ddp import (all_reduce_sum, average_gradients,  # noqa: F401
                  broadcast_buffers, init_distributed, reduce_train_metrics,
                  shard_train_step, shutdown, sync_batchnorm)
