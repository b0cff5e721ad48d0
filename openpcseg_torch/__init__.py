"""openpcseg_torch: the PyTorch / CUDA (Hopper) port of openpcseg_tpu.

Module layout follows the JAX package, so every module has an obvious
counterpart there. The package imports torch, numpy and the standard
library only; its hand-written CUDA kernels (``csrc/``) are built with nvcc
at first use on a CUDA tensor (``ops/cuda_lib.py``).

It carries MinkUNet (voxel modality) and SPVCNN (voxel and fusion
modalities) on SemanticKITTI and ScribbleKITTI, training and inference, at
any batch per card:

- entry points: ``cli.train`` and ``cli.infer`` (the flags of the JAX
  package's ``train.py`` and ``infer.py``) and ``cli.golden_run`` (the
  ray-cast convergence gate); ``config`` reads ``tools/cfgs`` without a
  yaml package;
- ``engine.trainer.Trainer``: the experiment tree, logs, checkpoints and
  the epoch loops, around ``engine.task.SegTask`` (``train_step``,
  ``eval_step``, ``predict_step``);
- ``data``: the SemanticKITTI reader, augmentations, the voxel and fusion
  views and their ``BatchLoader``, and ray-cast surrogate scans and trees;
- the step: ``core.batch`` (voxelize) -> ``core.geometry`` (pyramid,
  kernel maps, devoxelize and point-to-voxel tables) ->
  ``models.minkunet`` / ``models.spvcnn`` over ``ops`` (the kernels'
  wrappers) -> ``losses`` -> ``optim``, and ``utils.metrics``.
"""

__version__ = "0.1.0"
