"""openpcseg_torch: the PyTorch / CUDA (Hopper) port of openpcseg_tpu.

Module layout follows the JAX package, so every module has an obvious
counterpart there. The package imports torch, numpy and the standard
library only; its hand-written CUDA kernels (``csrc/``) are built with nvcc
at first use on a CUDA tensor (``ops/cuda_lib.py``).

It carries MinkUNet (voxel modality), SPVCNN (voxel and fusion
modalities), RPVNet (fusion modality), Cylinder3D (cylinder modality) and
the range-view CENet, FIDNet, RangeNet and SalsaNext (range modality) on
SemanticKITTI, ScribbleKITTI, Waymo Open and nuScenes-lidarseg, training
and inference, at any batch per card:

- entry points: ``cli.train`` and ``cli.infer`` (the flags of the JAX
  package's ``train.py`` and ``infer.py``) and ``cli.golden_run`` (the
  ray-cast convergence gate); ``config`` reads ``tools/cfgs`` without a
  yaml package;
- ``engine.trainer.Trainer``: the experiment tree, logs, checkpoints and
  the epoch loops, around ``engine.task.SegTask`` (``train_step``,
  ``eval_step``, ``predict_step``);
- ``data``: the SemanticKITTI, Waymo and nuScenes readers,
  augmentations, the voxel, fusion and range views and their
  ``BatchLoader``, and ray-cast surrogate scans and trees in each
  dataset's layout;
- the step: ``core.batch`` (voxelize) -> ``core.geometry`` (pyramid,
  kernel maps, devoxelize and point-to-voxel tables) ->
  ``models.minkunet`` / ``models.spvcnn`` / ``models.cylinder3d`` over
  ``ops`` (the kernels' wrappers) -> ``losses`` -> ``optim``, and
  ``utils.metrics``; a range step runs ``models.range_*`` (dense convs
  on cuDNN) -> ``losses.range_losses``, and its eval ``ops.range_knn``.
"""

__version__ = "0.1.0"
