"""openpcseg_torch: the PyTorch / CUDA (Hopper) port of openpcseg_tpu.

Module layout follows the JAX package, so every module has an obvious
counterpart there. The package imports torch and numpy only; its
hand-written CUDA kernels (``csrc/``) are built with nvcc at first use on a
CUDA tensor (``ops/cuda_lib.py``).

So far it carries the voxel-modality eval step of MinkUNet:
``engine.task.SegTask`` -> ``core.batch`` (voxelize) -> ``core.geometry``
(pyramid + kernel maps) -> ``models.minkunet`` -> ``utils.metrics``.
"""

__version__ = "0.1.0"
