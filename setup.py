"""Packaging (reference: setup.py:1-32 — name pcseg, git-sha-stamped
version). Pure-Python package; the compute engine is JAX/XLA/Pallas."""
import subprocess

from setuptools import find_packages, setup


def get_git_commit_number():
    try:
        cmd_out = subprocess.run(
            ["git", "rev-parse", "HEAD"], stdout=subprocess.PIPE, check=True)
        return cmd_out.stdout.decode("utf-8")[:7]
    except Exception:
        return "0000000"


setup(
    name="openpcseg_tpu",
    version="0.1.0+%s" % get_git_commit_number(),
    description="TPU-native LiDAR point cloud segmentation framework "
                "(JAX/XLA/Pallas)",
    packages=find_packages(exclude=["tests", "tools"]),
    # the PyTorch / CUDA port ships its kernel sources: they are compiled
    # with nvcc at first use on a CUDA tensor (openpcseg_torch/ops/
    # cuda_lib.py); its native readers' source, compiled with g++ at first
    # use (openpcseg_torch/native.py); the golden gates its golden_run
    # reads; and its torchrun launchers
    package_data={"openpcseg_torch": ["csrc/*.cu", "csrc/*.cuh",
                                      "csrc/*.cpp", "cli/*.json",
                                      "cli/*.sh"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "orbax-checkpoint", "numpy",
                      "pyyaml"],
    # openpcseg_torch (the PyTorch / CUDA port) needs torch; nvcc at run time
    extras_require={"torch": ["torch", "numpy"]},
)
