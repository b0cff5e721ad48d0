"""Boundaries of the port: what it imports, the config chip_smoke.py drives,
and that a wrapper handed a CUDA tensor never falls back to its plain
version when the kernel library cannot be built."""
import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from openpcseg_torch.core.geometry import (build_parity_plan, devox_table,
                                           p2v_table)
from openpcseg_torch.engine.task import SegTask
from openpcseg_torch.ops import cuda_lib, devox, subm_conv, updown

ROOT = Path(__file__).resolve().parents[1]

SLICE_MODULES = [
    "openpcseg_torch", "openpcseg_torch.ops.coords",
    "openpcseg_torch.ops.segment", "openpcseg_torch.ops.kmap",
    "openpcseg_torch.ops.voxelize", "openpcseg_torch.ops.sparse_conv",
    "openpcseg_torch.ops.subm_conv", "openpcseg_torch.ops.updown",
    "openpcseg_torch.ops.devox", "openpcseg_torch.ops.cuda_lib",
    "openpcseg_torch.core.tensor", "openpcseg_torch.core.batch",
    "openpcseg_torch.core.geometry", "openpcseg_torch.models",
    "openpcseg_torch.models.layers", "openpcseg_torch.models.minkunet",
    "openpcseg_torch.utils.metrics", "openpcseg_torch.utils.convert",
    "openpcseg_torch.engine.task", "openpcseg_torch.data.raycast",
    "openpcseg_torch.losses", "openpcseg_torch.optim",
    "openpcseg_torch.config", "openpcseg_torch.data",
    "openpcseg_torch.data.semantickitti_meta", "openpcseg_torch.data.augment",
    "openpcseg_torch.data.semantickitti", "openpcseg_torch.data.synthetic",
    "openpcseg_torch.data.voxel_view", "openpcseg_torch.data.raycast_kitti",
    "openpcseg_torch.utils.logger", "openpcseg_torch.utils.tb_writer",
    "openpcseg_torch.utils.reporting", "openpcseg_torch.utils.checkpoint",
    "openpcseg_torch.engine.trainer", "openpcseg_torch.cli",
    "openpcseg_torch.cli.train", "openpcseg_torch.cli.infer",
    "openpcseg_torch.cli.golden_run", "openpcseg_torch.models.spvcnn",
    "openpcseg_torch.data.fusion_view", "openpcseg_torch.models.cylinder3d",
]


def test_port_imports_no_jax_flax_optax_or_yaml():
    code = (
        "import sys, importlib\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'yaml', 'openpcseg_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "clean" in res.stdout


def test_chip_smoke_model_is_the_mk34_cr10_config():
    import chip_smoke
    cfg = yaml.safe_load((ROOT / "tools/cfgs/voxel/semantic_kitti/"
                          "minkunet_mk34_cr10.yaml").read_text())
    assert chip_smoke.MODEL_CFG == cfg["MODEL"]
    assert chip_smoke.CFGS["DATA"]["VOXEL_SIZE"] == cfg["DATA"]["VOXEL_SIZE"]
    assert (chip_smoke.CFGS["TPU"]["VOXEL_CAP_PER_SCAN"]
            == cfg["TPU"]["VOXEL_CAP_PER_SCAN"])
    assert chip_smoke.N_POINTS == cfg["TPU"]["POINT_CAP_PER_SCAN"]


def test_chip_smoke_spvcnn_is_the_mk34_cr10_config():
    import chip_smoke
    cfg = yaml.safe_load((ROOT / chip_smoke.SPV_ENTRY_CFG).read_text())
    assert chip_smoke.SPV_MODEL_CFG == cfg["MODEL"]
    assert chip_smoke.SPV_OPTIM_CFG == cfg["OPTIM"]
    assert chip_smoke.SPV_CFGS["MODALITY"] == cfg["MODALITY"] == "fusion"
    assert (chip_smoke.SPV_CFGS["TPU"]["VOXEL_CAP_PER_SCAN"]
            == cfg["TPU"]["VOXEL_CAP_PER_SCAN"])
    assert chip_smoke.N_POINTS == cfg["TPU"]["POINT_CAP_PER_SCAN"]


def test_chip_smoke_cylinder_is_the_cy480_cr10_config():
    import chip_smoke
    cfg = yaml.safe_load((ROOT / chip_smoke.CYL_ENTRY_CFG).read_text())
    assert chip_smoke.CYL_MODEL_CFG == cfg["MODEL"]
    assert chip_smoke.CYL_TRAIN_CFGS["OPTIM"] == cfg["OPTIM"]
    assert chip_smoke.CYL_CFGS["MODALITY"] == cfg["MODALITY"] == "cylinder"
    data = {k: v for k, v in cfg["DATA"].items() if k.startswith("CYL")}
    assert chip_smoke.CYL_CFGS["DATA"] == dict(data, DATASET="semantickitti")
    tpu = {k: v for k, v in cfg["TPU"].items() if k != "COMPUTE_DTYPE"}
    assert chip_smoke.CYL_CFGS["TPU"] == tpu
    assert chip_smoke.N_POINTS == cfg["TPU"]["POINT_CAP_PER_SCAN"]


def test_cylinder_segtask_targets_the_card_by_default():
    """The Cylinder3D yaml's SegTask asks for the card too, and reads the
    cylinder keys of DATA (it has no VOXEL_SIZE)."""
    import chip_smoke
    if torch.cuda.is_available():
        assert SegTask(chip_smoke.CYL_CFGS, 20).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SegTask(chip_smoke.CYL_CFGS, 20)
    task = SegTask(chip_smoke.CYL_CFGS, 20, device="cpu")
    assert task.cylinder["grid_size"] == (480, 360, 32)
    assert task.caps == [98304, 54144, 29568, 19712, 14848]


def test_fusion_view_is_a_copy_of_the_jax_module():
    """openpcseg_torch/data/fusion_view.py is the JAX package's module
    with a longer docstring: the code after the docstring is the same."""
    def code(path):
        text = path.read_text()
        return text[text.index('"""', 3) + 3:]
    assert code(ROOT / "openpcseg_torch/data/fusion_view.py") == code(
        ROOT / "openpcseg_tpu/data/fusion_view.py")


def test_segtask_targets_the_card_by_default():
    """SegTask without `device` asks for "cuda": with a card its device is
    the card; without one it raises, and never returns a CPU task."""
    cfgs = {"DATA": {"VOXEL_SIZE": 0.05},
            "MODEL": {"NAME": "MinkUNet", "BLOCK": "ResBlock"}}
    assert inspect.signature(SegTask).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert SegTask(cfgs, 20).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SegTask(cfgs, 20)
    assert SegTask(cfgs, 20, device="cpu").device.type == "cpu"


class _CudaFlagged(torch.Tensor):
    """A CPU tensor that reports is_cuda, to reach a wrapper's CUDA branch
    on a machine without a card."""

    @property
    def is_cuda(self):
        return True


def _flag(t):
    return t.as_subclass(_CudaFlagged)


def _calls(rng):
    """One call of each wrapper, with CUDA-flagged kernel-ready operands."""
    f = _flag(torch.zeros(16, 8, dtype=torch.bfloat16))
    d = _flag(torch.zeros(16, 8))
    km27 = torch.full((27, 16), -1, dtype=torch.int32)
    km8 = torch.full((8, 16), -1, dtype=torch.int32)
    plan = build_parity_plan(km8, 16)
    w27 = torch.as_tensor(rng.normal(size=(27, 8, 8)), dtype=torch.float32)
    w8 = torch.as_tensor(rng.normal(size=(8, 8, 8)), dtype=torch.float32)
    idx = torch.full((8, 16), -1, dtype=torch.int32)
    wts = torch.zeros(8, 16)
    tbl = devox_table(idx, wts, 16)
    p2v = p2v_table(torch.full((16,), -1, dtype=torch.int32), 16)
    z = _flag(torch.zeros(16, 8))
    return {
        "strided": lambda: updown.strided_conv(f, w27, km27),
        "strided_bwd": lambda: updown.strided_conv_bwd(d, f, w27, km27,
                                                       km27),
        "strided_dw": lambda: subm_conv.gather_dw(f, km27, f, None,
                                                  counter="strided_dw"),
        "subm": lambda: subm_conv.subm_conv(f, w27, km27),
        "down": lambda: updown.down_conv(f, w8, km8),
        "up": lambda: updown.up_conv(f, w8, km8, plan),
        "devox": lambda: devox.devoxelize(f, idx, wts),
        "subm_bwd": lambda: subm_conv.subm_conv_bwd(d, f, w27, km27),
        "down_bwd": lambda: updown.down_conv_bwd(d, f, w8, km8, km8, plan),
        "up_bwd": lambda: updown.up_conv_bwd(d, f, w8, km8, km8),
        "dw": lambda: subm_conv.gather_dw(f, km27, f, None),
        "devox_bwd": lambda: devox.devoxelize_bwd(f, tbl),
        "vmean": lambda: devox.voxel_sum(z, p2v),
        "vmean_bwd": lambda: devox.point_gather(z, p2v),
    }


@pytest.fixture
def no_library(monkeypatch, tmp_path):
    """No built library, an empty build directory, and device checks that
    accept the flagged CPU tensors."""
    monkeypatch.setattr(cuda_lib, "_LIB", None)
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_lib, "check_cuda", lambda *a, **k: None)
    cuda_lib.reset_counts()
    yield
    cuda_lib.reset_counts()


WRAPPERS = ["subm", "down", "up", "devox", "subm_bwd", "down_bwd", "up_bwd",
            "dw", "devox_bwd", "vmean", "vmean_bwd", "strided", "strided_bwd",
            "strided_dw"]


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_raises_without_nvcc(no_library, monkeypatch, rng, name):
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(cuda_lib, "_find_nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _calls(rng)[name]()
    assert cuda_lib.LAUNCHES[name] == 0
    assert sum(cuda_lib.PLAIN_ON_CUDA.values()) == 0


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_raises_when_nvcc_fails(no_library, monkeypatch, rng, name):
    monkeypatch.setattr(cuda_lib, "_find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(
        cuda_lib.subprocess, "run",
        lambda cmd, **kw: subprocess.CompletedProcess(cmd, 1, "", "error"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _calls(rng)[name]()
    assert cuda_lib.LAUNCHES[name] == 0
    assert sum(cuda_lib.PLAIN_ON_CUDA.values()) == 0


def test_check_cuda_rejects_what_the_kernels_do_not_take():
    cpu = torch.device("cpu")
    x = torch.zeros(4, 6, dtype=torch.bfloat16)
    cuda_lib.check_cuda(x, "x", torch.bfloat16, 2, cpu)
    with pytest.raises(TypeError):
        cuda_lib.check_cuda(x.float(), "x", torch.bfloat16, 2, cpu)
    with pytest.raises(ValueError):
        cuda_lib.check_cuda(x.t(), "x", torch.bfloat16, 2, cpu)
    with pytest.raises(ValueError):
        cuda_lib.check_cuda(x[None], "x", torch.bfloat16, 2, cpu)
    with pytest.raises(ValueError):
        cuda_lib.check_cuda(x, "x", torch.bfloat16, 2, torch.device("meta"))


def test_build_flags_target_sm90a():
    assert "arch=compute_90a,code=sm_90a" in cuda_lib.NVCC_FLAGS
    srcs = {p.name for p in cuda_lib._sources()}
    assert srcs == {"gather_gemm.cu", "parent_gemm.cu", "devox.cu",
                    "gather_dw.cu"}
    assert np.all([(cuda_lib.CSRC / s).read_text().count("OPCS_API") >= 1
                   for s in srcs])
