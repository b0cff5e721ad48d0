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
from torch_threads import one_torch_thread  # noqa: F401

from openpcseg_torch.core.geometry import (build_parity_plan, devox_table,
                                           p2v_table)
from openpcseg_torch.engine.task import SegTask
from openpcseg_torch.ops import (cuda_lib, devox, range_fusion, subm_conv,
                                 updown)

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax_flax_optax_or_yaml():
    """Every module of openpcseg_torch/ (walked, not listed) and
    chip_smoke.py import in one process without jax, flax, optax, yaml or
    the JAX package."""
    code = (
        "import sys, importlib, pkgutil\n"
        "import openpcseg_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "openpcseg_torch.__path__, 'openpcseg_torch.')]\n"
        "for m in names: importlib.import_module(m)\n"
        "assert {'openpcseg_torch.native', 'openpcseg_torch.tools."
        "golden_summary', 'openpcseg_torch.losses.lovasz'} <= set(names)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'yaml', 'openpcseg_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean', len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "clean" in res.stdout


def test_parallel_package_imports_torch_distributed_and_the_port_only():
    """openpcseg_torch/parallel/ (data parallelism and its worker) imports
    torch (torch.distributed among it), numpy, the standard library and
    the port; nothing of the JAX package or jax."""
    import ast

    seen = set()
    for path in sorted((ROOT / "openpcseg_torch/parallel").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                seen |= {a.name for a in node.names}
            elif isinstance(node, ast.ImportFrom) and not node.level:
                seen.add(node.module)
    assert "torch.distributed" in seen
    tops = {m.split(".")[0] for m in seen} - set(sys.stdlib_module_names)
    assert tops == {"numpy", "torch"}, seen


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


def test_chip_smoke_rpvnet_is_the_mk34_cr17_5_config():
    import chip_smoke
    cfg = yaml.safe_load((ROOT / chip_smoke.RPV_ENTRY_CFG).read_text())
    assert chip_smoke.RPV_MODEL_CFG == cfg["MODEL"]
    assert chip_smoke.RPV_TRAIN_CFGS["OPTIM"] == cfg["OPTIM"]
    assert chip_smoke.RPV_CFGS["MODALITY"] == cfg["MODALITY"] == "fusion"
    assert chip_smoke.RPV_CFGS["DATA"]["VOXEL_SIZE"] == cfg["DATA"][
        "VOXEL_SIZE"]
    tpu = {k: v for k, v in cfg["TPU"].items() if k != "COMPUTE_DTYPE"}
    assert chip_smoke.RPV_CFGS["TPU"] == tpu
    assert chip_smoke.N_POINTS == cfg["TPU"]["POINT_CAP_PER_SCAN"]


def test_chip_smoke_waymo_is_the_mk34_cr16_config():
    """chip_smoke.py's Waymo main path is the shipped mk34_cr16 yaml as it
    stands (its _infer twin differs only in the DATA keys of streaming),
    and its kernel shapes come from the yaml's widths; its yaml cells,
    with the yamls its other phases drive, are all 29 shipped yamls."""
    import chip_smoke
    cfg = yaml.safe_load((ROOT / chip_smoke.WAYMO_CFG).read_text())
    assert chip_smoke.WAYMO_MODEL_CFG == cfg["MODEL"]
    assert chip_smoke.WAYMO_TRAIN_CFGS["OPTIM"] == cfg["OPTIM"]
    assert chip_smoke.WAYMO_CFGS["DATA"] == {
        k: cfg["DATA"][k] for k in ("DATASET", "VOXEL_SIZE")}
    tpu = {k: v for k, v in cfg["TPU"].items() if k != "COMPUTE_DTYPE"}
    assert chip_smoke.WAYMO_CFGS["TPU"] == tpu
    infer_cfg = yaml.safe_load((ROOT / chip_smoke.WAYMO_INFER_CFG)
                               .read_text())
    assert infer_cfg["DATA"]["USE_INFER_DATA"]
    assert {k: v for k, v in infer_cfg.items() if k != "DATA"} == {
        k: v for k, v in cfg.items() if k != "DATA"}
    subm, downs, ups, devox = chip_smoke.mink_shapes(cfg["MODEL"])
    assert subm[:3] == [(0, 5, 51), (0, 51, 51), (1, 51, 51)]
    assert (3, 613, 409) in subm and (0, 204, 153) in subm
    assert downs == [(1, 51), (2, 51), (3, 102), (4, 204)]
    assert ups == [(3, 409, 409), (2, 409, 204), (1, 204, 153),
                   (0, 153, 153)]
    assert devox == [(4, 409), (2, 204)]
    shipped = {str(p.relative_to(ROOT))
               for p in ROOT.glob("tools/cfgs/*/*/*.yaml")}
    cells = {p for p, _, _ in chip_smoke.YAML_CELLS}
    driven = {chip_smoke.ENTRY_CFG, chip_smoke.SPV_ENTRY_CFG,
              chip_smoke.CYL_ENTRY_CFG, chip_smoke.RPV_ENTRY_CFG,
              chip_smoke.WAYMO_CFG, chip_smoke.WAYMO_INFER_CFG} | {
        chip_smoke.RANGE_CFG.format(m.lower())
        for m in chip_smoke.RANGE_MODELS}
    assert cells | driven == shipped and len(shipped) == 29


def test_range_fusion_wrappers_take_their_kernels_on_a_cuda_tensor(
        monkeypatch):
    """RPVNet's range fusion on a (flagged) CUDA tensor calls the kernel
    entries under its own counters, never the plain versions."""
    calls = []
    monkeypatch.setattr(cuda_lib, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(cuda_lib, "launch",
                        lambda name, counter, *a: calls.append(
                            (name, counter)))
    pxpy = torch.zeros(16, 2)
    rt = range_fusion.range_tables(pxpy, torch.zeros(16, dtype=torch.int32),
                                   torch.ones(16, dtype=torch.bool), 1, 4, 8,
                                   (1,))[4, 8]
    fmap = _flag(torch.zeros(1, 8, 4, 8))
    range_fusion.sample(fmap, rt)
    range_fusion.scatter_mean(_flag(torch.zeros(16, 8)), rt)
    assert calls == [("opcs_devox_f32", "r2p"), ("opcs_devox_bwd_f32",
                                                 "p2r")]
    assert sum(cuda_lib.PLAIN_ON_CUDA.values()) == 0


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
    pxpy = torch.zeros(16, 2)
    bidx = torch.zeros(16, dtype=torch.int32)
    ok = torch.ones(16, dtype=torch.bool)
    rt = range_fusion.range_tables(pxpy, bidx, ok, 1, 4, 8, (1,))[4, 8]
    fmap = _flag(torch.zeros(32, 8))
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
        "r2p": lambda: devox.devoxelize(fmap, rt.bilinear.idx,
                                        rt.bilinear.weights, "r2p"),
        "r2p_bwd": lambda: devox.devoxelize_bwd(z, rt.bilinear, "r2p_bwd"),
        "p2r": lambda: devox.voxel_sum(z, rt.pixel, "p2r"),
        "p2r_bwd": lambda: devox.point_gather(fmap, rt.pixel, "p2r_bwd"),
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
            "strided_dw", "r2p", "r2p_bwd", "p2r", "p2r_bwd"]


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
