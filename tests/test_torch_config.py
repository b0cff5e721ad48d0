"""The port's config reader (openpcseg_torch/config.py) against the JAX
package's yaml-based one: the same dicts for every shipped config, the same
overrides, and a raise naming the file and line outside the YAML subset it
reads."""
import textwrap
from pathlib import Path

import pytest
import yaml
from torch_threads import one_torch_thread  # noqa: F401

from openpcseg_tpu import config as jax_config
from openpcseg_torch.config import (CfgDict, ConfigError, cfg_from_list,
                                    cfg_from_yaml_file, load_yaml,
                                    load_yaml_file, log_config_to_file)

ROOT = Path(__file__).resolve().parents[1]
CFG_FILES = sorted((ROOT / "tools" / "cfgs").rglob("*.yaml"))


def test_every_shipped_config_is_found():
    assert len(CFG_FILES) >= 25


@pytest.mark.parametrize("path", CFG_FILES,
                         ids=lambda p: str(p.relative_to(ROOT / "tools")))
def test_shipped_config_reads_as_yaml_and_jax_read_it(path):
    assert load_yaml_file(path) == yaml.safe_load(path.read_text())
    got = cfg_from_yaml_file(path)
    want = jax_config.cfg_from_yaml_file(path)
    assert got == want
    assert got.TAG == want.TAG and got.EXP_GROUP_PATH == want.EXP_GROUP_PATH
    assert isinstance(got.MODEL, CfgDict)


def test_base_config_inheritance_matches_jax(tmp_path):
    base = tmp_path / "base.yaml"
    base.write_text(textwrap.dedent("""
        MODEL:
            NAME: MinkUNet
            cr: 1.0
        OPTIM:
            LR_PER_SAMPLE: 0.02   # a comment
    """))
    child = tmp_path / "cfgs" / "voxel" / "child.yaml"
    child.parent.mkdir(parents=True)
    child.write_text(f"_BASE_CONFIG_: {base}\nMODEL:\n    cr: 0.5\n")
    got = cfg_from_yaml_file(child)
    assert got == jax_config.cfg_from_yaml_file(child)
    assert got.MODEL.NAME == "MinkUNet" and got.MODEL.cr == 0.5
    assert got.OPTIM.LR_PER_SAMPLE == 0.02
    assert (got.TAG, got.EXP_GROUP_PATH) == ("child", "voxel")


OVERRIDES = ["MODEL.cr", "0.25", "OPTIM.LR", "1e-3", "MODEL.NUM_LAYER",
             "[3,4]", "NEW.KEY", "hello", "TPU.COMPUTE_DTYPE", "float32",
             "DATA.TTA", "true", "DATA.DATA_PATH", "/data/kitti/sequences",
             "DATA.SPLIT", "{'train': 'train'}", "OPTIM.NESTEROV", "False"]


def test_overrides_match_jax():
    base = {"MODEL": {"cr": 1.0, "NUM_LAYER": [1, 2]}, "OPTIM": {"LR": 0.1}}
    got, want = CfgDict(base), jax_config.CfgDict(base)
    cfg_from_list(OVERRIDES, got)
    jax_config.cfg_from_list(OVERRIDES, want)
    assert got == want
    assert got.MODEL.cr == 0.25 and got.OPTIM.LR == 1e-3
    assert got.MODEL.NUM_LAYER == [3, 4] and got.NEW.KEY == "hello"
    assert got.DATA.TTA is True and got.OPTIM.NESTEROV is False


def test_override_type_mismatch_and_odd_list_raise():
    cfg = CfgDict({"MODEL": {"NUM_LAYER": [1, 2]}})
    with pytest.raises(ValueError, match="type mismatch"):
        cfg_from_list(["MODEL.NUM_LAYER", "7"], cfg)
    with pytest.raises(ValueError, match="pairs"):
        cfg_from_list(["MODEL.cr"], cfg)


def test_scalars_and_flow_values():
    got = load_yaml(textwrap.dedent("""
        A:
            i: -3
            f: 0.0001
            e: 1e-4
            dot: 0.
            t: True
            n: None
            q: 'it''s # not a comment'
            d: "a\\"b"
            s: data_root/SemanticKITTI/sequences/
            l: [ 0, -180, -4 ]
            m: {'train': 'train', 'test': ['val']}
            empty:
        B: {}
    """))
    assert got == {"A": {"i": -3, "f": 1e-4, "e": 1e-4, "dot": 0.0,
                         "t": True, "n": None, "q": "it's # not a comment",
                         "d": 'a"b', "s": "data_root/SemanticKITTI/sequences/",
                         "l": [0, -180, -4],
                         "m": {"train": "train", "test": ["val"]},
                         "empty": None}, "B": {}}
    assert load_yaml("") == {}


@pytest.mark.parametrize("text,line,what", [
    ("A:\n  - 1\n", 2, "block lists"),
    ("A: yes\n", 1, "outside the config subset"),
    ("A: 010\n", 1, "leading 0"),
    ("A:\n\tB: 1\n", 2, "tab"),
    ("A: 1\n    B: 2\n", 2, "indentation"),
    ("A: &anchor 1\n", 1, "outside the config subset"),
    ("A: [1, 2\n", 1, "expected ','"),
    ("A: 1\nA: 2\n", 2, "duplicate key"),
    ("---\nA: 1\n", 1, "document markers"),
    ("A: |\n  text\n", 1, "outside the config subset"),
    ("A: 'open\n", 1, "unterminated"),
])
def test_outside_the_subset_raises_with_file_and_line(tmp_path, text, line,
                                                      what):
    path = tmp_path / "bad.yaml"
    path.write_text(text)
    with pytest.raises(ConfigError, match=f"bad.yaml:{line}: .*{what}"):
        cfg_from_yaml_file(path)


def test_log_config_matches_jax():
    cfg = cfg_from_yaml_file(CFG_FILES[0])
    got, want = [], []

    class Sink:
        def __init__(self, out):
            self.info = out.append
    log_config_to_file(cfg, logger=Sink(got))
    jax_config.log_config_to_file(jax_config.cfg_from_yaml_file(
        CFG_FILES[0]), logger=Sink(want))
    assert got == want and len(got) > 10


def test_cylinder_yaml_builds_the_task_jax_builds():
    """The Cylinder3D yaml through the port's reader: its SegTask reads
    the cylinder keys (the yaml has no VOXEL_SIZE) and gets JAX's grid,
    caps and geometry schedule."""
    from openpcseg_tpu.engine import SegTask as JaxSegTask
    from openpcseg_torch.engine.task import SegTask

    path = ROOT / "tools/cfgs/voxel/semantic_kitti/cylinder_cy480_cr10.yaml"
    cfgs = cfg_from_yaml_file(path)
    assert "VOXEL_SIZE" not in cfgs.DATA
    task = SegTask(cfgs, 20, device="cpu", batch_per_device=2)
    want = JaxSegTask(jax_config.cfg_from_yaml_file(path), num_class=20,
                      batch_per_device=2)
    assert task.caps == want.caps
    assert (task.cylinder["space_min"], task.cylinder["space_max"],
            task.cylinder["grid_size"]) == (
        want.cyl_space_min, want.cyl_space_max, want.cyl_grid)
    spec = dict(want.geom_spec)
    assert task.geometry == {k: spec[k] for k in task.geometry}
    assert task.point_input and type(task.model).__name__ == "Cylinder_TS"
