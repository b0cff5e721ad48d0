"""The system under test: the port's SegTask built from a configuration
file, holding the benchmark's weights. Only the harness imports this."""
from __future__ import annotations

from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def cfgs_of(config: Dict, train: bool) -> Dict:
    """The yaml blocks the port reads, as the configuration file holds
    them (the OPTIM block only for training)."""
    blocks = ("MODALITY", "DATA", "MODEL", "TPU") + (("OPTIM",) if train
                                                     else ())
    return {k: config[k] for k in blocks if k in config}


def build_task(config: Dict, weights: Dict[str, torch.Tensor], device,
               batch: int, train: bool, seed: int):
    """SegTask over a model of the configuration that holds `weights`
    (name -> tensor, the program's checkpoint names)."""
    from openpcseg_torch.engine.task import SegTask
    from openpcseg_torch.models import build_segmentor

    cdt = DTYPES[config["compute_dtype"]]
    model = build_segmentor(config["MODEL"], config["num_class"],
                            compute_dtype=cdt).to(device)
    missing = set(model.state_dict()) ^ set(weights)
    if missing:
        raise ValueError(f"the weights and the model differ in {sorted(missing)}")
    model.load_state_dict(weights)
    model.eval()
    kw = {}
    if train:
        kw["iters_per_epoch"] = config["train_scans"] // batch
    return SegTask(cfgs_of(config, train), config["num_class"],
                   compute_dtype=cdt, device=device, seed=seed,
                   batch_per_device=batch, model=model, **kw)
