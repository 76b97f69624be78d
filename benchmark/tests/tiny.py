"""Test-width copies of the benchmark's configurations and cells, for the
CPU tests: every feature of a configuration kept, its widths and depths cut."""

import copy
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import common  # noqa: E402

common.checkout_env()

TINY_GENERATOR = {
    "dim": 32,
    "encoder": {"intermediate_dim": 64, "num_layers": 2, "linear_units": 64, "num_blocks": 2},
    "decoder": {"intermediate_dim": 64, "num_layers": 2, "linear_units": 64, "num_blocks": 2},
    "duration_predictor": {"intermediate_dim": 48},
    "pitch_predictor": {"intermediate_dim": 32, "num_layers": 2},
    "energy_predictor": {"intermediate_dim": 48},
    "vocoder": {"dim": 48, "intermediate_dim": 96, "num_layers": 2},
    "segment_size": 16,
}
TINY_DISCRIMINATOR = {"periods": [2, 3], "mrd_channels": 16}


def _merge(dst, src):
    for k, v in src.items():
        if isinstance(v, dict):
            _merge(dst[k], v)
        else:
            dst[k] = v


def tiny_config(name: str) -> dict:
    cfg = copy.deepcopy(common.config(name))
    _merge(cfg["config"]["generator"], TINY_GENERATOR)
    _merge(cfg["config"]["discriminator"], TINY_DISCRIMINATOR)
    return cfg


def tiny_workload(cell: str, **params) -> dict:
    w = copy.deepcopy(common.workload(cell))
    w["params"].update(params)
    return w


def context(cell: str, seed: int = 5, control: bool = False, logs=None, **params):
    w = tiny_workload(cell, **params)
    log = (lambda m: logs.append(m)) if logs is not None else (lambda m: None)
    return common.Context(cell=cell, workload=w, config=tiny_config(w["config"]), seed=seed,
                          device="cpu", control=control, log=log)
