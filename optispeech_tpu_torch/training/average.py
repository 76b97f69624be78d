"""Generator checkpoint averaging (port of `optispeech_tpu/training/average.py`).

A GAN generator orbits the adversarial equilibrium instead of settling on
it, so its last checkpoint is one noisy sample of that orbit. The mean of
the generator weights over the last N retained training checkpoints is a
smoother that needs no retraining (tail averaging). Only the generator is
averaged: the discriminator and the optimiser states have no role in an
inference checkpoint.
"""

import json
import os

import torch

from ..config import ExperimentConfig, from_dict
from .checkpoint import TrainCheckpointManager


def load_run_config(ckpt_dir: str) -> ExperimentConfig:
    """The experiment config `TrainCheckpointManager` wrote beside its
    numbered step directories."""
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        return from_dict(ExperimentConfig, json.load(f)["config"])


def average_generator_params(ckpt_dir: str, steps=None, last_n: int = 5):
    """The mean of the generator's state dict over `steps` (default: the
    last `last_n` retained steps), summed in float64 on the host in step
    order and cast back to each tensor's stored dtype. Returns (averaged
    state dict, steps used, the newest step's whole saved state), the last
    so that a caller can reuse its discriminator without reading it again."""
    ckpt_dir = os.path.abspath(os.path.expanduser(ckpt_dir))
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    manager = TrainCheckpointManager(ckpt_dir)
    all_steps = manager.all_steps()
    if not all_steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    steps = sorted(int(s) for s in (all_steps[-last_n:] if steps is None else steps))
    missing = [s for s in steps if s not in all_steps]
    if missing:
        raise ValueError(f"steps {missing} not retained; available: {all_steps}")

    acc, last_raw = None, None
    for s in steps:
        last_raw, _ = manager.read(s)
        g = last_raw["generator"]
        acc = ({k: v.double() for k, v in g.items()} if acc is None
               else {k: acc[k] + v.double() for k, v in g.items()})
    avg = {k: (v / len(steps)).to(last_raw["generator"][k].dtype) for k, v in acc.items()}
    return avg, steps, last_raw
