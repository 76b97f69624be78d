"""Learning-rate schedules (port of `optispeech_tpu/training/schedules.py`).

Each schedule maps the optimiser's update count (0 at the first update) to a
learning rate, computed in float32 as the JAX schedule is."""

import numpy as np


def cosine_with_warmup(base_lr: float, num_warmup_steps: int, num_training_steps: int,
                       num_cycles: float = 0.5):
    def schedule(step: int) -> float:
        f = np.float32
        step = f(step)
        warm = f(max(num_warmup_steps, 1))
        # (step+1)/warmup: count 0 already gets base_lr / warmup, not 0
        lin = (step + f(1.0)) / warm
        progress = (step - f(num_warmup_steps)) / f(max(num_training_steps - num_warmup_steps, 1))
        cos = max(f(0.0), f(0.5) * (f(1.0) + np.cos(f(np.pi) * f(num_cycles) * f(2.0) * progress)))
        return float(f(base_lr) * (lin if step < num_warmup_steps else cos))

    return schedule


def make_schedule(cfg_sched, cfg_opt):
    if cfg_sched.kind == "cosine_with_warmup":
        return cosine_with_warmup(cfg_opt.lr, cfg_sched.num_warmup_steps,
                                  cfg_sched.num_training_steps)
    if cfg_sched.kind == "constant":
        return lambda step: cfg_opt.lr
    raise ValueError(f"unknown scheduler kind {cfg_sched.kind}")
