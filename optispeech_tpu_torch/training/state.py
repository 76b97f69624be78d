"""Training state and optimiser (port of `optispeech_tpu/training/state.py`).

`TrainState` holds everything one training run updates: the generator G,
the discriminator D, one optimiser for each, the step count and the RNG.
`Optimizer` is `optax.chain(clip_by_global_norm(clip), adamw(schedule, ...))`
over one module's parameters: the gradients arrive as a list (from
`torch.autograd.grad`), are clipped as optax clips them, and one
`torch.optim.AdamW` step runs at the schedule's rate for the update count.
torch's AdamW applies p * (1 - lr * wd) - lr * u where optax applies
p - lr * (u + wd * p): the same to rounding.
"""

import torch
from torch import nn

from ..config import ExperimentConfig
from ..models.discriminator import VocosDiscriminator, init_discriminator
from ..models.generator import OptiSpeechGenerator
from ..models.init import init_like_flax
from ..utils.device import resolve_device
from .schedules import make_schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


class Optimizer:
    def __init__(self, params, cfg: ExperimentConfig):
        self.params = list(params)
        self.schedule = make_schedule(cfg.scheduler, cfg.optimizer)
        self.max_norm = cfg.train_args.gradient_clip_val
        o = cfg.optimizer
        self.adamw = torch.optim.AdamW(self.params, lr=self.schedule(0), betas=tuple(o.betas),
                                       eps=o.eps, weight_decay=o.weight_decay)
        self.count = 0

    @torch.no_grad()
    def update(self, grads) -> torch.Tensor:
        """Clip `grads` (one per parameter, None for an unused one, which
        counts as zeros as in JAX), take one AdamW step, and return the
        global norm before clipping."""
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        norm = global_norm(grads)
        # optax: t if norm < max else (t / norm) * max, with no epsilon
        keep = norm < self.max_norm
        for p, g in zip(self.params, grads):
            p.grad = torch.where(keep, g, g / norm * self.max_norm)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.count += 1
        return norm


class TrainState:
    def __init__(self, cfg: ExperimentConfig, generator: nn.Module, discriminator: nn.Module,
                 rng: torch.Generator):
        if cfg.train_args.gradient_accumulate_batches:
            raise NotImplementedError(
                "gradient_accumulate_batches (optax.MultiSteps) is not ported yet "
                "(ROADMAP.md, queue A)")
        self.generator = generator
        self.discriminator = discriminator
        self.g_opt = Optimizer(generator.parameters(), cfg)
        self.d_opt = Optimizer(discriminator.parameters(), cfg)
        self.step = 0
        self.rng = rng


def init_train_state(cfg: ExperimentConfig, device=None, seed: int = 0) -> TrainState:
    """Fresh G and D on `device` (default: the card; raises when there is
    none) from `seed` (flax's distributions; D's weight-norm scales set to
    ||v||), and the step RNG on the same device."""
    generator = OptiSpeechGenerator(cfg.generator)
    init_like_flax(generator, torch.Generator().manual_seed(seed))
    discriminator = VocosDiscriminator(cfg.discriminator, cfg.generator.features)
    init_discriminator(discriminator, torch.Generator().manual_seed(seed + 1))
    device = resolve_device(device)
    return TrainState(cfg, generator.to(device), discriminator.to(device),
                      torch.Generator(device=device).manual_seed(seed))
