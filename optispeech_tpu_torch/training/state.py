"""Training state and optimiser (port of `optispeech_tpu/training/state.py`).

`TrainState` holds everything one training run updates: the generator G,
the discriminator D, one optimiser for each, the step count and the RNG.
`Optimizer` is `optax.chain(clip_by_global_norm(clip), adamw(schedule, ...))`
over one module's parameters: the gradients arrive as a list (from
`torch.autograd.grad`), are clipped as optax clips them, and one
`torch.optim.AdamW` step runs at the schedule's rate for the update count.
torch's AdamW applies p * (1 - lr * wd) - lr * u where optax applies
p - lr * (u + wd * p): the same to rounding.

With `gradient_accumulate_batches` k (the `optax.MultiSteps` role) each call
folds its gradients into a running mean, `acc + (g - acc) / (n + 1)` as
optax does, and every k-th call clips and applies that mean; the other calls
leave the parameters unchanged, and the schedule advances once per applied
update. `state_dict` / `load_state_dict` carry everything a resume needs.
"""

import torch
from torch import nn

from ..config import ExperimentConfig
from ..models.discriminator import VocosDiscriminator, init_discriminator
from ..models.generator import OptiSpeechGenerator, compute_dtype
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
        self.count = 0  # applied updates: the schedule's step
        self.every = cfg.train_args.gradient_accumulate_batches or 1
        self.mini_step = 0  # calls folded into `acc` since the last update
        self.acc = ([torch.zeros_like(p) for p in self.params] if self.every > 1 else None)

    @torch.no_grad()
    def update(self, grads) -> torch.Tensor:
        """Take `grads` (one per parameter, None for an unused one, which
        counts as zeros as in JAX); clip them and take one AdamW step, or
        under accumulation fold them into the mean and apply that every k-th
        call. Returns the global norm of `grads` before clipping."""
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        norm = global_norm(grads)
        if self.acc is None:
            self._apply(grads, norm)
            return norm
        for acc, g in zip(self.acc, grads):
            acc.add_((g - acc) / (self.mini_step + 1))
        self.mini_step += 1
        if self.mini_step == self.every:
            self._apply(self.acc, global_norm(self.acc))
            for acc in self.acc:
                acc.zero_()
            self.mini_step = 0
        return norm

    def _apply(self, grads, norm):
        # optax: t if norm < max else (t / norm) * max, with no epsilon
        keep = norm < self.max_norm
        for p, g in zip(self.params, grads):
            p.grad = torch.where(keep, g, g / norm * self.max_norm)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.count += 1

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: dict):
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        if (state["acc"] is None) != (self.acc is None):
            raise ValueError("the checkpoint's gradient accumulation differs from the config's")
        if self.acc is not None:
            for acc, saved in zip(self.acc, state["acc"]):
                acc.copy_(saved)


class TrainState:
    def __init__(self, cfg: ExperimentConfig, generator: nn.Module, discriminator: nn.Module,
                 rng: torch.Generator):
        self.generator = generator
        self.discriminator = discriminator
        self.g_opt = Optimizer(generator.parameters(), cfg)
        self.d_opt = Optimizer(discriminator.parameters(), cfg)
        self.step = 0  # micro-batches
        self.rng = rng

    def state_dict(self) -> dict:
        """Everything a resume needs, as references to the live tensors."""
        return {"generator": self.generator.state_dict(),
                "discriminator": self.discriminator.state_dict(),
                "g_opt": self.g_opt.state_dict(), "d_opt": self.d_opt.state_dict(),
                "step": self.step, "rng": self.rng.get_state()}

    def load_state_dict(self, state: dict):
        self.generator.load_state_dict(state["generator"])
        self.discriminator.load_state_dict(state["discriminator"])
        self.g_opt.load_state_dict(state["g_opt"])
        self.d_opt.load_state_dict(state["d_opt"])
        self.step = int(state["step"])
        self.rng.set_state(state["rng"])


# the step RNG of data-parallel rank r is seeded with seed + r * RANK_SEED_STRIDE
RANK_SEED_STRIDE = 7919


def init_train_state(cfg: ExperimentConfig, device=None, seed: int = 0,
                     rank: int = 0) -> TrainState:
    """Fresh G and D on `device` (default: the card; raises when there is
    none) from `seed` (flax's distributions; D's weight-norm scales set to
    ||v||), and the step RNG on the same device. G computes in
    `train_args.compute_dtype`, D in float32, as in JAX; both keep float32
    parameters.

    Data-parallel rank `rank` gets the same G and D and a step RNG of its
    own, seeded with `seed + rank * RANK_SEED_STRIDE`, so that the ranks'
    dropout masks and device-drawn segment starts differ as the rows of
    JAX's global draw do; rank 0's is the RNG of a run without a group."""
    generator = OptiSpeechGenerator(cfg.generator,
                                    dtype=compute_dtype(cfg.train_args.compute_dtype))
    init_like_flax(generator, torch.Generator().manual_seed(seed))
    discriminator = VocosDiscriminator(cfg.discriminator, cfg.generator.features)
    init_discriminator(discriminator, torch.Generator().manual_seed(seed + 1))
    device = resolve_device(device)
    return TrainState(cfg, generator.to(device), discriminator.to(device),
                      torch.Generator(device=device).manual_seed(seed + rank * RANK_SEED_STRIDE))
