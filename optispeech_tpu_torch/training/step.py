"""The GAN training step (port of `optispeech_tpu/training/step.py::make_train_step`).

One call runs, in order:
- the generator update on loss = AM loss + adversarial loss, where the
  adversarial branch (hinge, feature matching, mel L1, MR-STFT through D)
  runs only once `step // accum >= pretraining_steps`. The gradient is taken
  with respect to G's parameters alone (`torch.autograd.grad`), as JAX
  differentiates with respect to `g_params`: D's `.grad` is never filled;
- the discriminator update on the G turn's waveforms, detached
  (`cache_generator_outputs=True`), under the same gate.
The batch is a dict of tensors on the state's device, in either form of the
JAX step: `wav_seg` + `start_idx` (segment starts sampled on the host) or the
full `wav` (starts drawn from the state's RNG). The log keys are JAX's.
"""

import torch

from ..config import ExperimentConfig
from ..ops.segments import get_segments
from .state import TrainState

ADV_KEYS = ("loss_gen_mp", "loss_gen_mrd", "loss_fm_mp", "loss_fm_mrd", "mel_loss",
            "mr_stft_loss")


def make_train_step(cfg: ExperimentConfig):
    """Returns `train_step(state, batch) -> logs`, which updates `state` in
    place and returns a dict of 0-d tensors."""
    if not cfg.train_args.cache_generator_outputs:
        raise NotImplementedError("the recompute branch (cache_generator_outputs=False) "
                                  "is not ported yet (ROADMAP.md, queue A)")
    hop = cfg.generator.features.hop_length
    pretraining_steps = cfg.train_args.pretraining_steps
    # `state.step` counts micro-batches, `pretraining_steps` optimiser steps
    accum = cfg.train_args.gradient_accumulate_batches or 1

    def train_step(state: TrainState, batch: dict) -> dict:
        gen, disc = state.generator, state.discriminator
        gen.train()
        disc.train()
        train_disc = state.step // accum >= pretraining_steps

        # ---- generator update ----------------------------------------------
        host_seg = "wav_seg" in batch
        out = gen(batch["x"], batch["x_lengths"], batch["mel"].float(), batch["mel_lengths"],
                  batch["pitches"], batch["energies"], batch.get("sids"), batch.get("lids"),
                  start_idx=batch["start_idx"] if host_seg else None, generator=state.rng)
        wav_hat = out["wav_hat"]
        if host_seg:
            wav = batch["wav_seg"]
        else:
            # the generator's segment size is clamped to the mel bucket
            wav = get_segments(batch["wav"][:, None, :], out["start_idx"] * hop,
                               out["segment_size"] * hop)[:, 0, :]
        zero = torch.zeros((), device=wav_hat.device)
        if train_disc:
            adv_loss, adv_log = disc.forward_gen(wav, wav_hat)
        else:
            adv_loss, adv_log = zero, {k: zero for k in ADV_KEYS}
        loss = out["loss"] + adv_loss
        g_grads = torch.autograd.grad(loss, state.g_opt.params, allow_unused=True)
        logs = {
            "total_loss/train_am_loss": out["loss"],
            "total_loss/train_gen_adv_loss": adv_loss,
            "total_loss/generator": loss,
            "gen_subloss/train_align_loss": out["align_loss"],
            "gen_subloss/train_duration_loss": out["duration_loss"],
            "gen_subloss/train_pitch_loss": out["pitch_loss"],
            "gen_subloss/train_energy_loss": out["energy_loss"],
            **{f"gen_adv_loss/train_{k}": v for k, v in adv_log.items()},
        }
        logs["grad_norm/generator"] = state.g_opt.update(g_grads)

        # ---- discriminator update on the cached, detached waveforms --------
        if train_disc:
            d_loss, d_log = disc.forward_disc(wav.detach(), wav_hat.detach())
            d_grads = torch.autograd.grad(d_loss, state.d_opt.params, allow_unused=True)
            d_gnorm = state.d_opt.update(d_grads)
        else:
            d_loss, d_log, d_gnorm = zero, {"loss_mp": zero, "loss_mrd": zero}, zero
        logs["total_loss/discriminator"] = d_loss
        logs.update({f"discriminator/{k}": v for k, v in d_log.items()})
        logs["grad_norm/discriminator"] = d_gnorm
        state.step += 1
        return {k: v.detach() for k, v in logs.items()}

    return train_step
