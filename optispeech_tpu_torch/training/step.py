"""The GAN training and validation steps (port of
`optispeech_tpu/training/step.py::make_train_step` and `make_val_step`).

One call runs, in order:
- the generator update on loss = AM loss + adversarial loss, where the
  adversarial branch (hinge, feature matching, mel L1, MR-STFT through D)
  runs only once `step // accum >= pretraining_steps`. The gradient is taken
  with respect to G's parameters alone (`torch.autograd.grad`), as JAX
  differentiates with respect to `g_params`: D's `.grad` is never filled;
- the discriminator update, under the same gate, on the G turn's waveforms,
  detached (`cache_generator_outputs=True`), or on waveforms of a second G
  forward without gradients, through the updated G, with the step RNG
  rewound so that it draws the same dropout masks and segment starts
  (`cache_generator_outputs=False`, JAX's recompute branch).
The batch is a dict of tensors on the state's device, in either form of the
JAX step: `wav_seg` + `start_idx` (segment starts sampled on the host) or the
full `wav` (starts drawn from the state's RNG). The log keys are JAX's.

The validation step runs G's forward with the duration extraction kernel
(no gradient) and D's mel + MR-STFT losses, under `torch.no_grad()` with
both in eval mode.

With G in bf16 (`train_args.compute_dtype: bfloat16`) the steps are the
same: G returns `wav_hat` in float32, so D, which computes in float32, and
the losses see float32, as in JAX.
"""

import torch

from ..config import ExperimentConfig
from ..ops.segments import get_segments
from .state import TrainState

ADV_KEYS = ("loss_gen_mp", "loss_gen_mrd", "loss_fm_mp", "loss_fm_mrd", "mel_loss",
            "mr_stft_loss")


def _generator_turn(gen, disc, batch, hop, rng, adversarial: bool, **kw):
    """G's forward on `batch`, the matching ground-truth crop, and D's
    adversarial losses when `adversarial` (zeros otherwise). Returns
    (generator outputs, wav, adversarial loss, its log)."""
    host_seg = "wav_seg" in batch
    out = gen(batch["x"], batch["x_lengths"], batch["mel"].float(), batch["mel_lengths"],
              batch["pitches"], batch["energies"], batch.get("sids"), batch.get("lids"),
              start_idx=batch["start_idx"] if host_seg else None, generator=rng, **kw)
    if host_seg:
        wav = batch["wav_seg"]
    else:
        # the generator's segment size is clamped to the mel bucket
        wav = get_segments(batch["wav"][:, None, :], out["start_idx"] * hop,
                           out["segment_size"] * hop)[:, 0, :]
    if adversarial:
        adv_loss, adv_log = disc.forward_gen(wav, out["wav_hat"])
    else:
        zero = torch.zeros((), device=wav.device)
        adv_loss, adv_log = zero, {k: zero for k in ADV_KEYS}
    return out, wav, adv_loss, adv_log


def make_train_step(cfg: ExperimentConfig):
    """Returns `train_step(state, batch) -> logs`, which updates `state` in
    place and returns a dict of 0-d tensors."""
    cache = cfg.train_args.cache_generator_outputs
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
        rng_before = None if cache else state.rng.get_state()
        out, wav, adv_loss, adv_log = _generator_turn(gen, disc, batch, hop, state.rng,
                                                      train_disc)
        wav_hat = out["wav_hat"]
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

        # ---- discriminator update ------------------------------------------
        if train_disc:
            if not cache:
                # the same draws as the G turn leave the RNG where it was
                rng_after = state.rng.get_state()
                state.rng.set_state(rng_before)
                with torch.no_grad():
                    recomputed, wav, _, _ = _generator_turn(gen, disc, batch, hop, state.rng,
                                                            False)
                wav_hat = recomputed["wav_hat"]
                state.rng.set_state(rng_after)
            d_loss, d_log = disc.forward_disc(wav.detach(), wav_hat.detach())
            d_grads = torch.autograd.grad(d_loss, state.d_opt.params, allow_unused=True)
            d_gnorm = state.d_opt.update(d_grads)
        else:
            zero = torch.zeros((), device=wav_hat.device)
            d_loss, d_log, d_gnorm = zero, {"loss_mp": zero, "loss_mrd": zero}, zero
        logs["total_loss/discriminator"] = d_loss
        logs.update({f"discriminator/{k}": v for k, v in d_log.items()})
        logs["grad_norm/discriminator"] = d_gnorm
        state.step += 1
        return {k: v.detach() for k, v in logs.items()}

    return train_step


def make_val_step(cfg: ExperimentConfig):
    """Returns `val_step(state, batch, rng) -> (logs, wav, wav_hat)`: the
    validation forward of JAX's `make_val_step`, whose MAS is the duration
    extraction kernel. `rng` (a `torch.Generator` on the state's device)
    draws the segment starts of a batch in the `wav` form; the `wav_seg`
    form needs none. G and D are left in eval mode."""
    hop = cfg.generator.features.hop_length

    @torch.no_grad()
    def val_step(state: TrainState, batch: dict, rng: torch.Generator | None = None):
        gen, disc = state.generator, state.discriminator
        gen.eval()
        disc.eval()
        if "wav_seg" not in batch and rng is None:
            raise ValueError("a batch with the full `wav` needs an `rng` for its segments")
        out, wav, _, _ = _generator_turn(gen, disc, batch, hop, rng, False,
                                         extract_durations=True)
        val_loss, val_log = disc.forward_val(wav, out["wav_hat"])
        logs = {
            "total_loss/val_am_loss": out["loss"],
            "total_loss/val_gen_adv_loss": val_loss,
            "gen_subloss/val_align_loss": out["align_loss"],
            "gen_subloss/val_duration_loss": out["duration_loss"],
            "gen_subloss/val_pitch_loss": out["pitch_loss"],
            "gen_subloss/val_energy_loss": out["energy_loss"],
            **{f"gen_adv_loss/val_{k}": v for k, v in val_log.items()},
            "total_loss/val_total": out["loss"] + val_loss,
        }
        return logs, wav, out["wav_hat"]

    return val_step
