"""Training in bf16 (`train_args.compute_dtype: bfloat16`), port against the
JAX package on the CPU: `tiny_experiment()`'s sizes, every dropout and
drop-path rate at 0, segment starts sampled on the host, the same weights in
both. The generators compute in bf16, the discriminators in float32.

MAS reads float32 log-probs in both, so the durations it extracts are
asserted equal, in the training forward (B3's twin) and in the validation
forward (B4's twin). The logs are held to `LOG_RTOL`, one rtol per log: the
bf16 forward and its bf16 cotangents differ between torch and XLA by a bf16
step on some elements (tests/test_torch_bf16.py), so the logs move far more
than the float32 step's 1e-4; each bound is about three times the largest
difference measured.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optispeech_tpu.training.step import make_train_step as jax_make_train_step
from optispeech_tpu.training.step import make_val_step as jax_make_val_step
from optispeech_tpu_torch.training.step import make_train_step, make_val_step
from test_train_step import tiny_experiment
from torch_parity import no_dropout, to_torch_config, train_batch, train_setup

torch.set_num_threads(1)

# per log, about 3x the relative difference measured on this step
LOG_RTOL = {
    "discriminator/loss_mp": 1e-4,
    "discriminator/loss_mrd": 1e-4,
    "gen_adv_loss/train_loss_fm_mp": 1e-4,
    "gen_adv_loss/train_loss_fm_mrd": 2e-4,
    "gen_adv_loss/train_loss_gen_mp": 1e-4,
    "gen_adv_loss/train_loss_gen_mrd": 1e-4,
    "gen_adv_loss/train_mel_loss": 5e-4,
    "gen_adv_loss/train_mr_stft_loss": 5e-4,
    "gen_subloss/train_align_loss": 2e-4,
    "gen_subloss/train_duration_loss": 5e-4,
    "gen_subloss/train_energy_loss": 2e-4,
    "gen_subloss/train_pitch_loss": 3e-3,
    "grad_norm/discriminator": 2e-3,
    "grad_norm/generator": 1.2e-2,
    "total_loss/discriminator": 1e-4,
    "total_loss/generator": 3e-4,
    "total_loss/train_am_loss": 3e-4,
    "total_loss/train_gen_adv_loss": 5e-4,
}
# the validation forward: no update; measured <= 7.8e-4 (the pitch loss)
VAL_RTOL = 5e-3


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def setup():
    cfg = no_dropout(tiny_experiment(pretraining_steps=0))
    jgen, jdisc, jstate, state = train_setup(cfg, bf16=True)
    return dict(cfg=cfg, tcfg=to_torch_config(cfg), jgen=jgen, jdisc=jdisc, jstate=jstate,
                state=state, batch=train_batch(np.random.default_rng(0), cfg))


def test_generator_computes_in_bf16_with_float32_parameters(setup):
    state = setup["state"]
    assert state.generator.compute_dtype == torch.bfloat16
    assert {p.dtype for p in state.generator.parameters()} == {torch.float32}
    assert {p.dtype for p in state.discriminator.parameters()} == {torch.float32}


def test_training_forward_mas_durations_equal_jax(setup):
    """The generator's training forward in bf16: MAS (B3's twin) on float32
    log-probs gives the durations of JAX's jitted forward, and the AM losses
    agree."""
    jgen, jstate, batch, state = setup["jgen"], setup["jstate"], setup["batch"], setup["state"]
    keys = ("x", "x_lengths", "mel", "mel_lengths", "pitches", "energies", "start_idx")

    def forward(params, *args):
        return jgen.apply({"params": params}, **dict(zip(keys, args)), deterministic=True)

    args = [jnp.asarray(batch[k]) for k in keys]
    jitted = jax.jit(forward)(jstate.g_params, *args)
    t = _torch_batch(batch)
    state.generator.train()
    with torch.no_grad():
        out = state.generator(*(t[k] for k in keys[:-1]), start_idx=t["start_idx"])
    assert out["wav_hat"].dtype == torch.float32
    np.testing.assert_array_equal(out["durations"].numpy(), np.asarray(jitted["durations"]))
    for k in ("align_loss", "duration_loss", "pitch_loss", "energy_loss"):
        np.testing.assert_allclose(float(out[k]), float(jitted[k]), rtol=VAL_RTOL, err_msg=k)


def test_train_step_logs_match_jax(setup):
    """One GAN step (G turn, D turn, both AdamW updates) against JAX's bf16
    step, each log within its rtol; the parameters stay float32 after it."""
    cfg, batch = setup["cfg"], setup["batch"]
    jgen, jdisc, jstate = setup["jgen"], setup["jdisc"], setup["jstate"]
    from optispeech_tpu_torch.training.state import TrainState

    fresh = setup["state"]  # left unchanged for the other tests
    state = TrainState(setup["tcfg"], copy.deepcopy(fresh.generator),
                       copy.deepcopy(fresh.discriminator), torch.Generator().manual_seed(0))
    jnew, jlogs = jax_make_train_step(cfg, jgen, jdisc)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    logs = make_train_step(setup["tcfg"])(state, _torch_batch(batch))
    assert set(logs) == set(jlogs) == set(LOG_RTOL)
    for k in sorted(jlogs):
        want, got = float(jlogs[k]), float(logs[k])
        print(f"{k}: jax {want:.6e} port {got:.6e} rel {abs(got - want) / abs(want):.2e}")
        np.testing.assert_allclose(got, want, rtol=LOG_RTOL[k], err_msg=k)
    assert {p.dtype for p in state.generator.parameters()} == {torch.float32}
    assert all(torch.isfinite(p).all() for p in state.generator.parameters())


def test_val_step_matches_jax(setup):
    """The validation forward (B4's twin) in bf16: each log within VAL_RTOL,
    wav_hat float32 and within one bf16 step of max|wav_hat|."""
    cfg, batch, state = setup["cfg"], setup["batch"], setup["state"]
    jlogs, _, jwav_hat = jax_make_val_step(cfg, setup["jgen"], setup["jdisc"])(
        setup["jstate"], {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    logs, _, wav_hat = make_val_step(setup["tcfg"])(state, _torch_batch(batch))
    assert set(logs) == set(jlogs)
    for k in sorted(jlogs):
        want, got = float(jlogs[k]), float(logs[k])
        print(f"{k}: jax {want:.6e} port {got:.6e} rel {abs(got - want) / abs(want):.2e}")
        np.testing.assert_allclose(got, want, rtol=VAL_RTOL, err_msg=k)
    assert wav_hat.dtype == torch.float32
    jwav_hat = np.asarray(jwav_hat)
    np.testing.assert_allclose(wav_hat.numpy(), jwav_hat, rtol=0,
                               atol=2.0 ** -7 * np.abs(jwav_hat).max())
