"""The port's validation step (training/step.py::make_val_step, whose MAS is
the duration extraction) against the JAX package's `make_val_step` on the
CPU: `tiny_experiment()`'s sizes, every dropout and drop-path rate at 0, the
same weights in both.

Tolerances: every log rtol 1e-5 (float32 with other summation orders; one
forward, no update), `wav` and `wav_hat` atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optispeech_tpu.training.step import make_val_step as jax_make_val_step
from optispeech_tpu_torch.training.step import make_val_step
from test_train_step import tiny_experiment
from torch_parity import no_dropout, to_torch_config, train_batch, train_setup

torch.set_num_threads(1)

LOG_RTOL = 1e-5
WAV_ATOL = 1e-5


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def setup():
    cfg = no_dropout(tiny_experiment(pretraining_steps=0))
    jgen, jdisc, jstate, state = train_setup(cfg)
    return dict(cfg=cfg, tcfg=to_torch_config(cfg), jstep=jax_make_val_step(cfg, jgen, jdisc),
                jstate=jstate, state=state)


def _port_starts(batch, cfg, seed):
    """The segment starts the port's `wav` form draws from a generator
    seeded with `seed` (no dropout: the draw is the generator's only use)."""
    seg = min(cfg.generator.segment_size, cfg.data.mel_bucket_size)
    u = torch.rand(len(batch["x"]), generator=torch.Generator().manual_seed(seed)).numpy()
    max_start = np.maximum(np.maximum(batch["mel_lengths"] - 4, 1) - seg, 0)
    return np.floor(u * max_start).astype(np.int32)


def _compare(jout, out):
    (jlogs, jwav, jwav_hat), (logs, wav, wav_hat) = jout, out
    assert set(logs) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=LOG_RTOL, err_msg=k)
    np.testing.assert_allclose(wav.numpy(), np.asarray(jwav), atol=WAV_ATOL, rtol=0)
    np.testing.assert_allclose(wav_hat.numpy(), np.asarray(jwav_hat), atol=WAV_ATOL, rtol=0)


def test_val_step_matches_jax_wav_seg_form(setup):
    batch = train_batch(np.random.default_rng(5), setup["cfg"])
    jout = setup["jstep"](setup["jstate"], {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.PRNGKey(0))
    out = make_val_step(setup["tcfg"])(setup["state"], _torch_batch(batch))
    _compare(jout, out)
    keys = {"total_loss/val_am_loss", "total_loss/val_gen_adv_loss", "total_loss/val_total",
            "gen_subloss/val_align_loss", "gen_subloss/val_duration_loss",
            "gen_subloss/val_pitch_loss", "gen_subloss/val_energy_loss",
            "gen_adv_loss/val_mel_loss"}
    assert keys <= set(out[0])


def test_val_step_matches_jax_wav_form(setup):
    """The `wav` form draws its segment starts from the caller's generator;
    JAX is fed the same starts in the `wav_seg` form."""
    from optispeech_tpu.ops.segments import host_slice_wav_segments

    cfg = setup["cfg"]
    batch = train_batch(np.random.default_rng(6), cfg, host_seg=False)
    starts = _port_starts(batch, cfg, seed=3)
    host = {k: v for k, v in batch.items() if k != "wav"}
    host.update(start_idx=starts, wav_seg=host_slice_wav_segments(
        batch["wav"], starts, min(cfg.generator.segment_size, cfg.data.mel_bucket_size),
        cfg.generator.features.hop_length))
    jout = setup["jstep"](setup["jstate"], {k: jnp.asarray(v) for k, v in host.items()},
                          jax.random.PRNGKey(0))
    out = make_val_step(setup["tcfg"])(setup["state"], _torch_batch(batch),
                                       torch.Generator().manual_seed(3))
    _compare(jout, out)


def test_val_step_runs_the_extraction_and_changes_nothing(setup, monkeypatch):
    import optispeech_tpu_torch.models.generator as generator_module

    calls = []
    extract = generator_module.viterbi_decode_extract

    def spy(*args):
        calls.append(1)
        return extract(*args)

    monkeypatch.setattr(generator_module, "viterbi_decode_extract", spy)
    state = setup["state"]
    before = {k: v.clone() for k, v in state.generator.state_dict().items()}
    step_before, rng_before = state.step, state.rng.get_state()
    logs, wav, wav_hat = make_val_step(setup["tcfg"])(
        state, _torch_batch(train_batch(np.random.default_rng(7), setup["cfg"])))
    assert calls == [1]
    assert not state.generator.training and not state.discriminator.training
    assert not wav_hat.requires_grad and all(not v.requires_grad for v in logs.values())
    assert state.step == step_before and torch.equal(state.rng.get_state(), rng_before)
    assert all(torch.equal(v, before[k]) for k, v in state.generator.state_dict().items())


def test_wav_form_needs_a_generator(setup):
    batch = train_batch(np.random.default_rng(8), setup["cfg"], host_seg=False)
    with pytest.raises(ValueError, match="rng"):
        make_val_step(setup["tcfg"])(setup["state"], _torch_batch(batch))


def test_extraction_forward_equals_the_training_mas_forward(setup):
    """`extract_durations=True` changes which MAS runs, not what the
    forward computes: the same durations and losses (bin loss rtol 1e-5)."""
    gen = setup["state"].generator.eval()
    b = _torch_batch(train_batch(np.random.default_rng(9), setup["cfg"]))
    args = [b[k] for k in ("x", "x_lengths", "mel", "mel_lengths", "pitches", "energies")]
    with torch.no_grad():
        plain = gen(*args, start_idx=b["start_idx"])
        extract = gen(*args, start_idx=b["start_idx"], extract_durations=True)
    assert torch.equal(plain["durations"], extract["durations"])
    for k in ("loss", "align_loss", "duration_loss", "pitch_loss", "energy_loss"):
        torch.testing.assert_close(extract[k], plain[k], rtol=LOG_RTOL, atol=0, msg=k)
    torch.testing.assert_close(extract["wav_hat"], plain["wav_hat"], rtol=0, atol=0)
