"""One validation step at configs/ljspeech-48k.yaml's and ljspeech-22k.yaml's
feature blocks, port against JAX on the CPU (`torch_parity.TEST_WIDTHS`, no
dropout, the same weights): the MAS durations of the validation forward
(the port's extraction MAS, JAX's training forward) exactly equal, every
log rtol 1e-5, `wav` and `wav_hat` atol 1e-5 (tests/test_torch_val_step.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optispeech_tpu.training.step import make_val_step as jax_make_val_step
from optispeech_tpu_torch.training.step import make_val_step
from torch_parity import to_torch_config, train_batch, train_setup, yaml_config

torch.set_num_threads(1)

LOG_RTOL = 1e-5
WAV_ATOL = 1e-5
KEYS = ("x", "x_lengths", "mel", "mel_lengths", "pitches", "energies")


@pytest.mark.parametrize("name", ["ljspeech-48k", "ljspeech-22k"])
def test_validation_step_matches_jax(name):
    cfg = yaml_config(name, "data.text_processor.tokenizer=en-g2p")
    jgen, jdisc, jstate, state = train_setup(cfg)
    batch = train_batch(np.random.default_rng(1), cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogs, jwav, jwav_hat = jax_make_val_step(cfg, jgen, jdisc)(jstate, jbatch,
                                                                jax.random.PRNGKey(0))
    jdur = jax.jit(lambda p, b: jgen.apply(
        {"params": p}, **{k: b[k] for k in KEYS}, deterministic=True,
        rngs={"segment": jax.random.PRNGKey(0)}, start_idx=b["start_idx"])["durations"])(
            jstate.g_params, jbatch)

    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    logs, wav, wav_hat = make_val_step(to_torch_config(cfg))(state, tb)
    with torch.no_grad():
        dur = state.generator(*[tb[k] for k in KEYS], start_idx=tb["start_idx"],
                              extract_durations=True)["durations"].numpy()
    np.testing.assert_array_equal(dur, np.asarray(jdur))
    assert dur.sum() > 0
    assert set(logs) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=LOG_RTOL, err_msg=k)
    seg = cfg.generator.segment_size * cfg.generator.features.hop_length
    assert wav_hat.shape == (len(batch["x"]), seg)
    np.testing.assert_allclose(wav.numpy(), np.asarray(jwav), atol=WAV_ATOL, rtol=0)
    np.testing.assert_allclose(wav_hat.numpy(), np.asarray(jwav_hat), atol=WAV_ATOL, rtol=0)
