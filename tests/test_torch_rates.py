"""The 48 kHz and 22.05 kHz feature blocks (configs/ljspeech-48k.yaml,
ljspeech-22k.yaml), port against JAX on the CPU: what depends on the rate
outside the train and validation steps (tests/test_torch_rate_48k.py,
_22k.py hold those).

- The mel filter banks (slaney for features, htk for the training loss):
  equal, both numpy.
- The host log-mel (`data/dsp.py`) bit for bit; the device log-mel
  (`ops/stft.py`, float32 DFT products) atol 1e-4, as
  tests/test_torch_train_modules.py holds it at 24 kHz.
- `resample_to_16k` (48000 -> 1:3, 22050 -> 320:441) bit for bit, and MCD at
  the rate equal.
- `prepare_input -> synthesise` at test widths with the file's feature block
  (the WaveNeXt head is n_fft + 2 wide: 2050 at 48 kHz): token ids and
  durations exactly equal, wav atol 1e-4 (tests/test_torch_synthesis.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optispeech_tpu.data import dsp as jax_dsp
from optispeech_tpu.ops import stft as jax_stft
from optispeech_tpu.training import metrics as jax_metrics
from optispeech_tpu.utils.yamlcfg import load_experiment
from optispeech_tpu_torch.data import dsp
from optispeech_tpu_torch.ops import stft
from optispeech_tpu_torch.training import metrics
from torch_parity import build_pair, yaml_config

torch.set_num_threads(1)

CONFIGS = ("ljspeech-48k", "ljspeech-22k")
ATOL = 1e-4
TEXT = "The birch canoe slid on the smooth planks. Glue the sheet to the dark blue background."


def _features(name):
    f = load_experiment(name).data.features
    return f, (f.sample_rate, f.n_fft, f.hop_length, f.win_length, f.n_feats, f.f_min, f.f_max)


def _speech(sr, seconds=1.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    return (0.5 * np.sin(2 * np.pi * 180 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
            + 0.05 * rng.normal(size=t.size)).astype(np.float32)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("htk,norm", [(False, "slaney"), (True, None)])
def test_mel_filterbank_equals_jax(name, htk, norm):
    f, _ = _features(name)
    args = (f.sample_rate, f.n_fft, f.n_feats, f.f_min, f.f_max)
    got = stft.mel_filterbank(*args, htk=htk, norm=norm).numpy()
    assert got.shape == (f.n_feats, f.n_fft // 2 + 1)
    np.testing.assert_array_equal(got, np.asarray(jax_stft.mel_filterbank(*args, htk=htk,
                                                                          norm=norm)))


@pytest.mark.parametrize("name", CONFIGS)
def test_log_mel_equals_jax(name):
    f, args = _features(name)
    wav = _speech(f.sample_rate)
    host = dsp.log_mel_spectrogram_np(wav, *args)
    np.testing.assert_array_equal(host, jax_dsp.log_mel_spectrogram_np(wav, *args))
    assert host.shape[0] == f.n_feats
    batch = np.stack([wav, _speech(f.sample_rate, seed=1)])
    got = stft.log_mel_spectrogram(torch.from_numpy(batch), *args).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_stft.log_mel_spectrogram(jnp.asarray(batch),
                                                                            *args)), atol=ATOL)


@pytest.mark.parametrize("name", CONFIGS)
def test_resample_and_mcd_equal_jax(name):
    sr = load_experiment(name).data.features.sample_rate
    ref, gen = _speech(sr), _speech(sr, seed=2)
    got = metrics.resample_to_16k(ref, sr)
    assert len(got) == -(-len(ref) * 16000 // sr)
    np.testing.assert_array_equal(got, jax_metrics.resample_to_16k(ref, sr))
    mcd = metrics.mel_cepstral_distortion(ref, gen, sr)
    assert mcd == jax_metrics.mel_cepstral_distortion(ref, gen, sr) and mcd > 0


@pytest.fixture(scope="module", params=CONFIGS)
def pair(request):
    cfg = yaml_config(request.param, "data.text_processor.tokenizer=en-g2p")
    return cfg, build_pair(cfg)


def test_synthesise_equals_jax(pair):
    cfg, (japi, tapi) = pair
    f = cfg.generator.features
    assert tapi.sample_rate == f.sample_rate and tapi.hop_length == f.hop_length
    head = tapi.generator.vocoder.head
    assert head.linear_1.out_features == f.n_fft + 2 and head.linear_2.out_features == f.hop_length
    kw = dict(d_factor=1.5, p_factor=1.2, e_factor=0.9)
    jout = japi.synthesise(japi.prepare_input(TEXT, **kw))
    tinputs = tapi.prepare_input(TEXT, **kw)
    np.testing.assert_array_equal(tinputs.x, japi.prepare_input(TEXT, **kw).x)
    tout = tapi.synthesise(tinputs)
    np.testing.assert_array_equal(tout.durations, jout.durations)
    np.testing.assert_array_equal(tout.wav_lengths, jout.wav_lengths)
    assert tout.wav.shape == jout.wav.shape and tout.wav.shape[1] % f.hop_length == 0
    np.testing.assert_allclose(tout.wav, jout.wav, atol=ATOL)
    assert np.abs(tout.wav).max() > 0
