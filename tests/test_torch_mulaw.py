"""The µ-law wire and its helpers, port against JAX on the CPU.

- `mulaw_encode` (float32 on tensors) against JAX's: within one code, on
  fewer than 1% of samples (tests/test_mulaw.py's bound between JAX's
  device and host encoders: float32 `log1p` rounds otherwise at code
  boundaries).
- `pack_valid_rows` against JAX's: offsets and packed buffer bit-equal.
- The numpy functions (`mulaw_decode`, `mulaw_encode_np`) bit-equal.
- `round_up_pow2_bucket` equal to JAX's over a grid.
- `synthesise_on_device(mulaw=True)` and `fetch_packed` against JAX's on
  a small model: durations equal, codes within the bound above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optispeech_tpu.ops import mulaw as jax_mulaw
from optispeech_tpu.utils import bucketing as jax_bucketing
from optispeech_tpu_torch.ops import mulaw
from optispeech_tpu_torch.utils import bucketing

from torch_parity import build_pair, small_config

torch.set_num_threads(1)

TEXT = "The birch canoe slid on the smooth planks. Glue the sheet to the dark blue background."


def _speech_like(rng, n=24000, sr=24000):
    """Harmonic 150 Hz tone with formant-like AM and a noise floor, peak 0.7
    (tests/test_mulaw.py's signal)."""
    t = np.arange(n) / sr
    sig = sum(np.sin(2 * np.pi * 150 * k * t) / k for k in range(1, 8))
    sig *= 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    sig += 0.01 * rng.standard_normal(n)
    return (0.7 * sig / np.abs(sig).max()).astype(np.float32)


def assert_codes_close(got, ref):
    """Within one code everywhere, and different on fewer than 1% of samples."""
    got, ref = np.asarray(got).astype(int), np.asarray(ref).astype(int)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1
    assert (got != ref).mean() < 0.01


def test_mulaw_encode_matches_jax():
    rng = np.random.default_rng(0)
    # the signal, its clipped extremes and exact zeros
    wav = np.concatenate([_speech_like(rng), np.float32([-2.0, -1.0, 0.0, 1.0, 2.0])])
    got = mulaw.mulaw_encode(torch.from_numpy(wav))
    assert got.dtype == torch.uint8
    ref = np.asarray(jax.jit(jax_mulaw.mulaw_encode)(jnp.asarray(wav)))
    assert_codes_close(got.numpy(), ref)
    assert got[-5:].tolist() == [0, 0, 128, 255, 255]


@pytest.mark.parametrize("dtype", [np.uint8, np.int16])
def test_pack_valid_rows_is_jax_bit_for_bit(dtype):
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 256, (4, 50)).astype(dtype)
    lengths = np.array([50, 3, 0, 17], np.int32)
    packed, offs = mulaw.pack_valid_rows(torch.from_numpy(codes), torch.from_numpy(lengths))
    jp, jo = jax.jit(jax_mulaw.pack_valid_rows)(jnp.asarray(codes), jnp.asarray(lengths))
    assert packed.dtype == torch.from_numpy(codes).dtype and offs.dtype == torch.int32
    np.testing.assert_array_equal(offs.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jp))
    assert packed.shape == (200,) and not packed[int(lengths.sum()):].any()
    for i in range(4):
        o = int(offs[i])
        np.testing.assert_array_equal(packed[o:o + lengths[i]].numpy(), codes[i, :lengths[i]])


def test_numpy_functions_are_jax_bit_for_bit():
    rng = np.random.default_rng(2)
    wav = np.concatenate([_speech_like(rng, n=4096), rng.uniform(-1.5, 1.5, 512)
                          .astype(np.float32)])
    np.testing.assert_array_equal(mulaw.mulaw_encode_np(wav), jax_mulaw.mulaw_encode_np(wav))
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(mulaw.mulaw_decode(codes), jax_mulaw.mulaw_decode(codes))
    assert mulaw.mulaw_decode(codes).dtype == np.float32


def test_round_up_pow2_bucket_is_jax_s():
    for bucket in (1, 16, 32, 128):
        for cap in (None, 64, 1000, 1024, 4096):
            for n in (-3, 0, 1, 15, 16, 17, 31, 32, 33, 100, 511, 512, 513, 1023, 1024,
                      1025, 5000, 99999):
                assert (bucketing.round_up_pow2_bucket(n, bucket, cap)
                        == jax_bucketing.round_up_pow2_bucket(n, bucket, cap)), (n, bucket, cap)


@pytest.fixture(scope="module")
def pair():
    return build_pair(small_config())


def test_synthesise_on_device_mulaw_and_fetch_packed_match_jax(pair):
    japi, tapi = pair
    inputs = tapi.prepare_input(TEXT)
    assert inputs.x.shape[0] == 2
    n_frames = 128
    got = tapi.synthesise_on_device(inputs, n_frames, pcm16=True, mulaw=True)
    ref = japi.synthesise_on_device(japi.prepare_input(TEXT), n_frames, pcm16=True, mulaw=True)
    np.testing.assert_array_equal(got["durations"].numpy(), np.asarray(ref["durations"]))
    lengths = got["wav_lengths"].numpy()
    np.testing.assert_array_equal(lengths, np.asarray(ref["wav_lengths"]))
    assert (lengths < n_frames * tapi.hop_length).all()
    assert got["wav_mulaw"].dtype == torch.uint8
    assert_codes_close(got["wav_mulaw"].numpy(), np.asarray(ref["wav_mulaw"]))
    assert np.abs(got["wav_pcm16"].numpy().astype(int)
                  - np.asarray(ref["wav_pcm16"]).astype(int)).max() <= 5  # 1e-4 + one step
    np.testing.assert_array_equal(got["wav_offsets"].numpy(), np.asarray(ref["wav_offsets"]))

    # the packed buffer holds each row's valid prefix; the fetch ships the total
    total = int(lengths.sum())
    flat = tapi.fetch_packed(got["wav_mulaw_packed"], total, bucket=64)
    jflat = japi.fetch_packed(ref["wav_mulaw_packed"], total, bucket=64)
    assert flat.shape == (total,) and flat.dtype == np.uint8
    assert_codes_close(flat, jflat)
    codes = got["wav_mulaw"].numpy()
    for i, o in enumerate(got["wav_offsets"].numpy()):
        np.testing.assert_array_equal(flat[o:o + lengths[i]], codes[i, :lengths[i]])
