"""The synthesis slice, port against JAX on the CPU, with the same weights.

- `encode`: durations exactly equal; hidden, pitch and energy atol 1e-4.
- `decode` on JAX's own `encode` outputs (so that one duration flipped by a
  last-ulp difference in `ceil` cannot cascade): wav atol 1e-4.
- `synthesise` end to end from text.
Configs: single speaker; 3 speakers x 2 languages (sid/lid embeds);
`f0_cond`; and the flagship's widths with depth cut to 2 blocks per stack.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (build_pair, full_width_config, random_tokens, small_config,
                          to_torch_config)

torch.set_num_threads(1)

ATOL = 1e-4
FACTORS = (3.0, 1.3, 0.9)  # d, p, e

CONFIGS = {
    "single": dict(),
    "multi": dict(num_speakers=3, languages=("en-us", "en-gb")),
    "f0_cond": dict(f0_cond=True),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    return request.param, build_pair(small_config(**CONFIGS[request.param]))


def _ids(name, b):
    if name != "multi":
        return None, None
    return np.array([2, 0, 1][:b], np.int32), np.array([1, 0, 1][:b], np.int32)


def _jax_encode(japi, x, x_lengths, sids, lids):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    enc = japi._encode_jit(japi.params, j(x), j(x_lengths), j(sids), j(lids),
                           *[jnp.float32(f) for f in FACTORS])
    return {k: np.array(v) for k, v in enc.items()}  # writable copies


def _torch_encode(tapi, x, x_lengths, sids, lids):
    t = lambda a: None if a is None else torch.from_numpy(a).long()  # noqa: E731
    with torch.no_grad():
        enc = tapi.generator.encode(t(x), torch.from_numpy(x_lengths), t(sids), t(lids),
                                    *FACTORS)
    return {k: v.numpy() for k, v in enc.items()}


def _check_encode(jenc, tenc):
    np.testing.assert_array_equal(tenc["durations"], jenc["durations"])
    np.testing.assert_array_equal(tenc["y_lengths"], jenc["y_lengths"])
    for key in ("hidden", "pitch", "energy"):
        np.testing.assert_allclose(tenc[key], jenc[key], atol=ATOL, err_msg=key)


def _check_decode(japi, tapi, jenc, n_frames):
    """Both decoders on JAX's encode outputs."""
    f0 = japi.cfg.generator.vocoder.f0_cond
    y_lengths = np.minimum(jenc["y_lengths"], n_frames).astype(np.int32)
    jdec = japi._decode_jit(japi.params, jnp.asarray(jenc["hidden"]),
                            jnp.asarray(jenc["durations"]), jnp.asarray(jenc["x_mask"]),
                            jnp.asarray(y_lengths), n_frames,
                            pitch=jnp.asarray(jenc["pitch"]) if f0 else None)
    with torch.no_grad():
        tdec = tapi.generator.decode(torch.from_numpy(jenc["hidden"]),
                                     torch.from_numpy(jenc["durations"]),
                                     torch.from_numpy(jenc["x_mask"]),
                                     torch.from_numpy(y_lengths), n_frames,
                                     pitch=torch.from_numpy(jenc["pitch"]) if f0 else None)
    np.testing.assert_array_equal(tdec["wav_lengths"].numpy(), np.asarray(jdec["wav_lengths"]))
    np.testing.assert_allclose(tdec["wav"].numpy(), np.asarray(jdec["wav"]), atol=ATOL)


def test_encode(pair):
    name, (japi, tapi) = pair
    x, x_lengths = random_tokens(np.random.default_rng(0), [29, 17, 6])
    sids, lids = _ids(name, 3)
    _check_encode(_jax_encode(japi, x, x_lengths, sids, lids),
                  _torch_encode(tapi, x, x_lengths, sids, lids))


def test_decode_on_jax_encode_outputs(pair):
    name, (japi, tapi) = pair
    x, x_lengths = random_tokens(np.random.default_rng(1), [31, 12, 4])
    jenc = _jax_encode(japi, x, x_lengths, *_ids(name, 3))
    n_frames = -(-int(jenc["y_lengths"].max()) // 128) * 128  # the mel bucket
    _check_decode(japi, tapi, jenc, n_frames)


def test_synthesise_end_to_end(pair):
    name, (japi, tapi) = pair
    kw = dict(d_factor=FACTORS[0], p_factor=FACTORS[1], e_factor=FACTORS[2])
    if name == "multi":
        kw.update(speaker=2, language="en-gb")
    text = "The birch canoe slid on the smooth planks. Glue the sheet to the dark blue background."
    jout = japi.synthesise(japi.prepare_input(text, **kw))
    tinputs = tapi.prepare_input(text, **kw)
    np.testing.assert_array_equal(tinputs.x, japi.prepare_input(text, **kw).x)
    tout = tapi.synthesise(tinputs)
    np.testing.assert_array_equal(tout.durations, jout.durations)
    np.testing.assert_array_equal(tout.wav_lengths, jout.wav_lengths)
    assert tout.wav.shape == jout.wav.shape
    np.testing.assert_allclose(tout.wav, jout.wav, atol=ATOL)
    np.testing.assert_allclose(tout.pitch, jout.pitch, atol=ATOL)
    assert tout.rtf > 0 and tout.latency > 0


def test_synthesise_on_device_pcm16():
    """The fixed-cap path on the CPU: output capped at n_frames, and its
    int16 rendering."""
    from optispeech_tpu_torch.models.optispeech import OptiSpeech
    from optispeech_tpu_torch.values import InferenceInputs

    tapi = OptiSpeech(to_torch_config(small_config()), seed=0, device="cpu")
    x, x_lengths = random_tokens(np.random.default_rng(2), [20, 9])

    inputs = InferenceInputs(clean_text="", x=x[:, :20], x_lengths=x_lengths, d_factor=3.0)
    out = tapi.synthesise_on_device(inputs, n_frames=32, pcm16=True)
    assert out["wav"].shape == (2, 32 * 16)
    assert int(out["y_lengths"].max()) <= 32
    np.testing.assert_array_equal(out["wav_pcm16"].numpy(),
                                  np.round(out["wav"].numpy() * 32767.0).astype(np.int16))


def test_full_width_reduced_depth():
    """Flagship widths (256/1024, 384/1152, n_fft 1024, hop 256), 2 blocks per
    stack, batch 1, one 128-frame bucket."""
    japi, tapi = build_pair(full_width_config(layers=2))
    x, x_lengths = random_tokens(np.random.default_rng(3), [30])
    jenc = _jax_encode(japi, x, x_lengths, None, None)
    _check_encode(jenc, _torch_encode(tapi, x, x_lengths, None, None))
    _check_decode(japi, tapi, jenc, 128)  # capped at the bucket, as synthesise_fixed
