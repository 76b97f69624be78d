"""Chunked streaming synthesis (models/streaming.py), port against JAX on
the CPU.

- The port's stream equals JAX's stream, chunk by chunk (atol 1e-4,
  tests/test_torch_synthesis.py's tolerance), with and without an
  f0-conditioned vocoder, but for the first window's first frames, where
  it equals JAX's full decode instead (JAX's stream departs from it there).
- The port's stream equals the port's full decode within ATOL, tighter
  than JAX's own 2e-3 (tests/test_streaming.py:43), its first frames
  included.
- The chunk-size rules: whole hops, at most `chunk` frames each, the
  utterance's frames in all.
- The pcm16 and µ-law wires against JAX's: pcm16 within ATOL plus one
  rounding step (`PCM16_STEPS`), µ-law within one code on fewer than 1% of
  samples (tests/test_mulaw.py's bound).

The small models' receptive field is 15 frames (decoder 2 x k7, vocoder
embed k7 + 2 x k7), so an overlap of 16 frames suffices.
"""

import math

import numpy as np
import pytest
import torch

from optispeech_tpu.models.streaming import StreamingSynthesiser as JaxStreamer
from optispeech_tpu_torch.models.optispeech import OptiSpeech
from optispeech_tpu_torch.models.streaming import DEFAULT_OVERLAP, StreamingSynthesiser

from torch_parity import build_pair, small_config, to_torch_config
from test_torch_mulaw import assert_codes_close

torch.set_num_threads(1)

ATOL = 1e-4
PCM16_STEPS = math.ceil(ATOL * 32767) + 1
TEXT = "hello world this is a longer sentence for streaming"
CHUNK, OVERLAP, MAX_FRAMES = 16, 16, 512


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "f0_cond"])
def pair(request):
    return build_pair(small_config(f0_cond=request.param))


def _streams(pair, wire=None, d_factor=3.0):
    japi, tapi = pair
    kw = dict(split_sentences=False, d_factor=d_factor)
    got = list(StreamingSynthesiser(tapi, CHUNK, OVERLAP).stream(
        tapi.prepare_input(TEXT, **kw), MAX_FRAMES, wire=wire))
    ref = list(JaxStreamer(japi, CHUNK, OVERLAP).stream(
        japi.prepare_input(TEXT, **kw), MAX_FRAMES, wire=wire))
    assert len(got) == len(ref) > 2, "expected several chunks"
    assert [len(c) for c in got] == [len(c) for c in ref]
    return got, ref


def test_stream_matches_jax_stream(pair):
    """Every chunk equals JAX's, but for the first window's first `edge`
    frames: JAX pads that window with PAD frames, into which the vocoder's
    embedding convolution spills from the utterance's first frames, so its
    stream departs there from its own full decode. The port's first window
    starts at frame 0, and there it equals JAX's full decode."""
    japi, tapi = pair
    got, ref = _streams(pair)
    assert all(c.dtype == np.float32 for c in got)
    edge = 3 * (1 + japi.cfg.generator.vocoder.num_layers) * tapi.hop_length
    np.testing.assert_allclose(got[0][edge:], ref[0][edge:], atol=ATOL, rtol=0)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g, r, atol=ATOL, rtol=0)
    full = japi.synthesise(japi.prepare_input(TEXT, split_sentences=False, d_factor=3.0))
    np.testing.assert_allclose(got[0][:edge], np.asarray(full.wav)[0, :edge], atol=ATOL, rtol=0)


def test_stream_matches_full_decode(pair):
    _, tapi = pair
    inputs = tapi.prepare_input(TEXT, split_sentences=False, d_factor=3.0)
    full = tapi.synthesise(inputs)
    full = full.wav[0, : int(full.wav_lengths[0])]
    streamed = StreamingSynthesiser(tapi, CHUNK, OVERLAP).synthesise(inputs, MAX_FRAMES)
    assert len(streamed) == len(full) > 20 * tapi.hop_length
    np.testing.assert_allclose(streamed, full, atol=ATOL, rtol=0)


def test_chunk_sizes():
    tapi = OptiSpeech(to_torch_config(small_config()), seed=0, device="cpu")
    inputs = tapi.prepare_input("hello world again", split_sentences=False, d_factor=3.0)
    hop = tapi.hop_length
    total = int(tapi.synthesise(inputs).wav_lengths[0])
    streamer = StreamingSynthesiser(tapi, chunk_frames=8, overlap=16)
    assert streamer.window == 8 + 2 * 16 and DEFAULT_OVERLAP == 48
    chunks = list(streamer.stream(inputs, max_frames=512))
    assert all(len(c) % hop == 0 and 0 < len(c) <= 8 * hop for c in chunks)
    assert all(len(c) == 8 * hop for c in chunks[:-1])
    assert sum(len(c) for c in chunks) == total
    assert len(chunks) == -(-total // (8 * hop))
    # max_frames caps the utterance
    capped = list(streamer.stream(inputs, max_frames=8))
    assert [len(c) for c in capped] == [8 * hop]


@pytest.mark.parametrize("wire", ["pcm16", "mulaw"])
def test_wires_match_jax(pair, wire):
    got, ref = _streams(pair, wire=wire)
    dtype = {"pcm16": np.int16, "mulaw": np.uint8}[wire]
    assert all(c.dtype == dtype for c in got)
    got, ref = np.concatenate(got), np.concatenate(ref)
    if wire == "pcm16":
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= PCM16_STEPS
    else:
        assert_codes_close(got, ref)


def test_fused_model_runs_the_fused_block_in_every_window(monkeypatch):
    """A fused model's windows (48 frames here, 352 at the defaults) are
    lengths JAX's tile rule does not fuse; the stream runs them through the
    fused block all the same (on the CPU its twin), and still matches the
    full decode."""
    from optispeech_tpu_torch.models.modules import convnext
    from optispeech_tpu_torch.models.optispeech import with_fused_blocks
    from optispeech_tpu_torch.ops.fused_convnext import kernel_takes

    tapi = OptiSpeech(with_fused_blocks(to_torch_config(small_config())), seed=0, device="cpu")
    inputs = tapi.prepare_input(TEXT, split_sentences=False, d_factor=3.0)
    full = tapi.synthesise(inputs)
    full = full.wav[0, : int(full.wav_lengths[0])]
    frames, wrapper = [], convnext.convnext_block_fused

    def recording(x, *args, **kw):
        frames.append(x.shape[1])
        return wrapper(x, *args, **kw)

    monkeypatch.setattr(convnext, "convnext_block_fused", recording)
    chunks = list(StreamingSynthesiser(tapi, CHUNK, OVERLAP).stream(inputs, MAX_FRAMES))
    first, window = CHUNK + OVERLAP, CHUNK + 2 * OVERLAP  # the first has no left context
    # the rule alone would run the blocks unfused at either length
    assert not kernel_takes(first, 32, 64) and not kernel_takes(window, 32, 64)
    # 2 decoder + 2 trunk blocks a window
    assert frames == [first] * 4 + [window] * 4 * (len(chunks) - 1)
    streamed = np.concatenate(chunks)
    assert len(streamed) == len(full)
    np.testing.assert_allclose(streamed, full, atol=2e-3, rtol=0)
