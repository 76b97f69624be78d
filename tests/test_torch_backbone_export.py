"""Export, replay and streaming with the other backbone kinds (the port
alone): `export_model` -> `ExportedOptiSpeech` and
`ExportedStreamingSynthesiser` against the live fused model, and the live
`StreamingSynthesiser`, for LightSpeech, Transformer, Conformer (both conv
norms) and LeanSpeech at test size (`test_torch_backbones.kind_config`),
weights from the port's seeded initialisation.

The artifact against the live model at the artifact's frame count:
durations equal, wav atol 1e-5 (tests/test_torch_export.py's LIVE_ATOL).
Every kind exports, the LeanSpeech's `nn.LSTM` included.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_backbones import KINDS, kind_config
from torch_parity import random_tokens, to_torch_config

from optispeech_tpu_torch.models.optispeech import OptiSpeech, with_fused_blocks

torch.set_num_threads(1)

LIVE_ATOL = 1e-5


@pytest.fixture(scope="module", params=list(KINDS))
def model(request):
    return OptiSpeech(to_torch_config(kind_config(*KINDS[request.param])), seed=0, device="cpu")


def test_stream_runs_each_kind(model):
    """`StreamingSynthesiser` on the port's fused model: the chunks cover
    every frame of the utterance, finite. (For these decoders the windows
    are not the full decode: positions and attention are per window, in JAX
    as here.)"""
    from optispeech_tpu_torch.models.streaming import StreamingSynthesiser

    fused = OptiSpeech(with_fused_blocks(model.cfg), device="cpu",
                       state_dict=model.generator.state_dict())
    inputs = fused.prepare_input("hello world this is long", split_sentences=False,
                                 d_factor=3.0)
    frames = int(fused.synthesise(inputs).durations.sum())
    chunks = list(StreamingSynthesiser(fused, 16, 16).stream(inputs))
    assert len(chunks) == -(-frames // 16) > 2
    wav = np.concatenate(chunks)
    assert wav.shape == (frames * fused.hop_length,) and np.isfinite(wav).all()


def test_export_replays_each_kind(model, tmp_path):
    """`export_model` -> `ExportedOptiSpeech` on the fused model: the replay
    against the live model at the artifact's frame count, and its stream."""
    from optispeech_tpu_torch.export.exporter import (
        ExportedOptiSpeech,
        ExportedStreamingSynthesiser,
        export_model,
    )
    from optispeech_tpu_torch.models.streaming import StreamingSynthesiser
    from optispeech_tpu_torch.values import InferenceInputs

    cfg = with_fused_blocks(model.cfg)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, text_bucket_size=16,
                                                            mel_bucket_size=32))
    live = OptiSpeech(cfg, device="cpu", state_dict=model.generator.state_dict())
    export_model(live, str(tmp_path), text_buckets=(32,), frames_per_token=8, batch_sizes=(2,),
                 stream_chunk_frames=16, stream_overlap=16)
    runtime = ExportedOptiSpeech(str(tmp_path), device="cpu")
    x, x_lengths = random_tokens(np.random.default_rng(5), [32, 21], 32)
    inputs = InferenceInputs(x=x.astype(np.int64), x_lengths=x_lengths.astype(np.int64),
                             clean_text="seeded", d_factor=1.3, p_factor=1.1, e_factor=0.9)
    got = runtime.synthesise(inputs)
    want = live.synthesise_on_device(inputs, 256)
    np.testing.assert_array_equal(got.durations, want["durations"].numpy())
    np.testing.assert_array_equal(got.wav_lengths, want["wav_lengths"].numpy())
    for i, n in enumerate(got.wav_lengths):
        np.testing.assert_allclose(got.wav[i, :n], want["wav"].numpy()[i, :n], atol=LIVE_ATOL,
                                   rtol=0)
    text = live.prepare_input("hello world this is long", split_sentences=False, d_factor=3.0)
    streamed = list(ExportedStreamingSynthesiser(runtime).stream(text))
    expect = list(StreamingSynthesiser(live, 16, 16).stream(text))
    assert [len(c) for c in streamed] == [len(c) for c in expect]
    np.testing.assert_allclose(np.concatenate(streamed), np.concatenate(expect), atol=LIVE_ATOL,
                               rtol=0)
