"""Export and replay (export/exporter.py, cli/export.py, cli/speak.py): port
artifacts replayed on `device="cpu"`, held against the JAX package's export
and models on the same weights (`torch_parity.build_pair`).

JAX's four `tests/test_export.py` cases in the port, each against JAX:
- an unfused port artifact against a JAX artifact exported with the same
  ladders, replayed at every rung: durations equal, wav within 1e-4;
- a fused port artifact against the port's live fused model at the same
  frame count (durations equal, wav within 1e-5) and against JAX's live
  fused model with the Pallas kernel in interpret mode (wav within 1e-4);
- multi-speaker / multi-language: per speaker against JAX, and another
  speaker gives another wav;
- `prewarm` over every rung, and `cli/speak.py` writing JAX's wavs.
And: the artifact's stream against the live `StreamingSynthesiser` within
1e-5; `metadata.json` equal to JAX's; B1's op once per fused block in
every decode and stream graph, its twin run in each on the CPU; every graph
replays on the `meta` device (no CPU constant inside); a JAX artifact is
refused; the runtime needs a device when there is no card.

Each artifact is exported once per module, at small ladders (text buckets
16 and 32, batch rungs 1 and 2, stream windows of 16 frames with 16 of
overlap).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from torch_parity import build_pair, params_np, random_tokens, small_config, to_torch_config

from optispeech_tpu_torch.export import exporter as port_export
from optispeech_tpu_torch.export.exporter import (
    ExportedOptiSpeech,
    ExportedStreamingSynthesiser,
    export_model,
)
from optispeech_tpu_torch.models.optispeech import OptiSpeech, with_fused_blocks
from optispeech_tpu_torch.models.streaming import StreamingSynthesiser
from optispeech_tpu_torch.ops import fused_convnext as fc
from optispeech_tpu_torch.values import InferenceInputs

torch.set_num_threads(1)

ATOL = 1e-4  # port against JAX
LIVE_ATOL = 1e-5  # the port's artifact against the port's live model
LADDER = dict(text_buckets=(16, 32), frames_per_token=8, batch_sizes=(1, 2),
              stream_chunk_frames=16, stream_overlap=16)
MELS = {16: 128, 32: 256}  # round_up_to_bucket(tb * 8, 32)
GRAPHS = (["encode_16", "encode_16_b2", "encode_32", "encode_32_b2"]
          + ["decode_16_128", "decode_16_128_b2", "decode_32_256", "decode_32_256_b2"]
          + ["stream_upsample_16_128", "stream_upsample_32_256", "stream_decode_32",
             "stream_decode_48"])
FUSED_BLOCKS = 4  # 2 decoder + 2 trunk blocks
TEXT = "hello world. bye now."
OP = torch.ops.optispeech_tpu_torch.convnext_block_fused.default


def export_config(**kw):
    cfg = small_config(**kw)
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, text_bucket_size=16, mel_bucket_size=32))


@pytest.fixture(scope="module")
def pair():
    return build_pair(export_config())


@pytest.fixture(scope="module")
def fused_live(pair):
    return OptiSpeech.load_from_jax_params(with_fused_blocks(to_torch_config(pair[0].cfg)),
                                           params_np(pair[0].params), device="cpu")


@pytest.fixture(scope="module")
def artifacts(pair, fused_live, tmp_path_factory):
    """Directories of a JAX artifact, and of the port's unfused and fused
    artifacts, from the same weights and ladders."""
    from optispeech_tpu.export.exporter import export_model as jax_export_model

    root = tmp_path_factory.mktemp("artifacts")
    dirs = {name: str(root / name) for name in ("jax", "unfused", "fused")}
    jax_export_model(pair[0], dirs["jax"], **LADDER)
    export_model(pair[1], dirs["unfused"], **LADDER)
    export_model(fused_live, dirs["fused"], **LADDER)
    return dirs


@pytest.fixture(scope="module")
def runtimes(artifacts):
    from optispeech_tpu.export.exporter import ExportedOptiSpeech as JaxExported

    return {"jax": JaxExported(artifacts["jax"]),
            "unfused": ExportedOptiSpeech(artifacts["unfused"], device="cpu"),
            "fused": ExportedOptiSpeech(artifacts["fused"], device="cpu")}


def _inputs(rows, tb, seed, factors=(1.0, 1.0, 1.0)):
    """`rows` rows of seeded ids that fill text bucket `tb` (the longest
    row exactly)."""
    rng = np.random.default_rng(seed)
    lengths = [tb] + list(rng.integers(tb // 2 + 1, tb + 1, rows - 1))
    x, x_lengths = random_tokens(rng, lengths, tb)
    d, p, e = factors
    return InferenceInputs(x=x.astype(np.int64), x_lengths=x_lengths.astype(np.int64),
                           clean_text="seeded", d_factor=d, p_factor=p, e_factor=e)


RUNGS = [(16, 1, (1.0, 1.0, 1.0)), (16, 2, (1.3, 1.1, 0.9)), (32, 1, (1.3, 1.1, 0.9)),
         (32, 2, (1.0, 1.0, 1.0)), (32, 3, (0.8, 1.0, 1.2))]


@pytest.mark.parametrize("tb,rows,factors", RUNGS)
def test_unfused_artifact_matches_jax_artifact_at_every_rung(runtimes, tb, rows, factors):
    """Each text bucket at each batch rung (3 rows: a slab of 2, then 1),
    the factors as 0-d inputs."""
    inputs = _inputs(rows, tb, seed=tb + rows, factors=factors)
    got = runtimes["unfused"].synthesise(inputs)
    want = runtimes["jax"].synthesise(inputs)
    np.testing.assert_array_equal(got.durations, want.durations)
    np.testing.assert_array_equal(got.wav_lengths, want.wav_lengths)
    assert got.wav.shape == want.wav.shape and got.latency > 0 and got.rtf > 0
    np.testing.assert_allclose(got.wav, want.wav, atol=ATOL, rtol=0)


def _valid(wav, lengths):
    return [np.asarray(wav)[i, :int(n)] for i, n in enumerate(lengths)]


@pytest.mark.parametrize("tb,rows,factors", RUNGS)
def test_fused_artifact_matches_the_live_fused_model(runtimes, fused_live, tb, rows, factors):
    """The live fused model decoding at the artifact's frame count, so that
    both run B1's twin in the same blocks at the same T."""
    inputs = _inputs(rows, tb, seed=tb + rows, factors=factors)
    got = runtimes["fused"].synthesise(inputs)
    live = fused_live.synthesise_on_device(inputs, MELS[tb])
    np.testing.assert_array_equal(got.durations, live["durations"].numpy())
    np.testing.assert_array_equal(got.wav_lengths, live["wav_lengths"].numpy())
    for g, w in zip(_valid(got.wav, got.wav_lengths),
                    _valid(live["wav"].numpy(), got.wav_lengths)):
        np.testing.assert_allclose(g, w, atol=LIVE_ATOL, rtol=0)


def test_fused_artifact_matches_jax_s_fused_model_in_interpret_mode(pair, runtimes, monkeypatch):
    """JAX's live fused model, its blocks on the Pallas kernel in interpret
    mode (as tests/test_torch_fused_convnext.py runs it), at the artifact's
    frame count: durations equal, wav within 1e-4."""
    import optispeech_tpu.ops.pallas_convnext as pc
    from optispeech_tpu.models.optispeech import OptiSpeech as JaxOptiSpeech

    g = pair[0].cfg.generator
    g = dataclasses.replace(g, decoder=dataclasses.replace(g.decoder, fused_pallas=True),
                            vocoder=dataclasses.replace(g.vocoder, fused_pallas=True))
    orig, calls = pc.convnext_block_fused, []

    def interp(*args, **kw):
        calls.append(args[0].shape[1])
        return orig(*args, interpret=True, **kw)

    monkeypatch.setattr(pc, "convnext_block_fused", interp)
    monkeypatch.setattr(pc, "fused_supported", lambda: True)
    japi = JaxOptiSpeech(dataclasses.replace(pair[0].cfg, generator=g), params=pair[0].params)
    inputs = _inputs(2, 32, seed=7, factors=(1.3, 1.1, 0.9))
    want = japi.synthesise_on_device(inputs, MELS[32])
    assert calls == [MELS[32]] * FUSED_BLOCKS
    got = runtimes["fused"].synthesise(inputs)
    np.testing.assert_array_equal(got.durations, np.asarray(want["durations"]))
    np.testing.assert_array_equal(got.wav_lengths, np.asarray(want["wav_lengths"]))
    for g, w in zip(_valid(got.wav, got.wav_lengths),
                    _valid(want["wav"], got.wav_lengths)):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_artifact_replay_runs_b1_s_twin_in_every_fused_block(runtimes, monkeypatch):
    """On the CPU the op runs B1's twin: once per fused block in each decode
    replay, and never in the unfused artifact."""
    calls, twin = [], fc.convnext_block_reference
    monkeypatch.setattr(fc, "convnext_block_reference",
                        lambda x, *a: calls.append(tuple(x.shape)) or twin(x, *a))
    inputs = _inputs(2, 16, seed=3)
    runtimes["unfused"].synthesise(inputs)
    assert calls == []
    runtimes["fused"].synthesise(inputs)
    assert len(calls) == FUSED_BLOCKS and {c[:2] for c in calls} == {(2, MELS[16])}


def test_multispeaker_multilanguage_artifact_matches_jax_per_speaker(tmp_path):
    """sids and lids as graph inputs: each speaker's wav is JAX's for that
    speaker, another speaker gives another wav, and an unknown one raises."""
    from optispeech_tpu.models.optispeech import OptiSpeech as JaxOptiSpeech

    cfg = export_config(num_speakers=3, languages=("en-us", "en-gb"))
    speakers = ["alice", "bob", "carol"]
    japi = JaxOptiSpeech(cfg, seed=0, speakers=speakers)
    tapi = OptiSpeech.load_from_jax_params(to_torch_config(cfg), params_np(japi.params),
                                           device="cpu", speakers=speakers)
    export_model(tapi, str(tmp_path), text_buckets=(16,), frames_per_token=8,
                 batch_sizes=(1,), stream_chunk_frames=None)
    runtime = ExportedOptiSpeech(str(tmp_path), device="cpu")
    assert runtime.has_speaker_inputs and runtime.speakers == speakers
    assert runtime.num_speakers == 3 and runtime.num_languages == 2
    wavs = {}
    for speaker in ("alice", "carol"):
        inputs = runtime.prepare_input("hello world", speaker=speaker, lang="en-gb")
        assert int(inputs.sids[0]) == speakers.index(speaker) and int(inputs.lids[0]) == 1
        got = runtime.synthesise(inputs)
        want = japi.synthesise_on_device(inputs, MELS[16])  # at the artifact's frame count
        np.testing.assert_array_equal(got.durations, np.asarray(want["durations"]))
        n = int(want["wav_lengths"][0])
        assert int(got.wav_lengths[0]) == n
        np.testing.assert_allclose(got.wav[0, :n], np.asarray(want["wav"])[0, :n], atol=ATOL)
        wavs[speaker] = got.wav[0, :n]
    n = min(len(w) for w in wavs.values())
    assert np.abs(wavs["alice"][:n] - wavs["carol"][:n]).max() > 1e-4
    with pytest.raises(ValueError, match="nobody"):
        runtime.prepare_input("hi", speaker="nobody")


def test_prewarm_replays_every_rung_under_jax_s_keys(runtimes):
    from optispeech_tpu.cli import serve as jax_serve

    from optispeech_tpu_torch.cli import serve as port_serve

    got = port_serve.prewarm(runtimes["fused"])
    want = jax_serve.prewarm(runtimes["jax"])
    assert list(got) == list(want) == ["encode_16_b1", "encode_16_b2", "encode_32_b1",
                                       "encode_32_b2", "stream"]
    assert all(t >= 0 for t in got.values())
    assert list(port_serve.prewarm(runtimes["fused"], stream=False)) == list(got)[:-1]


def test_speak_cli_writes_jax_s_wavs(artifacts, tmp_path):
    """cli/speak.py on the unfused artifact writes the files JAX's writes
    from its artifact, within 1e-4 plus one int16 step."""
    from optispeech_tpu.cli.speak import main as jax_speak
    from optispeech_tpu.utils.wavio import load_wav as jax_load_wav

    from optispeech_tpu_torch.cli.speak import main as port_speak
    from optispeech_tpu_torch.utils.wavio import load_wav

    args = [TEXT, "--d-factor", "1.2"]
    outputs = port_speak([artifacts["unfused"], args[0], str(tmp_path / "port"), *args[1:],
                          "--device", "cpu"])
    jax_speak([artifacts["jax"], args[0], str(tmp_path / "jax"), *args[1:]])
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == ["gen-1.wav", "gen-2.wav"]
    assert len(outputs.wav_lengths) == 2
    for name in names:
        got, sr = load_wav(str(tmp_path / "port" / name))
        want, jsr = jax_load_wav(str(tmp_path / "jax" / name))
        assert sr == jsr == 24000 and len(got) == len(want) > 0
        np.testing.assert_allclose(got, want, atol=ATOL + 1 / 32768)


def test_speak_cli_needs_a_device_without_a_card(artifacts, tmp_path, monkeypatch):
    from optispeech_tpu_torch.cli.speak import main as port_speak

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_speak([artifacts["fused"], TEXT, str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ExportedOptiSpeech(artifacts["fused"])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("wire", [None, "pcm16", "mulaw"])
def test_artifact_stream_matches_the_live_streamer(runtimes, fused_live, wire):
    """The artifact's windows (the first from frame 0, then chunk + 2 x
    overlap) replay the live fused streamer's, B1's twin at each window's
    length: float32 within 1e-5, the wires equal up to one step."""
    inputs = fused_live.prepare_input("hello world this is long", split_sentences=False,
                                      d_factor=3.0)
    assert inputs.x.shape[1] <= 32
    got = list(ExportedStreamingSynthesiser(runtimes["fused"]).stream(inputs, wire=wire))
    want = list(StreamingSynthesiser(fused_live, 16, 16).stream(inputs, wire=wire))
    assert len(got) == len(want) > 2
    assert [len(c) for c in got] == [len(c) for c in want]
    got, want = np.concatenate(got), np.concatenate(want)
    assert got.dtype == want.dtype
    if wire is None:
        np.testing.assert_allclose(got, want, atol=LIVE_ATOL, rtol=0)
    else:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_streamless_artifact_has_no_streamer(artifacts, pair, tmp_path):
    export_model(pair[1], str(tmp_path), text_buckets=(16,), frames_per_token=8,
                 batch_sizes=(1,), stream_chunk_frames=None)
    runtime = ExportedOptiSpeech(str(tmp_path), device="cpu")
    assert runtime.stream_meta is None
    assert sorted(runtime._graphs) == ["decode_16_128", "encode_16"]
    with pytest.raises(ValueError, match="no stream graphs"):
        ExportedStreamingSynthesiser(runtime)


def test_metadata_equals_jax_s(artifacts):
    metas = {}
    for name in ("jax", "unfused"):
        with open(os.path.join(artifacts[name], "metadata.json")) as f:
            metas[name] = json.load(f)
    assert metas["unfused"] == metas["jax"]
    assert metas["jax"]["stream"] == {"chunk_frames": 16, "overlap": 16, "window": 48,
                                      "f0_cond": False}
    with open(os.path.join(artifacts["fused"], "metadata.json")) as f:
        fused = json.load(f)
    assert fused["config"]["generator"]["vocoder"]["fused_pallas"] is True
    assert {k: v for k, v in fused.items() if k != "config"} == {
        k: v for k, v in metas["jax"].items() if k != "config"}


@pytest.mark.parametrize("key", GRAPHS)
def test_every_graph_holds_one_op_node_per_fused_block(runtimes, key):
    """B1 is one node of the registered op in each decode and stream window
    graph for each fused block, none in the token-rate graphs, and none
    anywhere in the unfused artifact."""
    def nodes(runtime):
        return sum(n.target == OP for n in runtime._graphs[key].graph.nodes)

    frame_rate = key.startswith("decode") or key.startswith("stream_decode")
    assert nodes(runtimes["fused"]) == (FUSED_BLOCKS if frame_rate else 0)
    assert nodes(runtimes["unfused"]) == 0


@pytest.mark.parametrize("key", GRAPHS)
def test_every_graph_replays_on_the_meta_device(artifacts, key):
    """Each graph moved to `meta` runs on meta inputs (B1's op through its
    fake): a CPU constant baked into a graph would fail here."""
    from torch.export.passes import move_to_device_pass
    from torch.utils import _pytree as pytree

    ep = torch.export.load(os.path.join(artifacts["fused"], "graphs", f"{key}.pt2"))
    ep = move_to_device_pass(ep, "meta")
    user = [n for n in ep.graph.nodes if n.op == "placeholder"
            and n.name in ep.graph_signature.user_inputs]
    flat = [torch.empty(n.meta["val"].shape, dtype=n.meta["val"].dtype, device="meta")
            for n in user]
    args, kwargs = pytree.tree_unflatten(flat, ep.call_spec.in_spec)
    out = pytree.tree_leaves(ep.module()(*args, **kwargs))
    assert out and all(t.device.type == "meta" for t in out)
    assert not ep.state_dict  # the parameters are inputs
    assert all(t.device.type == "meta" for t in ep.constants.values())


def test_params_file_holds_the_state_dict_and_each_fused_block_s_pack(artifacts, fused_live):
    params = torch.load(os.path.join(artifacts["fused"], "params.pt"), weights_only=True)
    state = fused_live.generator.state_dict()
    fused = [k for k in params if ".fused." in k]
    assert set(params) - set(fused) == set(state)
    blocks = port_export.fused_blocks(fused_live.generator)
    assert len(blocks) == FUSED_BLOCKS
    assert fused == [f"{p}.fused.{k}" for p in blocks for k in port_export.FUSED_KEYS]
    for path, block in blocks.items():
        prepared = block.fused_params()
        for k, t in zip(port_export.FUSED_KEYS, prepared):
            assert torch.equal(params[f"{path}.fused.{k}"], t), (path, k)
        assert params[f"{path}.fused.packed"].dtype == torch.bfloat16


def test_a_jax_artifact_is_refused(artifacts):
    from optispeech_tpu_torch.cli import serve as port_serve

    with pytest.raises(ValueError, match="artifact of the JAX package"):
        ExportedOptiSpeech(artifacts["jax"], device="cpu")
    with pytest.raises(ValueError, match="artifact of the JAX package"):
        port_serve.load_model(artifacts["jax"], device="cpu")


def test_cli_export_writes_a_fused_artifact(pair, tmp_path):
    """cli/export.py loads the checkpoint fused, on the CPU, and writes JAX's
    keys for its ladders."""
    from optispeech_tpu_torch.cli.export import main as export_main

    pair[1].save_checkpoint(str(tmp_path / "ckpt"))
    out = export_main([str(tmp_path / "ckpt"), str(tmp_path / "art"), "--text-buckets", "16",
                       "--batch-sizes", "1,2", "--frames-per-token", "8",
                       "--stream-chunk-frames", "0"])
    assert out == str(tmp_path / "art")
    runtime = ExportedOptiSpeech(out, device="cpu")
    assert sorted(runtime._graphs) == ["decode_16_128", "decode_16_128_b2", "encode_16",
                                       "encode_16_b2"]
    assert runtime.metadata["config"]["generator"]["decoder"]["fused_pallas"] is True
    assert sum(n.target == OP for n in runtime._graphs["decode_16_128"].graph.nodes) == 4


def test_f0_conditioned_artifact_matches_the_live_model(tmp_path):
    """An f0-conditioned vocoder takes the pitch as a decode input and the
    frame-level pitch through the stream graphs: the artifact against the
    live fused model at the same frame count, and its stream against the
    live streamer, within 1e-5."""
    cfg = with_fused_blocks(to_torch_config(export_config(f0_cond=True)))
    live = OptiSpeech(cfg, seed=1, device="cpu")
    export_model(live, str(tmp_path), text_buckets=(32,), frames_per_token=8,
                 batch_sizes=(2,), stream_chunk_frames=16, stream_overlap=16)
    runtime = ExportedOptiSpeech(str(tmp_path), device="cpu")
    assert runtime.metadata["inference"]["f0_cond"] is True
    inputs = _inputs(2, 32, seed=11, factors=(1.0, 1.2, 1.0))
    got = runtime.synthesise(inputs)
    want = live.synthesise_on_device(inputs, MELS[32])
    np.testing.assert_array_equal(got.durations, want["durations"].numpy())
    for g, w in zip(_valid(got.wav, got.wav_lengths),
                    _valid(want["wav"].numpy(), got.wav_lengths)):
        np.testing.assert_allclose(g, w, atol=LIVE_ATOL, rtol=0)
    row = live.prepare_input("hello world this is long", split_sentences=False, d_factor=3.0)
    streamed = ExportedStreamingSynthesiser(runtime).synthesise(row)
    np.testing.assert_allclose(streamed, StreamingSynthesiser(live, 16, 16).synthesise(row),
                               atol=LIVE_ATOL, rtol=0)
