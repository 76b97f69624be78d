"""The serving runtime (cli/serve.py), port servers on `device="cpu"` at
127.0.0.1:0, held against the JAX package's server.

- One request sent to a fresh JAX server and a fresh port server on the
  same weights: equal lengths, pcm16 within ATOL = 1e-4 plus one rounding
  step (`PCM16_STEPS`).
- The four formats and their headers; /health, /info, 400, 404.
- Concurrent requests coalesce into fewer batches; requests with other
  factors are still served; a two-speaker batch keeps each row's speaker.
- Backpressure answers 429 with Retry-After and recovers; a failed batch
  answers 500 and the server keeps serving.
- The frame-cap estimator decays and keeps to the power-of-two ladder,
  with a stub model and no JAX; `prewarm` runs JAX's keys and calls.
- /stream matches the batch output within 64 steps
  (tests/test_serve.py:206) and its µ-law decodes above 25 dB SNR.
- An exported artifact (`export/exporter.py`): /synthesise in each format
  equal to its own replay, coalescing, /info from its metadata, /stream
  from its stream graphs, and 501 on /stream without them; `main` without
  `--device` and without a card raises; the first kernel build and the launch counts
  hold across threads.
- On the card only: a server on the card against the CPU model, with
  chip_smoke.py phase 16(c)'s bounds.

JAX and the test-size configurations (`torch_parity`) are imported inside
the tests that use them, so that the card-only test collects on a machine
without JAX:
    python -m pytest --noconftest tests/test_torch_serve.py -k card
"""

import base64
import http.client
import io
import json
import math
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from optispeech_tpu_torch.cli import serve as port_serve
from optispeech_tpu_torch.models.optispeech import OptiSpeech
from optispeech_tpu_torch.ops.mulaw import mulaw_decode
from optispeech_tpu_torch.utils.bucketing import round_up_pow2_bucket
from optispeech_tpu_torch.values import InferenceInputs

from torch_card import cuda  # noqa: F401  (fixture)

torch.set_num_threads(1)

ATOL = 1e-4
PCM16_STEPS = math.ceil(ATOL * 32767) + 1
CARD_WAV_ATOL = 2e-3  # chip_smoke.py's WAV_ATOL: the card's kernel against the CPU twin
TEXT = "The birch canoe slid on the smooth planks. Glue the sheet to the dark blue background."
SHORT = "hello there"
LONG = "hello world this is a much longer sentence for streaming synthesis"


def _start(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd):
    httpd.shutdown()
    httpd.server_close()


def _post(base, payload, path="/synthesise"):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return json.load(r)


def _pcm(body) -> np.ndarray:
    return np.frombuffer(base64.b64decode(json.loads(body)["pcm16_b64"]), "<i2")


def _concurrently(base, payloads):
    results = [None] * len(payloads)

    def hit(i):
        results[i] = _post(base, payloads[i])

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    return results


def _snr_db(ref, got):
    return 10 * np.log10(max(float((ref ** 2).mean()), 1e-12)
                         / max(float(((got - ref) ** 2).mean()), 1e-12))


@pytest.fixture(scope="module")
def pair():
    from torch_parity import build_pair, small_config

    return build_pair(small_config())


@pytest.fixture(scope="module")
def server(pair):
    httpd = port_serve.serve(pair[1], host="127.0.0.1", port=0, max_batch=8,
                             batch_wait_ms=300.0)
    base = _start(httpd)
    assert _post(base, {"text": SHORT, "format": "json"})[0] == 200
    yield base, httpd
    _stop(httpd)


def test_served_answer_matches_jax_server(pair):
    from optispeech_tpu.cli import serve as jax_serve

    japi, tapi = pair
    answers = {}
    for name, module, model in (("jax", jax_serve, japi), ("port", port_serve, tapi)):
        httpd = module.serve(model, host="127.0.0.1", port=0, max_batch=8, batch_wait_ms=10.0)
        try:
            code, headers, body = _post(_start(httpd), {"text": TEXT, "format": "pcm16"})
        finally:
            _stop(httpd)
        assert code == 200 and "X-Truncated" not in headers
        answers[name] = np.frombuffer(body, "<i2").astype(int)
    assert len(answers["port"]) == len(answers["jax"]) > 0
    assert np.abs(answers["port"] - answers["jax"]).max() <= PCM16_STEPS


def test_formats_and_headers(server):
    from scipy.io import wavfile

    base, httpd = server
    health = _get(base, "/health")
    assert health["status"] == "ok" and health["requests_served"] >= 1
    info = _get(base, "/info")
    assert info["sample_rate"] == httpd.batcher.model.sample_rate
    assert info["max_batch"] == 8 and info["batch_wait_ms"] == 300.0
    assert info["languages"] == ["en-us"] and info["speakers"] == []

    code, headers, body = _post(base, {"text": TEXT, "format": "json"})
    assert code == 200 and headers["Content-Type"] == "application/json"
    obj = json.loads(body)
    pcm = _pcm(body)
    assert len(pcm) > 0 and obj["sample_rate"] == info["sample_rate"]
    assert obj["truncated"] is False and obj["latency_ms"] > 0

    code, headers, body = _post(base, {"text": TEXT})  # wav is the default
    assert code == 200 and headers["Content-Type"] == "audio/wav" and body[:4] == b"RIFF"
    sr, data = wavfile.read(io.BytesIO(body))
    assert sr == info["sample_rate"]
    np.testing.assert_array_equal(data, pcm)

    code, headers, body = _post(base, {"text": TEXT, "format": "pcm16", "language": "en-us"},
                                path="/synthesize")
    assert code == 200 and headers["Content-Type"] == "application/octet-stream"
    assert int(headers["X-Sample-Rate"]) == info["sample_rate"]
    np.testing.assert_array_equal(np.frombuffer(body, "<i2"), pcm)

    code, headers, body = _post(base, {"text": TEXT, "format": "mulaw"})
    assert code == 200 and headers["X-Encoding"] == "mulaw"
    codes = np.frombuffer(body, np.uint8)
    assert len(codes) == len(pcm)  # a quarter of the float32 bytes, the same samples
    ref = pcm.astype(np.float32) / 32767.0
    assert _snr_db(ref, mulaw_decode(codes)) > 25.0
    assert "X-Truncated" not in headers


def test_missing_text_is_400_and_unknown_paths_are_404(server):
    base, _ = server
    code, _, body = _post(base, {})
    assert code == 400 and "text" in json.loads(body)["error"]
    code, _, _ = _post(base, {"text": SHORT}, path="/nowhere")
    assert code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + "/nowhere", timeout=30)
    assert e.value.code == 404


def test_concurrent_requests_coalesce_into_batches(server):
    base, httpd = server
    single = _pcm(_post(base, {"text": SHORT, "format": "json"})[2])
    b0, r0 = httpd.batcher.batches_run, httpd.batcher.requests_served
    results = _concurrently(base, [{"text": SHORT, "format": "json"}] * 4)
    assert all(code == 200 for code, _, _ in results)
    assert httpd.batcher.requests_served - r0 == 4
    assert httpd.batcher.batches_run - b0 < 4  # the 300 ms window merged some
    for _, _, body in results:
        got = _pcm(body)
        assert len(got) == len(single)
        assert np.abs(got.astype(int) - single.astype(int)).max() <= PCM16_STEPS


def test_incompatible_factors_still_served(server):
    base, _ = server
    results = _concurrently(base, [{"text": SHORT, "format": "json", "d_factor": 2.0},
                                   {"text": SHORT, "format": "json"},
                                   {"text": SHORT, "format": "json", "d_factor": 2.0}])
    assert all(code == 200 for code, _, _ in results)
    slow, fast, slow2 = (_pcm(body) for _, _, body in results)
    assert len(slow) > len(fast)  # d_factor 2.0 ~ twice the duration
    assert len(slow) == len(slow2)
    assert np.abs(slow.astype(int) - slow2.astype(int)).max() <= PCM16_STEPS


def test_two_speaker_batch_keeps_each_row_s_speaker():
    from torch_parity import small_config, to_torch_config

    model = OptiSpeech(to_torch_config(small_config(num_speakers=2)), seed=0, device="cpu")
    httpd = port_serve.serve(model, host="127.0.0.1", port=0, max_batch=8, batch_wait_ms=300.0)
    try:
        base = _start(httpd)
        results = _concurrently(base, [{"text": SHORT, "format": "json", "speaker": s}
                                       for s in (0, 1, 0, 1)])
        batches = httpd.batcher.batches_run
    finally:
        _stop(httpd)
    assert all(code == 200 for code, _, _ in results) and batches < 4
    got = [_pcm(body).astype(int) for _, _, body in results]
    for s in (0, 1):
        inputs = model.prepare_input(SHORT, speaker=s)
        out = model.synthesise_on_device(inputs, 128, pcm16=True)
        ref = out["wav_pcm16"][0, : int(out["wav_lengths"][0])].numpy().astype(int)
        for g in got[s::2]:
            assert len(g) == len(ref) and np.abs(g - ref).max() <= PCM16_STEPS
    n = min(len(got[0]), len(got[1]))
    assert np.abs(got[0][:n] - got[1][:n]).max() > 10 * PCM16_STEPS  # the speakers differ


class Gated:
    """A model whose `synthesise_on_device` waits for `release`, and
    raises while `fail` is set."""

    def __init__(self, model):
        self.model = model
        self.release = threading.Event()
        self.fail = False

    def __getattr__(self, name):
        return getattr(self.model, name)

    def synthesise_on_device(self, *args, **kw):
        assert self.release.wait(60)
        if self.fail:
            raise RuntimeError("injected failure")
        return self.model.synthesise_on_device(*args, **kw)


def test_backpressure_answers_429_then_recovers_and_a_failed_batch_answers_500(pair):
    gated = Gated(pair[1])
    httpd = port_serve.serve(gated, host="127.0.0.1", port=0, max_batch=1, batch_wait_ms=1.0,
                             max_pending=1)
    try:
        base = _start(httpd)
        first = []
        waiting = threading.Thread(target=lambda: first.append(_post(base, {"text": SHORT})))
        waiting.start()
        for _ in range(200):  # until the first request holds the only slot
            if httpd.batcher._inflight == 1:
                break
            time.sleep(0.01)
        code, headers, body = _post(base, {"text": SHORT})
        assert code == 429 and headers["Retry-After"] == "1"
        assert "capacity" in json.loads(body)["error"]
        assert httpd.batcher.requests_rejected == 1
        gated.release.set()
        waiting.join(60)
        assert not waiting.is_alive() and first[0][0] == 200
        for _ in range(100):  # the slot frees after the answer's event
            code = _post(base, {"text": SHORT, "format": "json"})[0]
            if code != 429:
                break
            time.sleep(0.05)
        assert code == 200

        gated.fail = True
        code, _, body = _post(base, {"text": SHORT})
        assert code == 500 and json.loads(body)["error"] == "injected failure"
        gated.fail = False
        assert _post(base, {"text": SHORT})[0] == 200  # still serving
        assert httpd.batcher._thread.is_alive()
    finally:
        gated.release.set()
        _stop(httpd)


class StubModel:
    """Returns `frames_per_token` frames a token, capped at n_frames."""

    hop_length = 4
    mel_bucket = 32
    sample_rate = 16000
    cfg = types.SimpleNamespace(data=types.SimpleNamespace(max_mel_len=1024))

    def __init__(self):
        self.frames_per_token = 3.0
        self.calls = []

    def synthesise_on_device(self, inputs, n_frames, pcm16=False, mulaw=False):
        self.calls.append(n_frames)
        frames = np.minimum(np.ceil(inputs.x_lengths * self.frames_per_token * inputs.d_factor),
                            n_frames).astype(np.int32)
        b = inputs.x.shape[0]
        return {"wav_lengths": torch.from_numpy(frames * self.hop_length),
                "wav_pcm16": torch.zeros((b, n_frames * self.hop_length), dtype=torch.int16)}


def test_frame_cap_estimator_decays_and_keeps_to_the_ladder():
    stub = StubModel()
    batcher = port_serve.Batcher(stub, max_batch=4, wait_ms=1.0)
    ladder = {32 * 2 ** k for k in range(6)}  # 32 .. 1024 = max_mel_len

    def run(tokens=10, d_factor=1.0):
        merged = InferenceInputs.from_ids_and_lengths(
            ids=[[5] * tokens], lengths=[tokens], clean_text="x", d_factor=d_factor)
        stub.calls.clear()
        _, lengths, truncated, _ = batcher._synthesise_batch(merged)
        assert set(stub.calls) <= ladder
        return list(stub.calls), int(lengths[0]), bool(truncated[0])

    assert run() == ([round_up_pow2_bucket(80, 32)], 120, False)  # the initial 8 frames/token
    assert run()[0] == [64]  # 3 frames/token x 1.25 headroom x 10 tokens -> 37.5
    stub.frames_per_token = 40.0  # an outlier: the cap doubles until it fits
    assert run() == ([64, 128, 256, 512], 1600, False)
    assert run()[0] == [512]
    stub.frames_per_token = 200.0  # beyond max_mel_len: cut there, and flagged
    assert run() == ([512, 1024], 4096, True)
    stub.frames_per_token = 3.0
    for _ in range(batcher._fpt_window.maxlen):  # the outliers age out
        run()
    assert max(batcher._fpt_window) == 3.0
    assert run()[0] == [64]
    assert run(d_factor=2.0)[0] == [128]  # kept per unit d_factor
    assert run()[0] == [64]


@pytest.mark.parametrize("num_speakers", [1, 2])
def test_prewarm_runs_jax_s_keys_and_calls(num_speakers):
    from optispeech_tpu.cli import serve as jax_serve

    class Recorder(StubModel):
        text_bucket = 16

        def synthesise_on_device(self, inputs, n_frames, pcm16=False, mulaw=False):
            self.calls.append((inputs.x.shape, inputs.x_lengths.tolist(),
                               None if inputs.sids is None else inputs.sids.tolist(),
                               n_frames, pcm16, mulaw))
            return {"wav_lengths": torch.zeros(inputs.x.shape[0], dtype=torch.int32)}

    models = {}
    for name, module in (("jax", jax_serve), ("port", port_serve)):
        models[name] = Recorder()
        models[name].num_speakers = num_speakers
        keys = module.prewarm(models[name], max_batch=8)
        assert list(keys) == ["b1_pcm16", "b1_mulaw", "b2_pcm16", "b2_mulaw", "b4_pcm16",
                              "b4_mulaw", "b8_pcm16", "b8_mulaw"]
    assert models["port"].calls == models["jax"].calls


def _stream(port, payload):
    """POST /stream; returns (status, headers, [chunks])."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/stream", json.dumps(payload).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        headers = dict(resp.headers)
        chunks = []
        if resp.status == 200:  # read the transfer chunks one by one
            while True:
                size = int(resp.fp.readline().strip(), 16)
                if size == 0:
                    resp.fp.readline()
                    break
                chunks.append(resp.fp.read(size))
                assert resp.fp.read(2) == b"\r\n"
        return resp.status, headers, chunks
    finally:
        conn.close()


def test_stream_matches_batch_output(pair):
    tapi = pair[1]
    # small windows, so that several chunks flow (the small model's receptive
    # field is 15 frames, so an overlap of 16 suffices)
    httpd = port_serve.serve(tapi, host="127.0.0.1", port=0, max_batch=4, batch_wait_ms=10.0,
                             stream_chunk_frames=16, stream_overlap=16)
    try:
        base = _start(httpd)
        payload = {"text": LONG, "d_factor": 3.0}
        code, headers, chunks = _stream(httpd.server_address[1], payload)
        assert code == 200 and headers["Transfer-Encoding"] == "chunked"
        assert int(headers["X-Sample-Rate"]) == tapi.sample_rate
        assert len(chunks) > 2
        assert all(len(c) == 16 * tapi.hop_length * 2 for c in chunks[:-1])
        streamed = np.frombuffer(b"".join(chunks), "<i2")

        code, _, body = _post(base, {**payload, "format": "json"})
        assert code == 200 and not json.loads(body)["truncated"]
        batch = _pcm(body)
        assert len(streamed) == len(batch) > 0
        assert np.abs(streamed.astype(int) - batch.astype(int)).max() <= 64

        code, headers, chunks = _stream(httpd.server_address[1], {**payload, "format": "mulaw"})
        assert code == 200 and headers["X-Encoding"] == "mulaw"
        codes = np.frombuffer(b"".join(chunks), np.uint8)
        assert len(codes) == len(streamed)
        assert _snr_db(streamed.astype(np.float32) / 32767.0, mulaw_decode(codes)) > 25.0
    finally:
        _stop(httpd)


@pytest.fixture(scope="module")
def artifact(pair, tmp_path_factory):
    """The fused artifact of `pair`'s weights (text buckets 32 and 64, batch
    rungs 1, 2 and 4, stream windows of 16 frames with 16 of overlap) and
    a server on it: (runtime, base URL, server)."""
    from optispeech_tpu_torch.export.exporter import export_model
    from optispeech_tpu_torch.models.optispeech import with_fused_blocks

    tapi = pair[1]
    fused = OptiSpeech(with_fused_blocks(tapi.cfg), device="cpu",
                       state_dict=tapi.generator.state_dict())
    path = str(tmp_path_factory.mktemp("artifact"))
    export_model(fused, path, text_buckets=(32, 64), frames_per_token=8, batch_sizes=(1, 2, 4),
                 stream_chunk_frames=16, stream_overlap=16)
    model = port_serve.load_model(path, bf16=True, device="cpu")  # bf16 is the live model's
    httpd = port_serve.serve(model, host="127.0.0.1", port=0, max_batch=4, batch_wait_ms=300.0)
    base = _start(httpd)
    yield model, base, httpd
    _stop(httpd)


def _artifact_pcm(model, text):
    """The artifact's own replay of `text`, as the server's pcm16 rows."""
    out = model.synthesise(model.prepare_input(text, split_sentences=True))
    rows = [np.clip(w, -1, 1) for w in out.unbatched_wavs()]
    return np.concatenate([(r * 32767.0).astype("<i2") for r in rows])


@pytest.mark.parametrize("fmt", ["wav", "pcm16", "mulaw", "json"])
def test_artifact_server_answers_each_format(artifact, fmt):
    """/synthesise on an artifact: its own replay's audio in each format,
    the wire transcoded on the host; nothing truncated."""
    from scipy.io import wavfile

    from optispeech_tpu_torch.export.exporter import ExportedOptiSpeech
    from optispeech_tpu_torch.ops.mulaw import mulaw_encode_np

    model, base, _ = artifact
    assert isinstance(model, ExportedOptiSpeech) and model._rungs == {32: [1, 2, 4],
                                                                      64: [1, 2, 4]}
    code, headers, body = _post(base, {"text": TEXT, "format": fmt})
    assert code == 200 and "X-Truncated" not in headers
    want = _artifact_pcm(model, TEXT)
    if fmt == "wav":
        assert headers["Content-Type"] == "audio/wav"
        sr, got = wavfile.read(io.BytesIO(body))
        assert sr == model.sample_rate
    elif fmt == "pcm16":
        assert int(headers["X-Sample-Rate"]) == model.sample_rate
        got = np.frombuffer(body, "<i2")
    elif fmt == "json":
        obj = json.loads(body)
        assert obj["truncated"] is False and obj["latency_ms"] > 0
        got = _pcm(body)
    else:
        assert headers["X-Encoding"] == "mulaw"
        got = np.frombuffer(body, np.uint8)
        out = model.synthesise(model.prepare_input(TEXT, split_sentences=True))
        want = np.concatenate([mulaw_encode_np(w) for w in out.unbatched_wavs()])
    np.testing.assert_array_equal(got, want)


def test_artifact_server_coalesces_and_matches_the_live_model(pair, artifact):
    """Concurrent requests coalesce into batches up the artifact's rungs,
    each answer as one request's alone; the artifact's answer is the live
    model's within 64 steps (tests/test_serve.py:303, JAX's bound for an
    artifact against the live model at another frame count)."""
    model, base, httpd = artifact
    single = _pcm(_post(base, {"text": SHORT, "format": "json"})[2])
    b0, r0 = httpd.batcher.batches_run, httpd.batcher.requests_served
    results = _concurrently(base, [{"text": SHORT, "format": "json"}] * 3)
    assert all(code == 200 for code, _, _ in results)
    assert httpd.batcher.requests_served - r0 == 3
    assert httpd.batcher.batches_run - b0 < 3
    for _, _, body in results:
        got = _pcm(body)
        assert len(got) == len(single)
        assert np.abs(got.astype(int) - single.astype(int)).max() <= PCM16_STEPS
    live = pair[1].synthesise(pair[1].prepare_input(SHORT))
    live = (np.clip(live.wav[0, :int(live.wav_lengths[0])], -1, 1) * 32767.0).astype("<i2")
    assert len(live) == len(single)
    assert np.abs(live.astype(int) - single.astype(int)).max() <= 64


def test_artifact_server_info_comes_from_the_metadata(artifact):
    model, base, _ = artifact
    info = _get(base, "/info")
    meta = model.metadata["inference"]
    assert info["sample_rate"] == meta["sample_rate"] == model.sample_rate
    assert info["speakers"] == meta["speakers"] == []
    assert info["num_speakers"] == meta["num_speakers"] == 1
    assert info["languages"] == meta["text_processor"]["languages"] == ["en-us"]
    assert info["max_batch"] == 4


@pytest.mark.parametrize("fmt", ["pcm16", "mulaw"])
def test_artifact_server_streams_from_its_stream_graphs(artifact, fmt):
    """/stream on an artifact replays its stream graphs: 16-frame chunks
    within 64 steps of its /synthesise, µ-law above 25 dB SNR."""
    model, base, httpd = artifact
    payload = {"text": "hello world this is long", "d_factor": 3.0}
    code, _, body = _post(base, {**payload, "format": "json"})
    assert code == 200
    batch = _pcm(body)
    code, headers, chunks = _stream(httpd.server_address[1], {**payload, "format": fmt})
    assert code == 200 and headers["Transfer-Encoding"] == "chunked" and len(chunks) > 2
    if fmt == "pcm16":
        assert all(len(c) == 16 * model.hop_length * 2 for c in chunks[:-1])
        streamed = np.frombuffer(b"".join(chunks), "<i2")
        assert len(streamed) == len(batch) > 0
        assert np.abs(streamed.astype(int) - batch.astype(int)).max() <= 64
    else:
        assert headers["X-Encoding"] == "mulaw"
        codes = np.frombuffer(b"".join(chunks), np.uint8)
        assert len(codes) == len(batch)
        assert _snr_db(batch.astype(np.float32) / 32767.0, mulaw_decode(codes)) > 25.0


def test_stream_on_a_streamless_artifact_is_501(pair, tmp_path):
    from optispeech_tpu_torch.export.exporter import ExportedOptiSpeech, export_model

    export_model(pair[1], str(tmp_path), text_buckets=(32,), frames_per_token=8,
                 batch_sizes=(1,), stream_chunk_frames=None)
    model = port_serve.load_model(str(tmp_path), device="cpu")
    assert isinstance(model, ExportedOptiSpeech) and model.stream_meta is None
    httpd = port_serve.serve(model, host="127.0.0.1", port=0)
    try:
        base = _start(httpd)
        code, _, body = _post(base, {"text": SHORT}, path="/stream")
        assert code == 501 and "no stream graphs" in json.loads(body)["error"]
        assert _post(base, {"text": SHORT, "format": "json"})[0] == 200  # /synthesise serves
    finally:
        _stop(httpd)


def test_serve_needs_a_device_without_a_card(pair, tmp_path, monkeypatch):
    pair[1].save_checkpoint(str(tmp_path / "ckpt"))
    model = port_serve.load_model(str(tmp_path / "ckpt"), device="cpu")
    assert model.device.type == "cpu" and model.generator.vocoder.fused_pallas
    assert model.generator.decoder.fused_pallas  # fused by default
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_serve.load_model(str(tmp_path / "ckpt"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_serve.main([str(tmp_path / "ckpt"), "--host", "127.0.0.1", "--port", "0"])


def test_first_load_builds_once_across_threads(monkeypatch):
    import ctypes.util

    from optispeech_tpu_torch.ops import _build

    libc = ctypes.util.find_library("c")
    builds = []

    def slow_build(names):
        builds.append(list(names))
        time.sleep(0.2)
        return {name: {"path": libc} for name in names}

    monkeypatch.setattr(_build, "build_kernels", slow_build)
    monkeypatch.setattr(_build, "_LIBRARIES", {})
    start = threading.Barrier(8)
    libs = []

    def first_call():
        start.wait()
        libs.append(_build.load("probe"))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=first_call) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert builds == [["probe"]] and len(libs) == 8 and all(lib is libs[0] for lib in libs)


def test_launch_counts_are_exact_across_threads():
    from optispeech_tpu_torch.ops.fused_convnext import count_launch

    def wrapper():
        pass

    wrapper.launches = wrapper.wide_launches = 0

    def count():
        for _ in range(20000):
            count_launch(wrapper, "launches", "wide_launches")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=count) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == wrapper.wide_launches == 8 * 20000


def test_server_on_the_card_matches_the_cpu_model(cuda, tmp_path):  # noqa: F811
    """A server on the card (B1 in the flagship's decoder and trunk) against
    the CPU model (B1's twin) on the request's merged batch at its frame
    cap: pcm16 within CARD_WAV_ATOL plus one step, µ-law codes within one
    on fewer than 1% of samples."""
    import dataclasses

    from optispeech_tpu_torch.config import ExperimentConfig
    from optispeech_tpu_torch.ops import fused_convnext as fc

    cfg = ExperimentConfig()
    tp = dataclasses.replace(cfg.data.text_processor, tokenizer="en-g2p")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, text_processor=tp))
    OptiSpeech(cfg, seed=0, device="cpu").save_checkpoint(str(tmp_path / "ckpt"))
    card = port_serve.load_model(str(tmp_path / "ckpt"))
    cpu = port_serve.load_model(str(tmp_path / "ckpt"), device="cpu")
    assert card.device.type == "cuda"
    calls, synthesise = [], card.synthesise_on_device

    def counted(inputs, n_frames, **kw):
        calls.append(n_frames)
        return synthesise(inputs, n_frames, **kw)

    card.synthesise_on_device = counted
    httpd = port_serve.serve(card, host="127.0.0.1", port=0, max_batch=8, batch_wait_ms=10.0)
    try:
        base = _start(httpd)
        fc.convnext_block_fused.launches = 0
        answers = {fmt: _post(base, {"text": TEXT, "format": fmt}) for fmt in ("pcm16", "mulaw")}
        launches = fc.convnext_block_fused.launches
    finally:
        _stop(httpd)
    assert all(code == 200 for code, _, _ in answers.values())
    assert launches == 12 * len(calls) > 0  # 4 decoder + 8 trunk blocks a call

    pending = port_serve._Pending(cpu.prepare_input(TEXT).as_numpy())
    merged, n_real = httpd.batcher._merge([pending])
    n_frames = round_up_pow2_bucket(int(merged.x_lengths.max()) * 8, cpu.mel_bucket,
                                    cpu.cfg.data.max_mel_len)
    assert calls[0] == n_frames
    out = cpu.synthesise_on_device(merged, n_frames, pcm16=True, mulaw=True)
    lengths = out["wav_lengths"].numpy()[:n_real]
    pcm = np.concatenate([out["wav_pcm16"][i, :n].numpy() for i, n in enumerate(lengths)])
    codes = np.concatenate([out["wav_mulaw"][i, :n].numpy() for i, n in enumerate(lengths)])
    got = np.frombuffer(answers["pcm16"][2], "<i2").astype(int)
    assert len(got) == len(pcm)
    assert np.abs(got - pcm.astype(int)).max() <= math.ceil(CARD_WAV_ATOL * 32767) + 1
    d = np.abs(np.frombuffer(answers["mulaw"][2], np.uint8).astype(int) - codes.astype(int))
    assert d.max() <= 1 and (d != 0).mean() < 0.01
