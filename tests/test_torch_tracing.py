"""The port's spans and counters (`utils/tracing.py`) on the CPU: the shared
no-op context while off; nesting across threads, the snapshot, the Chrome
trace and kineto's clock while on; synthesis and a train step equal bit for
bit with tracing on and off, with their spans; the serving batcher's
per-request spans and counters; launch counts under a capture.

These tests import no JAX.
"""

import dataclasses
import json
import statistics
import threading
import time
import types
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from optispeech_tpu_torch.cli import serve
from optispeech_tpu_torch.ops import fused_convnext, mas
from optispeech_tpu_torch.utils import tracing
from optispeech_tpu_torch.values import InferenceInputs

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def empty_ring():
    tracing.clear()
    yield
    tracing.clear()


def tiny_config():
    from optispeech_tpu_torch.config import (
        BackboneConfig,
        DataConfig,
        DiscriminatorConfig,
        ExperimentConfig,
        FeatureConfig,
        GeneratorConfig,
        SchedulerConfig,
        TrainArgs,
        VocoderConfig,
    )

    feats = FeatureConfig(sample_rate=24000, n_feats=20, n_fft=256, hop_length=64,
                          win_length=256)
    bb = BackboneConfig(kind="convnext", intermediate_dim=64, num_layers=2)
    gen = GeneratorConfig(dim=32, segment_size=16, encoder=bb, decoder=bb,
                          vocoder=VocoderConfig(dim=48, intermediate_dim=96, num_layers=2),
                          features=feats)
    disc = DiscriminatorConfig(periods=(2, 3), resolutions=((256, 64, 256), (128, 32, 128)),
                               mrd_channels=16)
    return ExperimentConfig(
        generator=gen, discriminator=disc, train_args=TrainArgs(pretraining_steps=0),
        scheduler=SchedulerConfig(num_warmup_steps=10, num_training_steps=100),
        data=DataConfig(text_bucket_size=16, mel_bucket_size=64))


def names(snap):
    return [r.name for r in snap.spans]


# -- the recorder -------------------------------------------------------------

def test_off_is_one_shared_null_that_records_nothing():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = tracing.span("decode"), tracing.span("encode", rows=3)
    assert a is b is tracing.NULL
    with a:
        with b:
            pass
    tracing.record("serve/queue", 1, 2, request=1)
    totals = {"merge": 0.0}
    with tracing.timed(totals, "merge", "serve/merge") as t:
        time.sleep(0.002)
    assert totals["merge"] == t.seconds >= 0.002
    assert tracing.snapshot().spans == []


def test_spans_nest_per_thread_with_ids_and_syncs():
    def work(tag):
        with tracing.span("outer", tag=tag) as outer:
            with tracing.span("inner"):
                warnings.warn(tracing.SYNC_WARNING)
                warnings.warn(tracing.SYNC_WARNING)
            warnings.warn(tracing.SYNC_WARNING)
        assert outer.syncs == 3

    with tracing.enable():
        threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        work(2)
        with warnings.catch_warnings(record=True) as caught:  # other warnings pass through
            warnings.simplefilter("always")
            with tracing.span("quiet"):
                warnings.warn("an unrelated warning")
        assert [str(w.message) for w in caught] == ["an unrelated warning"]
    spans = tracing.snapshot().spans
    outers = {r.attrs["tag"]: r for r in spans if r.name == "outer"}
    inners = [r for r in spans if r.name == "inner"]
    assert sorted(outers) == [0, 1, 2] and len(inners) == 3
    assert len({r.id for r in spans}) == len(spans)
    for r in inners:
        parent = next(o for o in outers.values() if o.id == r.parent)
        assert parent.thread == r.thread
        assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
        assert r.syncs == 2 and r.stream_ms is None
    assert all(o.parent == 0 and o.syncs == 3 for o in outers.values())
    assert len({o.thread for o in outers.values()}) == 3
    # off again: the sync warnings are no longer swallowed
    assert warnings.showwarning is not tracing._on_warning


def test_snapshot_clear_dump_and_the_decorator(tmp_path):
    @tracing.traced("step", kind="unit")
    def step(x):
        with tracing.span("inside", n=np.int64(3), ids=[1, 2]):
            return x + 1

    assert step(1) == 2  # off
    with tracing.enable():
        with tracing.enable():  # nests
            assert step(1) == 2
        assert step(2) == 3
        now = time.perf_counter_ns()
        tracing.record("serve/queue", now - 5_000_000, now, request=7)
    assert step(3) == 4  # off again
    snap = tracing.snapshot()
    assert names(snap) == ["inside", "step", "inside", "step", "serve/queue"]
    assert snap.spans[1].attrs == {"kind": "unit"} and snap.spans[4].host_ms == 5.0
    path = tmp_path / "spans.json"
    tracing.dump(path)
    trace = json.loads(path.read_text())
    assert trace["baseTimeNanoseconds"] == 0
    events = trace["traceEvents"]
    assert [e["name"] for e in events] == names(snap)
    unix_us = time.time_ns() / 1e3
    for e in events:
        assert e["ph"] == "X" and e["dur"] >= 0 and e["cat"] == "optispeech"
        assert unix_us - 60e6 < e["ts"] <= unix_us  # the Unix-µs base
        assert {"id", "parent", "syncs"} <= set(e["args"])
    assert events[0]["args"]["n"] == "3" and events[0]["args"]["ids"] == [1, 2]
    assert events[0]["args"]["parent"] == events[1]["args"]["id"]
    tracing.dump(path, base_ns=1_700_000_000_000_000_000)
    shifted = json.loads(path.read_text())["traceEvents"]
    assert abs(events[0]["ts"] - shifted[0]["ts"] - 1.7e15) < 1e6
    tracing.clear()
    assert tracing.snapshot().spans == []


def test_the_clock_is_kineto_s():
    """Under a CPU profiler (tracing on by itself), each span's Unix stamps
    lie at kineto's `optispeech/<name>` event of the same range."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("warm"):  # the profiler's first range pays its set-up
            pass
        for i in range(8):
            with tracing.span("clock", i=i):
                time.sleep(0.001)
    snap = tracing.snapshot()
    ours = [r for r in snap.spans if r.name == "clock"]
    theirs = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == tracing.PREFIX + "clock"), key=lambda e: e.start_ns())
    assert len(ours) == len(theirs) == 8
    gaps = [abs(tracing.to_unix_ns(t, snap.anchor) - k) / 1e3 for r, e in zip(ours, theirs)
            for t, k in ((r.start_ns, e.start_ns()), (r.end_ns, e.end_ns()))]
    assert statistics.median(gaps) < 100, gaps  # µs
    assert max(gaps) < 2000, gaps


# -- the program's spans ------------------------------------------------------

def test_synthesis_equal_with_tracing_on_and_one_encode_and_decode_a_call():
    from optispeech_tpu_torch.models.optispeech import OptiSpeech

    model = OptiSpeech(tiny_config(), seed=3, device="cpu")
    rng = np.random.default_rng(0)
    lengths = [11, 7, 14]
    inputs = InferenceInputs.from_ids_and_lengths(
        ids=[rng.integers(3, 100, n).tolist() for n in lengths], lengths=lengths,
        clean_text="x", d_factor=1.5)
    off = model.synthesise_on_device(inputs, 128, pcm16=True, mulaw=True)
    assert tracing.snapshot().spans == []
    with tracing.enable():
        on = [model.synthesise_on_device(inputs, 128, pcm16=True, mulaw=True)
              for _ in range(2)]
    for out in on:
        assert out.keys() == off.keys()
        for k in off:
            assert torch.equal(out[k], off[k]), k
    snap = tracing.snapshot()
    assert names(snap) == ["encode", "decoder", "vocoder", "decode", "synthesise"] * 2
    by_id = {r.id: r for r in snap.spans}
    for r in snap.spans:
        expected = {"encode": "synthesise", "decode": "synthesise", "decoder": "decode",
                    "vocoder": "decode", "synthesise": None}[r.name]
        assert (by_id[r.parent].name if r.parent else None) == expected
    assert snap.spans[4].attrs == {"rows": 3, "n_frames": 128, "text_width": 16}


def _train_state(cfg):
    from optispeech_tpu_torch.models.discriminator import VocosDiscriminator
    from optispeech_tpu_torch.models.generator import OptiSpeechGenerator
    from optispeech_tpu_torch.models.init import init_like_flax
    from optispeech_tpu_torch.training.state import TrainState

    gen = OptiSpeechGenerator(cfg.generator)
    init_like_flax(gen, torch.Generator().manual_seed(1))
    torch.manual_seed(2)
    disc = VocosDiscriminator(cfg.discriminator, cfg.generator.features)
    return TrainState(cfg, gen, disc, torch.Generator().manual_seed(4))


def _train_batch(cfg, b=2, t_text=16, t_mel=64):
    g = torch.Generator().manual_seed(9)
    feats = cfg.generator.features
    xl = torch.tensor([16, 11], dtype=torch.int32)
    ml = torch.tensor([64, 45], dtype=torch.int32)
    x = torch.randint(3, 100, (b, t_text), generator=g) * (torch.arange(t_text) < xl[:, None])
    seg = cfg.generator.segment_size
    return {"x": x, "x_lengths": xl, "mel": torch.randn((b, feats.n_feats, t_mel), generator=g),
            "mel_lengths": ml, "pitches": torch.randn((b, t_mel), generator=g),
            "energies": torch.randn((b, t_mel), generator=g),
            "wav_seg": 0.1 * torch.randn((b, seg * feats.hop_length), generator=g),
            "start_idx": torch.tensor([3, 20], dtype=torch.int32)}


@pytest.mark.parametrize("cache", [True, False])
def test_train_step_equal_with_tracing_on_and_its_spans(cache):
    from optispeech_tpu_torch.training.step import make_train_step

    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, train_args=dataclasses.replace(
        cfg.train_args, cache_generator_outputs=cache))
    step = make_train_step(cfg)
    batch = _train_batch(cfg)
    states = [_train_state(cfg) for _ in range(2)]
    logs_off = step(states[0], batch)
    assert tracing.snapshot().spans == []
    with tracing.enable():
        logs_on = step(states[1], batch)
    assert logs_on.keys() == logs_off.keys()
    assert all(torch.equal(logs_on[k], logs_off[k]) for k in logs_off)
    for a, b in zip(*(s.generator.state_dict().values() for s in states)):
        assert torch.equal(a, b)
    for a, b in zip(*(s.discriminator.state_dict().values() for s in states)):
        assert torch.equal(a, b)
    snap = tracing.snapshot()
    # without the cache, D's turn runs G's forward again, MAS included
    recompute = [] if cache else ["train/mas"]
    assert names(snap) == ["train/mas", "train/g_turn", "train/g_update", *recompute,
                           "train/d_turn", "train/d_update", "train/step"]
    by_id = {r.id: r for r in snap.spans}
    assert [by_id[r.parent].name for r in snap.spans if r.name == "train/mas"] == [
        "train/g_turn", *("train/d_turn" for _ in recompute)]
    assert {by_id[r.parent].name for r in snap.spans if r.parent and r.name != "train/mas"} \
        == {"train/step"}
    assert snap.spans[-1].parent == 0
    assert all(r.syncs == 0 for r in snap.spans)  # the CPU raises no sync warning


# -- the serving batcher ------------------------------------------------------

class StubModel:
    """Returns `frames_per_token` frames a token, capped at n_frames."""

    hop_length = 4
    mel_bucket = 32
    sample_rate = 16000
    cfg = types.SimpleNamespace(data=types.SimpleNamespace(max_mel_len=1024))

    def __init__(self, frames_per_token=3.0):
        self.frames_per_token = frames_per_token

    def synthesise_on_device(self, inputs, n_frames, pcm16=False, mulaw=False):
        frames = np.minimum(np.ceil(inputs.x_lengths * self.frames_per_token * inputs.d_factor),
                            n_frames).astype(np.int32)
        b = inputs.x.shape[0]
        return {"wav_lengths": torch.from_numpy(frames * self.hop_length),
                "wav_pcm16": torch.zeros((b, n_frames * self.hop_length), dtype=torch.int16)}


def _request(tokens, d_factor=1.0):
    return serve._Pending(InferenceInputs.from_ids_and_lengths(
        ids=[[5] * tokens], lengths=[tokens], clean_text="x", d_factor=d_factor))


def _serve_all(batcher, pendings):
    for p in pendings:
        assert batcher.submit(p)
    for p in pendings:
        assert p.event.wait(timeout=30) and p.error is None


def test_batcher_request_spans_and_counters():
    stub = StubModel()
    batcher = serve.Batcher(stub, max_batch=4, wait_ms=200.0)
    with tracing.enable():
        # the second factor key waits a batch: one deferral
        pendings = [_request(10), _request(12, d_factor=2.0), _request(8)]
        _serve_all(batcher, pendings)
    assert batcher.deferrals == 1 and batcher.frame_cap_retries == 0
    assert batcher.truncated_rows == 0 and batcher.batches_run == 2
    snap = tracing.snapshot()
    queue = {r.attrs["request"]: r for r in snap.spans if r.name == "serve/queue"}
    assert sorted(queue) == sorted(p.id for p in pendings) == [1, 2, 3]
    assert queue[2].attrs["passed_over"] == 1 and queue[1].attrs["passed_over"] == 0
    stages = [r for r in snap.spans if r.name.startswith("serve/") and r.name != "serve/queue"]
    assert [r.name for r in stages] == ["serve/merge", "serve/synthesise", "serve/fetch",
                                        "serve/split"] * 2
    assert [r.attrs for r in stages[::4]] == [{"batch": 1, "requests": [1, 3]},
                                              {"batch": 2, "requests": [2]}]
    for key in batcher.stage_seconds:  # each stage timed once, by its span's clock reads
        spans = [r for r in stages if r.name == f"serve/{key}"]
        assert batcher.stage_seconds[key] == pytest.approx(
            sum(r.end_ns - r.start_ns for r in spans) / 1e9, rel=1e-9, abs=1e-12)

    # an underestimated cap runs again at twice the frames (64 -> 128 -> 256 -> 512 for
    # 400 frames); then the estimate starts at the largest cap, which truncates
    stub.frames_per_token = 40.0
    _serve_all(batcher, [_request(10)])
    assert batcher.frame_cap_retries == 3 and batcher.truncated_rows == 0
    stub.frames_per_token = 200.0
    _serve_all(batcher, [_request(10), _request(11)])
    assert batcher.frame_cap_retries == 3 and batcher.truncated_rows == 2


def test_health_reports_the_counters():
    import http.client

    batcher = serve.Batcher(StubModel(), max_batch=4, wait_ms=1.0)
    batcher.deferrals, batcher.frame_cap_retries, batcher.truncated_rows = 3, 2, 1
    model = types.SimpleNamespace(sample_rate=16000)
    httpd = serve.ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(model, batcher))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=30)
        conn.request("GET", "/health")
        health = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    assert health["deferrals"] == 3 and health["frame_cap_retries"] == 2
    assert health["truncated_rows"] == 1
    assert health["stage_seconds"] == {"merge": 0.0, "synthesise": 0.0, "fetch": 0.0,
                                       "split": 0.0}


# -- launch counters ----------------------------------------------------------

@pytest.mark.parametrize("wrapper,counters", [
    (fused_convnext.convnext_block_fused, ("launches",)),
    (fused_convnext.convnext_block_fused, ("launches", "wide_launches")),
    (fused_convnext.convnext_block_fused_int8, ("launches",)),
    (mas.viterbi_decode, ("launches",)),
    (mas.viterbi_decode_extract, ("launches",)),
])
def test_a_launch_under_capture_counts_as_captured(wrapper, counters, monkeypatch):
    before = {k: getattr(wrapper, k) for k in counters + tuple("captured_" + c for c in counters)}
    for k, v in before.items():  # put back after the test
        monkeypatch.setattr(wrapper, k, v)
    fused_convnext.count_launch(wrapper, *counters)  # no CUDA context: not capturing
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    fused_convnext.count_launch(wrapper, *counters)
    fused_convnext.count_launch(wrapper, *counters)
    for c in counters:
        assert getattr(wrapper, c) == before[c] + 1
        assert getattr(wrapper, "captured_" + c) == before["captured_" + c] + 2
