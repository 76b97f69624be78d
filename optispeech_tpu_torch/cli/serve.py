"""HTTP serving runtime with request micro-batching.

Port of `optispeech_tpu/cli/serve.py`. Concurrent HTTP requests coalesce
into one call of `OptiSpeech.synthesise_on_device` (the batch padded up a
power-of-two ladder, the wire format computed on the device, an adaptive
frame cap), whose rows are split back per request.

Endpoints:
    GET  /health             -> {"status": "ok", ...counters} (below)
    GET  /info               -> model metadata (sample rate, speakers, ...)
    POST /synthesise         JSON body (also /synthesize):
        {"text": "...", "speaker": null, "language": null,
         "d_factor": null, "p_factor": null, "e_factor": null,
         "format": "wav" | "pcm16" | "mulaw" | "json"}
      -> audio/wav bytes (WAV), raw int16 PCM (+ X-Sample-Rate header), raw
         8-bit µ-law codes (X-Encoding: mulaw; decode with
         ops.mulaw.mulaw_decode; encoded on the device when the whole batch
         asked for µ-law), or JSON {"sample_rate", "pcm16_b64",
         "latency_ms", "truncated"}. X-Truncated: 1 when the frame cap cut
         the audio.
    POST /stream             the same body, "format" "pcm16" (default) or
      "mulaw" -> chunked-transfer raw audio, one HTTP chunk per decoded
      window (models/streaming.py): the audio starts after one window, not
      after the whole utterance.
Status codes: 400 (bad body or prompt), 404 (unknown path), 429 with
Retry-After (queue full), 500 (synthesis failed), 503 (timed out).

Batching contract: the d/p/e factors are whole-batch scalars, so only
requests with equal (d, p, e) coalesce; speaker and language ids are per
row and batch freely. One batcher thread makes every batched device call;
/stream handlers run their windows on their own threads.

/health, the operator's view of the batcher: `requests_served`,
`batches_run`, `rows_synthesised` (real sentence rows, the ladder's padding
left out), `requests_rejected` (429s: the queue was full), `deferrals`
(requests that waited a batch because their (d, p, e) differed from the
batch's), `frame_cap_retries` (batches run again at a doubled frame cap:
the frames/token estimate was short), `truncated_rows` (rows cut at the
largest cap, answered with X-Truncated) and `stage_seconds`, the batcher
thread's wall summed by stage: `merge`, `synthesise` (the device call
through the host's read of the lengths; retries included), `fetch` (the
audio's copy to the host) and `split` (rows joined per request).
With tracing on (`utils/tracing.py`) each request leaves a `serve/queue`
span (submit to drained into a batch, its id and the batches it was passed
over) and each batch `serve/merge`, `serve/synthesise`, `serve/fetch` and
`serve/split` spans with the batch's id and its requests' ids.

The model is a live checkpoint (`config.json` + `generator.pt`) or an
exported artifact (`metadata.json`, `export/exporter.py`): the artifact's
batches replay its graphs up its batch ladder (`ExportedOptiSpeech.
synthesise`, the wire transcoded on the host), its /stream replays its
stream graphs, and an artifact exported without them answers /stream with
501.

Usage:
    python -m optispeech_tpu_torch.cli.serve MODEL_DIR [--host 0.0.0.0 --port 8000]
        [--max-batch 32 --batch-wait-ms 20] [--bf16] [--device cpu]

`--device` defaults to the CUDA card and raises without one.
"""

import argparse
import base64
import io
import itertools
import json
import os
import queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..utils import tracing
from ..utils.pylogger import get_pylogger

log = get_pylogger(__name__)


def load_model(path: str, bf16: bool = False, fused: bool = True, device=None):
    """A live inference checkpoint on `device` (default: the card; raises
    when there is none), with the decoder and the vocoder trunk on the fused
    block by default, computing in bfloat16 with `bf16`; or an exported
    artifact (`metadata.json`) replayed on `device`, whose graphs are what
    was exported: `bf16` and `fused` are ignored there, as in JAX."""
    if os.path.exists(os.path.join(path, "metadata.json")):
        from ..export.exporter import ExportedOptiSpeech

        return ExportedOptiSpeech(path, device=device)
    import torch

    from ..models.optispeech import OptiSpeech

    return OptiSpeech.load_from_checkpoint(
        path, device=device, fused=fused,
        compute_dtype=torch.bfloat16 if bf16 else torch.float32)


class _Pending:
    __slots__ = ("inputs", "event", "pcm16", "mulaw", "wants_mulaw",
                 "sample_rate", "latency_ms", "error", "truncated", "id", "submitted_ns",
                 "passed_over")

    def __init__(self, inputs, wants_mulaw: bool = False):
        self.id = 0  # given at submit
        self.submitted_ns = 0  # time.perf_counter_ns() at submit
        self.passed_over = 0  # drains that left it deferred
        self.inputs = inputs  # InferenceInputs (rows = sentences)
        self.event = threading.Event()
        self.pcm16 = None  # little-endian int16 waveform
        self.mulaw = None  # uint8 µ-law codes (when the batch used the 8-bit wire)
        self.wants_mulaw = wants_mulaw
        self.sample_rate = None
        self.latency_ms = None
        self.error = None
        self.truncated = False  # frame cap saturated: audio may be incomplete


class Batcher:
    """Coalesces pending requests into batched `synthesise_on_device`
    calls, on a thread of its own. Requests sharing (d, p, e) merge into
    one batch of up to `max_batch` sentence rows; a new arrival waits at
    most `wait_ms` for co-batchees once the batcher is idle.

    `stage_seconds` sums the thread's wall per stage over the batches run:
    `merge`, `synthesise` (`synthesise_on_device` through the host's read
    of the lengths, which waits for the device; retries included), `fetch`
    (the audio's copy to the host) and `split` (the rows joined per
    request), each from the two clock reads of its `serve/<stage>` span.
    `deferrals`, `frame_cap_retries` and `truncated_rows` count what the
    module docstring says /health reports."""

    def __init__(self, model, max_batch: int = 32, wait_ms: float = 20.0,
                 frames_per_token: int = 8, max_pending: int = 256):
        self.model = model
        self.max_batch = max_batch
        self.wait_ms = wait_ms
        self.frames_per_token = frames_per_token
        # adaptive frame cap: start at frames_per_token, then track the
        # observed frames/token ratio with 25% headroom; an underestimate
        # retries with a doubled cap. A bounded window, not a running max,
        # so that one long outlier ages out
        self._fpt_window: deque = deque(maxlen=64)
        # backpressure: bound queued + deferred work; overflow -> 429
        self.max_pending = max_pending
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self.requests_rejected = 0
        self.q: "queue.Queue[_Pending]" = queue.Queue()
        self._deferred: list = []  # factor-incompatible requests, oldest first
        self.requests_served = 0
        self.batches_run = 0
        self.rows_synthesised = 0
        self.deferrals = 0
        self.frame_cap_retries = 0
        self.truncated_rows = 0
        self.stage_seconds = {"merge": 0.0, "synthesise": 0.0, "fetch": 0.0, "split": 0.0}
        self._request_ids = itertools.count(1)
        self._batch_ids = itertools.count(1)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, pending: _Pending) -> bool:
        """False = at capacity (the caller answers 429)."""
        with self._inflight_lock:
            if self._inflight >= self.max_pending:
                self.requests_rejected += 1
                return False
            self._inflight += 1
            pending.id = next(self._request_ids)
        pending.submitted_ns = time.perf_counter_ns()
        self.q.put(pending)
        return True

    # -- internals ------------------------------------------------------
    @staticmethod
    def _factor_key(inp):
        return (round(float(inp.d_factor), 4), round(float(inp.p_factor), 4),
                round(float(inp.e_factor), 4))

    def _drain_compatible(self, first: _Pending):
        """Collect requests with `first`'s factor key up to max_batch rows.
        Incompatible arrivals go to `_deferred`, which the loop serves first
        on its next cycle: a minority-factor request waits at most one
        batch, never starved by a majority-key stream."""
        group = [first]
        rows = first.inputs.x.shape[0]
        key = self._factor_key(first.inputs)
        still_deferred = []
        for d in self._deferred:
            n = d.inputs.x.shape[0]
            if self._factor_key(d.inputs) == key and rows + n <= self.max_batch:
                group.append(d)
                rows += n
            else:
                d.passed_over += 1
                still_deferred.append(d)
        self._deferred = still_deferred
        deadline = time.perf_counter() + self.wait_ms / 1e3
        while rows < self.max_batch:
            timeout = deadline - time.perf_counter()
            if timeout <= 0:
                break
            try:
                nxt = self.q.get(timeout=timeout)
            except queue.Empty:
                break
            n = nxt.inputs.x.shape[0]
            same_key = self._factor_key(nxt.inputs) == key
            if same_key and rows + n <= self.max_batch:
                group.append(nxt)
                rows += n
            else:
                self.deferrals += not same_key
                nxt.passed_over += 1
                self._deferred.append(nxt)
        return group

    def _merge(self, group):
        """Concatenate the requests' sentence rows into one InferenceInputs,
        padded up the batch ladder (powers of two, so that the card sees a
        few batch shapes). Pad rows repeat row 0 and are dropped after
        synthesis."""
        from ..values import InferenceInputs

        t = max(p.inputs.x.shape[1] for p in group)
        x = np.concatenate([
            np.pad(p.inputs.x, ((0, 0), (0, t - p.inputs.x.shape[1])))
            for p in group
        ])
        x_lengths = np.concatenate([p.inputs.x_lengths for p in group])
        has_sids = group[0].inputs.sids is not None
        has_lids = group[0].inputs.lids is not None
        sids = np.concatenate(
            [np.asarray(p.inputs.sids) for p in group]) if has_sids else None
        lids = np.concatenate(
            [np.asarray(p.inputs.lids) for p in group]) if has_lids else None

        n_real = x.shape[0]
        target = 1
        while target < n_real:
            target *= 2
        if target > n_real:
            reps = np.zeros(target - n_real, np.int64)  # repeat row 0
            x = np.concatenate([x, x[reps]])
            x_lengths = np.concatenate([x_lengths, x_lengths[reps]])
            if sids is not None:
                sids = np.concatenate([sids, sids[reps]])
            if lids is not None:
                lids = np.concatenate([lids, lids[reps]])

        f = group[0].inputs
        return InferenceInputs(
            x=x, x_lengths=x_lengths, sids=sids, lids=lids,
            d_factor=f.d_factor, p_factor=f.p_factor, e_factor=f.e_factor,
            clean_text=" | ".join(str(p.inputs.clean_text) for p in group),
        ), n_real

    def _synthesise_batch(self, merged, wire: str = "pcm16", **ids):
        """Returns (audio rows in `wire` format, per-row sample lengths,
        truncated mask, latency_ms). `wire` is "pcm16" (int16) or "mulaw"
        (uint8, a quarter of the float32 bytes); `ids` (the batch's id and
        its requests') go into the stage spans.

        A live model: one `synthesise_on_device` call, with the wire
        computed on the device. The frame cap is the observed frames/token
        (per unit d_factor) times the longest row, on a power-of-two ladder
        of mel buckets; if a row fills the cap, the cap doubles and the
        batch runs again, up to `data.max_mel_len`. An exported artifact:
        its generic `synthesise`, the wire transcoded on the host."""
        if not hasattr(self.model, "synthesise_on_device"):
            return self._synthesise_generic(merged, wire, **ids)
        from ..utils.bucketing import round_up_pow2_bucket

        hop = self.model.hop_length
        with tracing.timed(self.stage_seconds, "synthesise", "serve/synthesise", **ids) as synth:
            bucket = self.model.mel_bucket
            cap = getattr(getattr(self.model, "cfg", None), "data", None)
            cap = getattr(cap, "max_mel_len", None) or 4096
            t = int(np.asarray(merged.x_lengths).max())
            # the estimate may exceed the initial frames_per_token guess; it is
            # kept per unit d_factor, so a d=2.0 batch does not inflate the
            # default-rate batches after it
            d = float(merged.d_factor) or 1.0
            fpt = self.frames_per_token if not self._fpt_window \
                else max(self._fpt_window) * 1.25 * d
            n_frames = round_up_pow2_bucket(int(t * fpt), bucket, cap)
            while True:
                out = self.model.synthesise_on_device(
                    merged, n_frames, pcm16=(wire == "pcm16"), mulaw=(wire == "mulaw"))
                wav_lengths = out["wav_lengths"].cpu().numpy()
                if (wav_lengths < n_frames * hop).all() or n_frames >= cap:
                    break
                n_frames = min(n_frames * 2, cap)
                self.frame_cap_retries += 1
        # rows that still fill the cap are truncated: say so, rather than
        # ship a cut wav silently
        truncated = wav_lengths >= n_frames * hop
        if truncated.any():
            log.warning(f"frame cap saturated at {n_frames} frames (cap {cap}): "
                        f"{int(truncated.sum())}/{len(truncated)} rows truncated")
        lens = np.asarray(merged.x_lengths, dtype=float)
        ratio = float((wav_lengths / hop / np.maximum(lens, 1)).max()) / d
        self._fpt_window.append(ratio)
        wav_lengths = wav_lengths.astype(int)
        with tracing.timed(self.stage_seconds, "fetch", "serve/fetch", **ids) as fetch:
            if wire == "mulaw":
                # packed fetch: only the valid samples cross to the host
                flat = self.model.fetch_packed(out["wav_mulaw_packed"], int(wav_lengths.sum()))
                offs = np.concatenate([[0], np.cumsum(wav_lengths)[:-1]])
                rows = [flat[offs[j]: offs[j] + wav_lengths[j]] for j in range(len(wav_lengths))]
            else:
                audio = out["wav_pcm16"].cpu().numpy()
                rows = [audio[j, : wav_lengths[j]] for j in range(len(wav_lengths))]
        return rows, wav_lengths, truncated, (synth.seconds + fetch.seconds) * 1e3

    def _synthesise_generic(self, merged, wire: str, **ids):
        """`synthesise` (an artifact's, up its batch ladder), its float32
        audio transcoded on the host; nothing is truncated. Its wall counts
        as `synthesise` (the audio's fetch included)."""
        with tracing.timed(self.stage_seconds, "synthesise", "serve/synthesise", **ids) as synth:
            out = self.model.synthesise(merged)
            wav_lengths = np.asarray(out.wav_lengths).astype(int)
            if wire == "mulaw":
                from ..ops.mulaw import mulaw_encode_np

                audio = mulaw_encode_np(np.asarray(out.wav))
            else:
                audio = (np.clip(np.asarray(out.wav), -1, 1) * 32767.0).astype("<i2")
            rows = [audio[j, : wav_lengths[j]] for j in range(len(wav_lengths))]
        return rows, wav_lengths, np.zeros(len(wav_lengths), bool), synth.seconds * 1e3

    def _loop(self):
        while True:
            first = self._deferred.pop(0) if self._deferred else self.q.get()
            group = self._drain_compatible(first)
            drained_ns = time.perf_counter_ns()
            for p in group:
                tracing.record("serve/queue", p.submitted_ns, drained_ns, request=p.id,
                               passed_over=p.passed_over)
            ids = {"batch": next(self._batch_ids), "requests": [p.id for p in group]}
            try:
                with tracing.timed(self.stage_seconds, "merge", "serve/merge", **ids):
                    merged, n_real = self._merge(group)
                # the 8-bit wire only when every request of the batch asked
                # for it (a mixed batch fetches pcm16 and the handler
                # transcodes for the µ-law requests)
                wire = "mulaw" if all(p.wants_mulaw for p in group) else "pcm16"
                rows, wav_lengths, truncated, latency_ms = self._synthesise_batch(
                    merged, wire=wire, **ids)
                with tracing.timed(self.stage_seconds, "split", "serve/split", **ids):
                    i = 0
                    for p in group:
                        n = p.inputs.x.shape[0]
                        joined = np.concatenate(rows[i: i + n])
                        if wire == "mulaw":
                            p.mulaw = joined
                        else:
                            p.pcm16 = joined
                        p.sample_rate = self.model.sample_rate
                        p.latency_ms = latency_ms
                        p.truncated = bool(truncated[i: i + n].any())
                        i += n
                self.batches_run += 1
                self.rows_synthesised += n_real
                self.truncated_rows += int(truncated[:n_real].sum())
                self.requests_served += len(group)
            except Exception as e:  # answer each request of the batch, keep serving
                log.exception("batch failed")
                for p in group:
                    p.error = str(e)
            finally:
                with self._inflight_lock:
                    self._inflight -= len(group)
                for p in group:
                    p.event.set()


def _wav_bytes(pcm16: np.ndarray, sr: int) -> bytes:
    from scipy.io import wavfile

    buf = io.BytesIO()
    wavfile.write(buf, sr, np.ascontiguousarray(pcm16, np.int16))
    return buf.getvalue()


def make_handler(model, batcher: Batcher, timeout_s: float = 300.0,
                 stream_chunk_frames: int = 256, stream_overlap: int | None = None):
    streamer_box: list = []  # the streamer, built at the first /stream
    streamer_lock = threading.Lock()

    def get_streamer():
        """The live model's StreamingSynthesiser, an artifact's
        ExportedStreamingSynthesiser (its windows are the exported ones),
        or None for an artifact without stream graphs."""
        with streamer_lock:
            if not streamer_box:
                if hasattr(model, "generator"):
                    from ..models.streaming import DEFAULT_OVERLAP, StreamingSynthesiser

                    streamer_box.append(StreamingSynthesiser(
                        model, chunk_frames=stream_chunk_frames,
                        overlap=DEFAULT_OVERLAP if stream_overlap is None else stream_overlap,
                    ))
                elif getattr(model, "stream_meta", None):
                    from ..export.exporter import ExportedStreamingSynthesiser

                    streamer_box.append(ExportedStreamingSynthesiser(model))
                else:
                    return None
        return streamer_box[0]

    return _make_handler_cls(model, batcher, timeout_s, get_streamer)


def _make_handler_cls(model, batcher, timeout_s, get_streamer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # through the package's logger
            log.debug("%s " + fmt, self.address_string(), *args)

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {
                    "status": "ok",
                    "requests_served": batcher.requests_served,
                    "batches_run": batcher.batches_run,
                    "rows_synthesised": batcher.rows_synthesised,
                    "requests_rejected": batcher.requests_rejected,
                    "deferrals": batcher.deferrals,
                    "frame_cap_retries": batcher.frame_cap_retries,
                    "truncated_rows": batcher.truncated_rows,
                    "stage_seconds": dict(batcher.stage_seconds),
                })
            elif self.path == "/info":
                self._json(200, {
                    "sample_rate": model.sample_rate,
                    "speakers": getattr(model, "speakers", None) or [],
                    "num_speakers": getattr(model, "num_speakers", 1),
                    "languages": list(getattr(model.text_processor, "languages", [])),
                    "max_batch": batcher.max_batch,
                    "batch_wait_ms": batcher.wait_ms,
                })
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path not in ("/synthesise", "/synthesize", "/stream"):
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            if self.path == "/stream" and get_streamer() is None:
                self._json(501, {"error": "this artifact has no stream graphs; "
                                          "re-export with stream_chunk_frames set"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                text = req.get("text", "").strip()
                if not text:
                    self._json(400, {"error": "missing `text`"})
                    return
                inputs = model.prepare_input(
                    text,
                    **({"speaker": req.get("speaker")}
                       if getattr(model, "num_speakers", 1) > 1 else {}),
                    **_lang_kw(model, req.get("language")),
                    d_factor=req.get("d_factor"),
                    p_factor=req.get("p_factor"),
                    e_factor=req.get("e_factor"),
                    split_sentences=True,
                )
            except (ValueError, json.JSONDecodeError) as e:
                self._json(400, {"error": str(e)})
                return
            except Exception as e:  # e.g. a tokenizer backend missing
                log.exception("prepare_input failed")
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return

            if self.path == "/stream":
                self._stream(inputs.as_numpy(), fmt=req.get("format", "pcm16"))
                return

            fmt = req.get("format", "wav")
            pending = _Pending(inputs.as_numpy(), wants_mulaw=fmt == "mulaw")
            if not batcher.submit(pending):
                self.send_response(429)
                body = json.dumps({"error": "server at capacity; retry later"}).encode()
                self.send_header("Content-Type", "application/json")
                self.send_header("Retry-After", "1")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if not pending.event.wait(timeout_s):
                self._json(503, {"error": "synthesis timed out"})
                return
            if pending.error is not None:
                self._json(500, {"error": pending.error})
                return
            self._respond_audio(fmt, pending)

        def _stream(self, inputs, fmt: str = "pcm16"):
            """Chunked-transfer raw audio, one HTTP chunk per decoded window.
            `fmt` "pcm16" (default) or "mulaw" (8-bit, encoded on the device,
            `models/streaming.py`'s `wire`). Each sentence row streams in
            turn, on this handler's thread, beside the batcher's calls."""
            from ..values import InferenceInputs

            streamer = get_streamer()
            mulaw = fmt == "mulaw"
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("X-Sample-Rate", str(model.sample_rate))
            if mulaw:
                self.send_header("X-Encoding", "mulaw")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def emit(b: bytes):
                self.wfile.write(f"{len(b):x}\r\n".encode() + b + b"\r\n")

            try:
                for i in range(inputs.x.shape[0]):
                    row = InferenceInputs(
                        x=inputs.x[i: i + 1],
                        x_lengths=inputs.x_lengths[i: i + 1],
                        sids=None if inputs.sids is None else inputs.sids[i: i + 1],
                        lids=None if inputs.lids is None else inputs.lids[i: i + 1],
                        d_factor=inputs.d_factor, p_factor=inputs.p_factor,
                        e_factor=inputs.e_factor, clean_text=inputs.clean_text,
                    )
                    kw = {"wire": "mulaw"} if mulaw else {}
                    for chunk in streamer.stream(row, **kw):
                        if not len(chunk):
                            continue
                        if mulaw:
                            emit(chunk.tobytes())
                        else:
                            emit((np.clip(chunk, -1, 1) * 32767.0).astype("<i2").tobytes())
                self.wfile.write(b"0\r\n\r\n")
            except Exception:
                log.exception("stream failed")
                self.close_connection = True

        def _respond_audio(self, fmt, pending):
            if fmt == "mulaw":
                # raw 8-bit µ-law codes; decode with ops.mulaw.mulaw_decode
                if pending.mulaw is not None:
                    body = pending.mulaw.tobytes()
                else:  # a mixed batch fetched pcm16: transcode on the host
                    from ..ops.mulaw import mulaw_encode_np

                    body = mulaw_encode_np(
                        pending.pcm16.astype(np.float32) / 32767.0).tobytes()
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("X-Sample-Rate", str(pending.sample_rate))
                self.send_header("X-Encoding", "mulaw")
                if pending.truncated:
                    self.send_header("X-Truncated", "1")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if pending.pcm16 is None and pending.mulaw is not None:
                # a non-mulaw format on a µ-law batch
                from ..ops.mulaw import mulaw_decode

                pending.pcm16 = np.round(
                    mulaw_decode(pending.mulaw) * 32767.0).astype("<i2")
            pcm = pending.pcm16.astype("<i2", copy=False)
            if fmt == "json":
                self._json(200, {
                    "sample_rate": pending.sample_rate,
                    "pcm16_b64": base64.b64encode(pcm.tobytes()).decode(),
                    "latency_ms": pending.latency_ms,
                    "truncated": pending.truncated,
                })
            elif fmt == "pcm16":
                body = pcm.tobytes()
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("X-Sample-Rate", str(pending.sample_rate))
                if pending.truncated:
                    self.send_header("X-Truncated", "1")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                body = _wav_bytes(pcm, pending.sample_rate)
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                if pending.truncated:
                    self.send_header("X-Truncated", "1")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

    return Handler


def _lang_kw(model, language):
    """The request's language as `prepare_input`'s keyword, when it names
    one: `language=` for OptiSpeech, `lang=` for ExportedOptiSpeech."""
    if language is None:
        return {}
    import inspect

    params = inspect.signature(model.prepare_input).parameters
    return {"language" if "language" in params else "lang": language}


def prewarm(model, max_batch: int = 32, frames_per_token: int = 8, stream: bool = True) -> dict:
    """Run every serving shape once before the server binds its port, so
    that the first requests do not pay the first calls' costs (cuDNN's
    plans, the kernels' build and load, the caching allocator's growth).

    - A live model: `synthesise_on_device` at every power-of-two batch rung
      up to `max_batch`, at the text bucket and the default frame rung, in
      both wire formats ({"b{rows}_{wire}": seconds}). Other frame rungs
      warm at their first use.
    - An exported artifact: `synthesise` at every (text bucket x batch
      rung), which replays its encode graph and a decode graph
      ({"encode_{tb}_b{rows}": seconds}), and, with `stream`, one stream
      over the stream graphs ({"stream": seconds})."""
    from ..utils.bucketing import round_up_pow2_bucket
    from ..values import InferenceInputs

    timings: dict = {}
    has_spk = getattr(model, "num_speakers", 1) > 1

    def dummy(rows: int, t: int) -> InferenceInputs:
        return InferenceInputs.from_ids_and_lengths(
            ids=[[1] * t] * rows, lengths=[t] * rows, clean_text="prewarm",
            sids=[0] * rows if has_spk else None,
            lids=None,
            d_factor=1.0, p_factor=1.0, e_factor=1.0,
        )

    if hasattr(model, "_rungs"):  # ExportedOptiSpeech
        for tb in model.text_buckets:
            for nb in model._rungs.get(tb, [1]):
                t0 = time.perf_counter()
                model.synthesise(dummy(nb, tb))
                timings[f"encode_{tb}_b{nb}"] = round(time.perf_counter() - t0, 3)
        if stream and getattr(model, "stream_meta", None):
            from ..export.exporter import ExportedStreamingSynthesiser

            t0 = time.perf_counter()
            for _ in ExportedStreamingSynthesiser(model).stream(dummy(1, model.text_buckets[0])):
                pass
            timings["stream"] = round(time.perf_counter() - t0, 3)
        log.info(f"prewarm: {len(timings)} graphs in {sum(timings.values()):.1f}s")
        return timings
    tb = model.text_bucket
    cap = getattr(getattr(model, "cfg", None), "data", None)
    cap = getattr(cap, "max_mel_len", None) or 4096
    n_frames = round_up_pow2_bucket(tb * frames_per_token, model.mel_bucket, cap)
    nb = 1
    while nb <= max_batch:
        for fmt in ("pcm16", "mulaw"):
            t0 = time.perf_counter()
            out = model.synthesise_on_device(
                dummy(nb, tb), n_frames, pcm16=fmt == "pcm16", mulaw=fmt == "mulaw")
            out["wav_lengths"].cpu()  # waits for the call's work on the stream
            timings[f"b{nb}_{fmt}"] = round(time.perf_counter() - t0, 3)
        nb *= 2
    total = sum(timings.values())
    log.info(f"prewarm: {len(timings)} shapes in {total:.1f}s")
    return timings


class _HTTPServer(ThreadingHTTPServer):
    # the listen backlog: the standard library's 5 resets connections when a
    # burst of clients connects at once, before the handler threads accept
    request_queue_size = 1024


def serve(model, host: str = "0.0.0.0", port: int = 8000,
          max_batch: int = 32, batch_wait_ms: float = 20.0,
          stream_chunk_frames: int = 256, stream_overlap: int | None = None,
          request_timeout_s: float = 300.0, max_pending: int = 256):
    batcher = Batcher(model, max_batch=max_batch, wait_ms=batch_wait_ms,
                      max_pending=max_pending)
    handler = make_handler(model, batcher, timeout_s=request_timeout_s,
                           stream_chunk_frames=stream_chunk_frames,
                           stream_overlap=stream_overlap)
    httpd = _HTTPServer((host, port), handler)
    httpd.batcher = batcher  # for tests and metrics
    return httpd


def main(argv=None):
    p = argparse.ArgumentParser(description="OptiSpeech batching HTTP server")
    p.add_argument("model", help="inference checkpoint directory or exported artifact directory")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=32,
                   help="max sentence rows per device batch")
    p.add_argument("--batch-wait-ms", type=float, default=20.0,
                   help="how long an idle batch waits for co-batchees")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 activations (the weights stay float32); a live checkpoint only")
    p.add_argument("--stream-chunk-frames", type=int, default=256,
                   help="frames per /stream window")
    p.add_argument("--request-timeout", type=float, default=300.0,
                   help="per-request wait on the batcher")
    p.add_argument("--max-pending", type=int, default=256,
                   help="queued-request bound; overflow answers 429")
    p.add_argument("--no-fused", action="store_true",
                   help="run the ConvNeXt blocks unfused (no fused kernel)")
    p.add_argument("--no-prewarm", action="store_true",
                   help="skip running every serving shape before binding the port "
                        "(the first requests then pay the first calls' costs)")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; `cpu` when asked)")
    args = p.parse_args(argv)

    model = load_model(args.model, bf16=args.bf16, fused=not args.no_fused,
                       device=args.device)
    if not args.no_prewarm:
        log.info("prewarming the serving shapes (skip with --no-prewarm)...")
        prewarm(model, max_batch=args.max_batch)
    httpd = serve(model, args.host, args.port, args.max_batch, args.batch_wait_ms,
                  stream_chunk_frames=args.stream_chunk_frames,
                  request_timeout_s=args.request_timeout,
                  max_pending=args.max_pending)
    log.info(f"Serving on http://{args.host}:{args.port} "
             f"(max_batch={args.max_batch}, wait={args.batch_wait_ms} ms)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        httpd.shutdown()
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
