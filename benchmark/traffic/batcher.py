"""The serving batcher under open-loop load: `cli/serve.py::Batcher` in the
harness's process, fed already-tokenised requests at Poisson arrivals, each
timed from its scheduled send to the moment the batcher sets its event.
`served_audio_s_per_s` is the audio of the requests answered inside the
window over its length; `latency_p95_ms` (the knee tool's) the tail over
every request due in it.

Workload parameters (`workloads/<cell>.json`, "params"):
- max_batch, wait_ms, max_pending: the Batcher's (the others its defaults).
- rate: requests per second offered, fixed (above the knee measured once:
  the backlog grows through the window and the batcher runs at capacity).
- sentences_p: probabilities of 1, 2, ... sentences a request.
- tokens: lognormal per sentence, `median`, `sigma`, clipped to `clip`.
- id_range: token ids [lo, hi).
- classes: factor classes {name: {p, d, p_factor, e_factor}}: d scales the
  base duration factor.
- mulaw_share: requests that ask for the µ-law wire (a batch uses it when
  all its requests do; otherwise it ships pcm16).
- frames_per_token, frame_margin: the base duration factor is drawn from the
  seed's model (the plain reference's durations over a sample of the
  sentences) so that sentences average `frames_per_token` frames a token,
  lowered so that no sentence of the slowest class comes within
  `frame_margin` frames of the model's `max_mel_len`.
- sizes_seed: the request sizes, classes, wires and arrival gaps are drawn
  from it once, the same for every run; `--seed` shuffles their order and
  draws the token ids and the weights.

A request refused (429) or failed counts as missing: its latency is
infinite. `latency_p95_ms` is the nearest-rank 95th percentile over every
request due in the window; after the window the harness waits up to a
minute for the last answers.
"""

import math
import threading
import time

import numpy as np

from harness.common import text_width
from harness.compare import MISSING, Rows, checks, compare
from harness.synthesis import build_models, pick_d_factor, raw_durations

DRAIN_S = 60.0


class StampedEvent(threading.Event):
    """A threading.Event that stamps time.perf_counter() when it is set."""

    stamp = None

    def set(self):
        self.stamp = time.perf_counter()
        super().set()


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.workload["params"]

    # -- traffic --------------------------------------------------------
    def requests(self, seconds, rate):
        """The requests due in a window of `seconds` at `rate`: a list of
        (due offset s, [sentence token counts], class, wants µ-law)."""
        p = self.p
        n = max(1, int(round(seconds * rate * 1.5)))
        r = np.random.default_rng(p["sizes_seed"])
        due = np.cumsum(r.exponential(1.0 / rate, n))
        n = int((due < seconds).sum())
        n_sent = r.choice(np.arange(1, len(p["sentences_p"]) + 1), n, p=p["sentences_p"])
        names = list(p["classes"])
        cls = r.choice(len(names), n, p=[p["classes"][k]["p"] for k in names])
        mulaw = r.random(n) < p["mulaw_share"]
        tok = np.exp(np.log(p["tokens"]["median"]) + p["tokens"]["sigma"] * r.standard_normal(
            int(n_sent.sum())))
        tok = np.clip(np.round(tok), *p["tokens"]["clip"]).astype(np.int64)
        sent = np.split(tok, np.cumsum(n_sent)[:-1])
        # the seed reorders the requests; the arrival times stay as drawn
        order = np.random.default_rng(self.ctx.seed % 2 ** 63).permutation(n)
        return [(float(due[k]), sent[j], names[cls[j]], bool(mulaw[j]))
                for k, j in enumerate(order)]

    # -- set-up ---------------------------------------------------------
    def setup(self):
        from optispeech_tpu_torch.cli.serve import Batcher

        p, ctx = self.p, self.ctx
        self.ref, self.model = build_models(ctx)
        self.hop = self.model.hop_length
        self._prepare(ctx.seconds, p["rate"])
        # the base duration factor, from the window's own sentences
        lens = np.concatenate([s for _, s, _, _ in self.reqs])
        ids = np.zeros((len(lens), text_width(int(lens.max()), self.model.text_bucket)), np.int64)
        for i, x in enumerate(x for row in self.req_ids for x in row):
            ids[i, :len(x)] = x
        raw = raw_durations(self.ref, ids, lens, ctx.device)
        slowest = max(c["d"] for c in p["classes"].values())
        cap = self.model.cfg.data.max_mel_len
        base, d_mean = pick_d_factor(raw, lens, p["frames_per_token"], cap - p["frame_margin"])
        base_slow, _ = pick_d_factor(raw * slowest, lens, 1e9, cap - p["frame_margin"])
        self.d_base = min(base, base_slow)
        ctx.log(f"base duration factor {self.d_base:.6f} ({d_mean:.6f} at the mean): "
                f"{np.ceil(raw * self.d_base).sum() / lens.sum():.4f} frames a token; "
                f"longest sentence at the slowest class "
                f"{int(np.ceil(raw * self.d_base * slowest).sum(1).max())} frames of {cap} "
                f"({int(np.ceil(raw * d_mean * slowest).sum(1).max())} at the mean)")
        self.batcher = Batcher(self.model, max_batch=p["max_batch"], wait_ms=p["wait_ms"],
                               max_pending=p["max_pending"])
        self._warm(cap)
        self._wrap()

    def _prepare(self, seconds, rate):
        """The requests of a window and their token ids, drawn before it."""
        self.prepared = (seconds, rate)
        self.reqs = self.requests(seconds, rate)
        rng = np.random.default_rng((self.ctx.seed + 2) % 2 ** 63)
        lo, hi = self.p["id_range"]
        self.req_ids = [[rng.integers(lo, hi, int(n)) for n in sent] for _, sent, _, _ in self.reqs]

    def _warm(self, cap):
        """Every shape the batcher can send: batch rungs up to max_batch x
        text widths up to the clip's x frame rungs up to the cap, in pcm16,
        and the µ-law wire at each batch and frame rung."""
        from optispeech_tpu_torch.values import InferenceInputs

        m = self.model
        widths = range(m.text_bucket, text_width(self.p["tokens"]["clip"][1], m.text_bucket) + 1,
                       m.text_bucket)
        rungs, f = [], m.mel_bucket
        while f < cap:
            rungs.append(f)
            f *= 2
        rungs.append(cap)
        b = 1
        while b <= self.p["max_batch"]:
            for w in widths:
                x = np.ones((b, w), np.int64)
                inputs = InferenceInputs(x=x, x_lengths=np.full(b, w), clean_text="warm",
                                         d_factor=self.d_base, p_factor=1.0, e_factor=1.0)
                for n in rungs:
                    for mulaw in ((False, True) if w == widths[-1] else (False,)):
                        out = m.synthesise_on_device(inputs, n, pcm16=not mulaw, mulaw=mulaw)
                        out["wav_lengths"].cpu()
            b *= 2

    def _wrap(self):
        """Record, for every batch, the rows the program produced: wrappers
        around the batcher's merge and synthesis calls keep the group and a
        device copy of the call's token-rate outputs (no host sync), from
        which the check takes its sample once the window has closed."""
        self.flagged, self.records = {}, {}
        merge, synth = self.batcher._merge, self.model.synthesise_on_device

        def merged(group):
            out = merge(group)
            self.flagged[id(out[0])] = (out[0], list(group))
            return out

        def synthesised(inputs, n_frames, pcm16=False, mulaw=False):
            out = synth(inputs, n_frames, pcm16=pcm16, mulaw=mulaw)
            if id(inputs) in self.records:  # the frame cap doubled: a retry
                self.retries += 1
            self.rungs[n_frames] = self.rungs.get(n_frames, 0) + 1
            if id(inputs) in self.flagged:
                self.records[id(inputs)] = {
                    "n_frames": n_frames, **{k: out[k].clone() for k in
                                             ("durations", "pitch", "energy")}}
            return out

        self.batcher._merge = merged
        self.model.synthesise_on_device = synthesised

    # -- the window -----------------------------------------------------
    def window(self, seconds, rate=None):
        from optispeech_tpu_torch.cli.serve import _Pending
        from optispeech_tpu_torch.values import InferenceInputs

        p = self.p
        if self.prepared != (seconds, rate or p["rate"]):
            self._prepare(seconds, rate or p["rate"])
        reqs = self.reqs
        pend = []
        for (_, sent, cls, mulaw), rows in zip(reqs, self.req_ids):
            c = p["classes"][cls]
            ids = np.zeros((len(sent), int(sent.max())), np.int64)
            for j, x in enumerate(rows):
                ids[j, :len(x)] = x
            q = _Pending(InferenceInputs(x=ids, x_lengths=sent, clean_text="request",
                                         d_factor=self.d_base * c["d"],
                                         p_factor=c["p_factor"], e_factor=c["e_factor"]),
                         wants_mulaw=mulaw)
            q.event = StampedEvent()
            pend.append(q)
        self.flagged, self.records, self.retries, self.rungs = {}, {}, 0, {}
        b = self.batcher
        before = (b.batches_run, b.rows_synthesised, dict(b.stage_seconds))

        accepted = [False] * len(pend)
        lag = 0.0
        t0 = time.perf_counter()
        for i, (due, _, _, _) in enumerate(reqs):
            wait = t0 + due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            lag = max(lag, time.perf_counter() - (t0 + due))
            accepted[i] = b.submit(pend[i])
        closed = time.perf_counter()
        self.counters = {"batches": b.batches_run - before[0], "rows": b.rows_synthesised - before[1],
                         "synthesise_s": b.stage_seconds["synthesise"] - before[2]["synthesise"],
                         "retries": self.retries, "frame_rungs": dict(self.rungs)}
        deadline = closed + DRAIN_S
        for q, ok in zip(pend, accepted):
            if ok:
                q.event.wait(max(0.0, deadline - time.perf_counter()))
        lat = []
        for (due, _, _, _), q, ok in zip(reqs, pend, accepted):
            good = ok and q.event.stamp is not None and q.error is None
            lat.append((q.event.stamp - (t0 + due)) * 1e3 if good else math.inf)
        self.pend, self.accepted = pend, accepted
        # the check's sample, drawn from the seed among the finished
        # requests, with the longest of them
        done = [i for i, x in enumerate(lat) if math.isfinite(x)]
        pick = np.random.default_rng((self.ctx.seed + 1) % 2 ** 63)
        k = min(self.ctx.workload["check"]["requests"], len(done))
        chosen = set(pick.choice(done, k, replace=False).tolist()) if done else set()
        if done:
            chosen.add(max(done, key=lambda i: int(reqs[i][1].sum())))
        self.check_set = [pend[i] for i in sorted(chosen)]
        end = t0 + seconds
        served = sum(len(q.pcm16 if q.pcm16 is not None else q.mulaw) for q, x in zip(pend, lat)
                     if math.isfinite(x) and q.event.stamp <= end)
        srt = sorted(lat)
        p95 = srt[max(0, math.ceil(0.95 * len(srt)) - 1)]
        self.ctx.log(f"{len(reqs)} requests, {sum(accepted)} accepted, "
                     f"{sum(math.isfinite(x) for x in lat)} answered; generator lag max "
                     f"{lag * 1e3:.2f} ms; p50 {srt[len(srt) // 2]:.2f} ms; "
                     f"window counters {self.counters}")
        return {"served_audio_s_per_s": served / self.model.sample_rate / seconds,
                "latency_p95_ms": p95 if math.isfinite(p95) else MISSING,
                "window_s": closed - t0, "requests": len(reqs),
                "completed_share": sum(math.isfinite(x) for x in lat) / max(len(lat), 1),
                "rejected": len(reqs) - sum(accepted)}

    def counts(self):
        missing = sum(1 for q, ok in zip(self.pend, self.accepted)
                      if not ok or q.event.stamp is None or q.error is not None)
        return len(self.pend), missing

    # -- the traced run -------------------------------------------------
    def traced(self, seconds):
        from harness.trace import Spans, profile_window

        spans = Spans()
        spans.around_method(self.model, "synthesise_on_device", "synthesise")
        try:
            data = profile_window(lambda: self.window(seconds))
        finally:
            spans.remove()
        data.counters = self.counters
        return data

    # -- after the window -----------------------------------------------
    def free(self):
        """Drop what the harness holds of the program. The batcher's thread,
        idle on its queue, keeps the model until the process ends."""
        del self.batcher, self.model

    def check(self):
        if not self.check_set:
            return {"missing_answers": 1}, checks({"missing_answers": 1},
                                                  self.ctx.workload["check"]["limits"])
        by_request = {}
        for key, (merged, group) in self.flagged.items():
            if key not in self.records:
                continue
            row = 0
            for q in group:
                by_request[id(q)] = (merged, self.records[key], row)
                row += q.inputs.x.shape[0]
        batches, missing = [], 0
        for q in self.check_set:
            audio = q.mulaw if q.mulaw is not None else q.pcm16
            if id(q) not in by_request or audio is None:
                missing += 1
                continue
            merged, rec, row = by_request[id(q)]
            n = q.inputs.x.shape[0]
            durations = rec["durations"][row:row + n].cpu().numpy()
            lengths = np.minimum(durations.sum(1), rec["n_frames"]) * self.hop
            if int(lengths.sum()) != len(audio):
                missing += 1
                continue
            width = durations.shape[1]
            ids = np.zeros((n, width), np.int64)
            ids[:, :q.inputs.x.shape[1]] = q.inputs.x
            inp = q.inputs
            batches.append(Rows(
                ids=ids, lengths=np.asarray(inp.x_lengths), n_frames=rec["n_frames"],
                factors=(float(inp.d_factor), float(inp.p_factor), float(inp.e_factor)),
                durations=durations, pitch=rec["pitch"][row:row + n].float().cpu().numpy(),
                energy=rec["energy"][row:row + n].float().cpu().numpy(),
                audio=np.split(audio, np.cumsum(lengths)[:-1]),
                wire="mulaw" if q.mulaw is not None else "pcm16"))
        numbers = compare(self.ref, batches, self.ctx.device)
        numbers["missing_answers"] = missing
        return numbers, checks(numbers, self.ctx.workload["check"]["limits"])
