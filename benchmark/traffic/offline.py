"""Offline long-form synthesis in batches: `OptiSpeech.synthesise_on_device`
called back to back on batches of long rows at a fixed frame cap, the pcm16
wire computed on the device and each call's audio copied to the host.

Workload parameters (`workloads/<cell>.json`, "params"):
- rows, tokens [lo, hi], id_range [lo, hi): each call's rows, their token
  counts and token ids. The multiset of token counts comes from
  `sizes_seed` and is the same for every run; `--seed` shuffles it and draws
  the ids and the weights.
- pool: distinct batches, made at set-up and cycled through the window.
- n_frames: the frame cap; a row whose durations fill it counts as failed.
- frames_per_token, frame_margin: the duration factor is drawn from the
  seed's model (the plain reference's durations over the pool) so that the
  rows average `frames_per_token` frames a token, lowered where needed so
  that no row comes within `frame_margin` frames of the cap.

Calls are dispatched one ahead: call i+1 is enqueued before call i's
lengths and audio are read. `audio_s_per_s` is the valid audio of every
call completed in the window over the window's wall seconds.
"""

import time

import numpy as np

from harness.common import text_width
from harness.compare import Rows, checks, compare
from harness.synthesis import (build_models, install_spans, pick_d_factor, raw_durations,
                               synthesis_flops)


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.workload["params"]

    # -- set-up ---------------------------------------------------------
    def setup(self):
        import torch

        from optispeech_tpu_torch.values import InferenceInputs

        p, ctx = self.p, self.ctx
        self.ref, self.model = build_models(ctx)
        self.hop = self.model.hop_length
        self.sample_rate = self.model.sample_rate
        n_rows = p["rows"] * p["pool"]
        sizes = np.random.default_rng(p["sizes_seed"]).integers(
            p["tokens"][0], p["tokens"][1] + 1, n_rows)
        rng = np.random.default_rng(ctx.seed % 2 ** 63)
        lengths = rng.permutation(sizes).astype(np.int64)
        width = text_width(int(lengths.max()), self.model.text_bucket)
        ids = rng.integers(p["id_range"][0], p["id_range"][1], (n_rows, width)).astype(np.int64)
        ids[np.arange(width)[None, :] >= lengths[:, None]] = 0
        raw = raw_durations(self.ref, ids, lengths, ctx.device)
        self.d_factor, d_mean = pick_d_factor(raw, lengths, p["frames_per_token"],
                                              p["n_frames"] - p["frame_margin"])
        rows_frames = np.ceil(raw * self.d_factor).sum(1).reshape(p["pool"], p["rows"])
        self.longest_batch = int(np.argmax(rows_frames.sum(1)))
        ctx.log(f"duration factor {self.d_factor:.6f} ({d_mean:.6f} at the mean): "
                f"{np.ceil(raw * self.d_factor).sum() / lengths.sum():.4f} frames a token, "
                f"longest row {int(np.ceil(raw * self.d_factor).sum(1).max())} frames "
                f"({int(np.ceil(raw * d_mean).sum(1).max())} at the mean)")
        self.pool = []
        for b in range(p["pool"]):
            sl = slice(b * p["rows"], (b + 1) * p["rows"])
            self.pool.append(InferenceInputs(
                x=ids[sl], x_lengths=lengths[sl], clean_text="offline",
                d_factor=self.d_factor, p_factor=1.0, e_factor=1.0))
        shape = (p["rows"], p["n_frames"] * self.hop)
        pin = ctx.device != "cpu"
        self.host_pcm = [torch.empty(shape, dtype=torch.int16, pin_memory=pin) for _ in range(2)]
        self.host_len = [torch.empty(p["rows"], dtype=torch.int64, pin_memory=pin)
                         for _ in range(2)]
        tok = (p["rows"], width)
        self.host_tok = [{"durations": torch.empty(tok, dtype=torch.int32, pin_memory=pin),
                          "pitch": torch.empty(tok, pin_memory=pin),
                          "energy": torch.empty(tok, pin_memory=pin)} for _ in range(2)]
        for b in range(min(3, len(self.pool))):  # every shape the window uses
            self._run(b, b % 2)[2].synchronize()

    def _run(self, i, slot):
        import torch

        out = self.model.synthesise_on_device(self.pool[i % len(self.pool)], self.p["n_frames"],
                                              pcm16=True)
        self.host_pcm[slot].copy_(out["wav_pcm16"], non_blocking=True)
        self.host_len[slot].copy_(out["wav_lengths"], non_blocking=True)
        for k, buf in self.host_tok[slot].items():  # for the check, without a sync
            buf.copy_(out[k], non_blocking=True)
        done = torch.cuda.Event() if self.ctx.device != "cpu" else _Done()
        done.record()
        return i, slot, done, out

    # -- the window -----------------------------------------------------
    def window(self, seconds):
        """Calls back to back for `seconds`, one ahead; returns the
        end-to-end values and keeps the calls the check compares: `calls`
        drawn from the seed among the first round of the pool (every
        window, traced too, completes it), and the first call of the pool's
        longest batch."""
        self.calls = self.rows = self.failed = 0
        self.tokens = self.frames = self.samples = 0
        self.kept = {}
        n = len(self.pool)
        pick = np.random.default_rng((self.ctx.seed + 1) % 2 ** 63)
        self.keep = set(pick.choice(n, self.ctx.workload["check"]["calls"],
                                    replace=False).tolist()) | {self.longest_batch}
        t0 = time.perf_counter()
        end = t0 + seconds
        pending, i = None, 0
        while True:
            cur = self._run(i, i % 2)
            if pending is not None:
                self._finish(pending)
            pending = cur
            i += 1
            if time.perf_counter() >= end:
                break
        self._finish(pending)
        wall = time.perf_counter() - t0
        return {"audio_s_per_s": self.samples / self.sample_rate / wall,
                "window_s": wall, "calls": self.calls}

    def _finish(self, call):
        i, slot, done, out = call
        done.synchronize()
        lengths = self.host_len[slot].numpy().copy()
        inputs = self.pool[i % len(self.pool)]
        cap = self.p["n_frames"] * self.hop
        full = lengths >= cap
        self.calls += 1
        self.rows += len(lengths)
        self.failed += int(full.sum())
        self.samples += int(lengths[~full].sum())
        self.tokens += int(inputs.x_lengths.sum())
        self.frames += int(lengths.sum()) // self.hop
        if i in self.keep:
            self.kept[i] = self._record(i, slot, lengths)

    def _record(self, i, slot, lengths):
        pcm = self.host_pcm[slot].numpy()
        record = {k: buf.numpy().copy() for k, buf in self.host_tok[slot].items()}
        record["pool"] = i % len(self.pool)
        record["audio"] = [pcm[j, :lengths[j]].copy() for j in range(len(lengths))]
        return record

    def counts(self):
        return self.rows, self.failed

    # -- the traced run -------------------------------------------------
    def traced(self, seconds):
        from harness.trace import Spans, profile_window

        spans = Spans()
        install_spans(spans, self.model.generator, self.ctx.config["config"]["generator"])
        try:
            data = profile_window(lambda: self._traced_work(seconds))
        finally:
            spans.remove()
        data.span_shapes = dict(spans.shapes)
        width = text_width(int(self.pool[0].x.shape[1]), self.model.text_bucket)
        data.flops = lambda: synthesis_flops(self.ref, width, self.p["n_frames"],
                                             self.ctx.device)
        return data

    def _traced_work(self, seconds):
        e2e = self.window(seconds)
        return {"tokens": self.tokens, "frames": self.frames, "calls": self.calls,
                "wall_s": e2e["window_s"]}

    # -- after the window -----------------------------------------------
    def free(self):
        """Drop the program's state before the reference runs."""
        del self.model, self.host_pcm, self.host_len, self.host_tok

    def check(self):
        p = self.p
        batches = []
        missing = len(self.keep - set(self.kept))
        for c in self.kept.values():
            inputs = self.pool[c["pool"]]
            width = c["durations"].shape[1]
            ids = np.zeros((len(inputs.x_lengths), width), np.int64)
            ids[:, :inputs.x.shape[1]] = inputs.x
            batches.append(Rows(ids=ids, lengths=inputs.x_lengths,
                                factors=(self.d_factor, 1.0, 1.0), n_frames=p["n_frames"],
                                durations=c["durations"], pitch=c["pitch"], energy=c["energy"],
                                audio=c["audio"], wire="pcm16"))
        numbers = compare(self.ref, batches, self.ctx.device)
        numbers["missing_answers"] = missing
        return numbers, checks(numbers, self.ctx.workload["check"]["limits"])


class _Done:
    """Stands in for a CUDA event where the program runs on the CPU (tests)."""

    def record(self):
        pass

    def synchronize(self):
        pass
