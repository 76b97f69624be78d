"""The training loop (port of `optispeech_tpu/training/trainer.py`).

`Trainer.fit` runs the GAN train step (whose MAS is the wavefront kernel)
over a loader, logs scalars every `log_every_n_steps`, validates every
`val_every_n_steps` (the validation step's MAS is the extraction kernel,
and the first val utterances are synthesised in full for the perceptual
metrics), checkpoints every `ckpt_every_n_steps` and once more when it
ends, however it ends. A SIGTERM is honoured at the next step boundary.
Everything runs in one process on one device: the card unless the caller
asks for the CPU.

Left out of the JAX trainer, each queued in ROADMAP.md: the workarounds for
a slow host-to-TPU link (the async-dispatch throttle, the host-RSS guard and
its re-exec, `malloc_trim`), the device-resident feature cache
(`_cached_train_step`) and runs over several processes.
"""

import json
import os
import signal
import threading
import time
from typing import Iterable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..config import ExperimentConfig, to_dict
from ..utils.device import resolve_device
from ..utils.pylogger import get_pylogger
from .checkpoint import (
    TrainCheckpointManager,
    is_train_checkpoint_dir,
    load_inference_checkpoint,
    save_inference_checkpoint,
)
from .state import TrainState, init_train_state
from .step import make_train_step, make_val_step

log = get_pylogger(__name__)

# the batch entries the steps read; the rest (texts, file paths) stay on the host
BATCH_KEYS = ("x", "wav", "mel", "x_lengths", "wav_lengths", "mel_lengths", "energies",
              "pitches", "sids", "lids")


def _rss_gb() -> float:
    """This process's resident set size in GiB (0 where /proc is absent)."""
    try:
        with open(f"/proc/{os.getpid()}/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024 / 1024
    except OSError:
        pass
    return 0.0


def _fetch_scalars(logs: dict) -> dict:
    """The 0-d tensors of `logs` as floats, in one device-to-host copy."""
    if not logs:
        return {}
    values = torch.stack([v.detach().float().reshape(()) for v in logs.values()]).cpu()
    return dict(zip(logs, values.tolist()))


class MetricLogger:
    """CSV and JSONL always; the named sinks of training/loggers.py (each
    import-gated) besides. The TensorBoard writer, when there is one, also
    takes the audio and mel samples."""

    def __init__(self, out_dir: str, use_tensorboard: bool = True, wandb_project: str = None,
                 run_name: str = None, config: dict = None, sinks: tuple = ()):
        os.makedirs(out_dir, exist_ok=True)
        self.csv_path = os.path.join(out_dir, "metrics.csv")
        if not os.path.exists(self.csv_path):
            with open(self.csv_path, "w") as f:
                f.write("step,metric,value\n")
        self.jsonl_path = os.path.join(out_dir, "metrics.jsonl")
        from .loggers import make_sink

        names = list(sinks)
        if use_tensorboard and "tensorboard" not in names:
            names.insert(0, "tensorboard")
        if wandb_project and "wandb" not in names:
            names.append("wandb")
        sink_cfg = dict(config or {})
        if wandb_project:
            sink_cfg.setdefault("wandb_project", wandb_project)
        self.sinks = [s for s in (make_sink(n, out_dir, run_name, sink_cfg) for n in names)
                      if s is not None]
        self.tb = next((s.writer for s in self.sinks if hasattr(s, "writer")), None)

    def log(self, step: int, metrics: dict):
        metrics = {k: float(v) for k, v in metrics.items()}
        # long format: any namespace can appear at any step
        with open(self.csv_path, "a") as f:
            for k in sorted(metrics):
                f.write(f"{step},{k},{metrics[k]}\n")
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps({"step": step, **metrics}) + "\n")
        for sink in self.sinks:
            sink.log(step, metrics)

    def close(self):
        for sink in self.sinks:
            sink.close()


class Trainer:
    def __init__(self, cfg: ExperimentConfig, out_dir: str = "runs/dev", device=None,
                 debug_nans: bool = False):
        """`device`: the card by default (raises when there is none), "cpu"
        when asked. `debug_nans` turns on autograd's anomaly detection."""
        if cfg.num_devices not in (None, 1):
            raise NotImplementedError(f"num_devices={cfg.num_devices}: training on several "
                                      "devices is not ported yet (ROADMAP.md, queue A item 7)")
        self.cfg = cfg
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.device = resolve_device(device)
        if debug_nans:
            torch.autograd.set_detect_anomaly(True)
        self.train_step = make_train_step(cfg)
        self.val_step = make_val_step(cfg)
        self.metrics = MetricLogger(out_dir, wandb_project=cfg.wandb_project,
                                    run_name=cfg.run_name, config=to_dict(cfg),
                                    sinks=cfg.loggers)
        self.ckpt = TrainCheckpointManager(os.path.join(out_dir, cfg.ckpt_dir), keep=cfg.ckpt_keep)
        self._prev_val_wavs = None  # the last validation's synthesised audio

    def init_or_restore_state(self, seed: int = None, forced_resume_from: str = None
                              ) -> TrainState:
        """A fresh state from `seed` (default: the config's), then either the
        newest checkpoint of this run, or with `forced_resume_from` only the
        weights of a training checkpoint directory (G and D) or of an
        inference checkpoint (G), with fresh optimisers and step."""
        state = init_train_state(self.cfg, self.device,
                                 seed if seed is not None else self.cfg.seed)
        if forced_resume_from:
            path = os.path.abspath(os.path.expanduser(forced_resume_from))
            if is_train_checkpoint_dir(path):
                saved, ck_step = TrainCheckpointManager(path).read()
                state.generator.load_state_dict(saved["generator"])
                state.discriminator.load_state_dict(saved["discriminator"])
                log.info(f"Force-resumed generator+discriminator weights from train checkpoint "
                         f"{path} (step {ck_step}); fresh optimizers")
            else:
                _, g_state, _ = load_inference_checkpoint(path)
                state.generator.load_state_dict(g_state)
                log.info(f"Force-resumed generator weights from {path}")
        else:
            restored, step = self.ckpt.restore(state)
            if restored is not None:
                log.info(f"Restored training state from step {step}")
        n_g = sum(p.numel() for p in state.generator.parameters())
        n_d = sum(p.numel() for p in state.discriminator.parameters())
        log.info(f"Generator params: {n_g / 1e6:.2f} M, discriminator params: {n_d / 1e6:.2f} M")
        self.metrics.log(0, {"model/params_g": n_g, "model/params_d": n_d})
        return state

    def fit(self, train_loader: Iterable, val_loader: Optional[Iterable] = None,
            max_steps: Optional[int] = None, state: Optional[TrainState] = None,
            fast_dev_run: bool = False, profile_steps: Optional[tuple[int, int]] = None
            ) -> TrainState:
        """Train until `max_steps` (default: the config's). `profile_steps=
        (start, stop)` traces those steps with torch.profiler into
        out_dir/profile/trace.json, where the spans `trainer/segment` (host
        segment slicing) and `trainer/to_device` (the copy to the device)
        mark the loop's host work."""
        cfg = self.cfg
        max_steps = 1 if fast_dev_run else (max_steps or cfg.max_steps)
        state = state if state is not None else self.init_or_restore_state()
        step = state.step
        # resume the data iterator at the batch the checkpoint was cut at
        if step and hasattr(train_loader, "load_state_dict"):
            loader_state = self.ckpt.loader_state(step)
            if loader_state is not None:
                train_loader.load_state_dict(loader_state)
                log.info(f"Restored data-iterator state: {loader_state}")
        t_last, steps_since, empty_passes = time.perf_counter(), 0, 0
        profiler, saved_step = None, None

        # SIGTERM sets a flag that is read at the step boundary, so the
        # final save never sees a step half applied
        preempted = threading.Event()

        def _sigterm(_sig, _frm):
            log.info("SIGTERM (preemption) — will checkpoint at the step boundary")
            preempted.set()

        old_handler = signal.signal(signal.SIGTERM, _sigterm)
        try:
            while step < max_steps:
                saw_batch = False
                for batch in train_loader:
                    saw_batch = True
                    if profile_steps and step == profile_steps[0]:
                        profiler = self._start_profile()
                    with record_function("trainer/segment"):
                        host_batch = self._segment_batch(self._device_batch(batch), step)
                    with record_function("trainer/to_device"):
                        device_batch = self._to_device(host_batch)
                    logs = self.train_step(state, device_batch)
                    if profiler is not None and step == profile_steps[1]:
                        profiler = self._stop_profile(profiler)
                    step += 1
                    steps_since += 1
                    if step % cfg.log_every_n_steps == 0 or fast_dev_run:
                        logs = _fetch_scalars(logs)
                        dt = time.perf_counter() - t_last
                        logs["perf/steps_per_sec"] = steps_since / max(dt, 1e-9)
                        logs["perf/host_rss_gb"] = _rss_gb()
                        t_last, steps_since = time.perf_counter(), 0
                        self.metrics.log(step, logs)
                        log.info(f"step {step}: g={logs['total_loss/generator']:.4f} "
                                 f"d={logs['total_loss/discriminator']:.4f} "
                                 f"({logs['perf/steps_per_sec']:.2f} it/s)")
                    if val_loader is not None and step % cfg.val_every_n_steps == 0:
                        self.validate(state, val_loader, step)
                    if step % cfg.ckpt_every_n_steps == 0 or fast_dev_run:
                        self.ckpt.save(step, state, cfg, self._loader_state(train_loader))
                        saved_step = step
                    if preempted.is_set():
                        raise KeyboardInterrupt("SIGTERM (preemption)")
                    if step >= max_steps:
                        break
                if saw_batch:
                    empty_passes = 0
                else:
                    # one empty pass is legitimate: a loader resumed at an
                    # epoch boundary starts at the end of its batch list
                    empty_passes += 1
                    if empty_passes > 1:
                        raise RuntimeError("train_loader yielded no batches twice in a row "
                                           "(dataset smaller than the batch size with drop_last?)")
        except KeyboardInterrupt:
            log.info("Interrupted/preempted — saving checkpoint before exit")
        finally:
            signal.signal(signal.SIGTERM, old_handler)
            if profiler is not None:
                self._stop_profile(profiler)
            try:
                if step != saved_step:  # a step is saved once
                    self.ckpt.save(step, state, cfg, self._loader_state(train_loader))
                self.ckpt.wait()
            except Exception:
                log.exception("final checkpoint failed; the last periodic checkpoint stands")
            self.metrics.close()
        return state

    @torch.no_grad()
    def validate(self, state: TrainState, val_loader: Iterable, step: int) -> dict:
        """Mean val losses over `val_loader` (segment seed `step * 131 + n`
        for batch n), the perceptual metrics the config asks for on up to
        `val_synth_utterances` utterances synthesised in full, and
        `val/synth_wav_delta` against the previous validation's audio, and
        the pass's wall time in seconds: `perf/val_seconds` in all, of which
        `perf/val_synth_seconds` synthesis and `perf/val_metrics_seconds`
        the perceptual metrics."""
        t_start = time.perf_counter()
        agg: dict = {}
        n = 0
        ta = self.cfg.train_args
        want_synth = (ta.evaluate_periodicity or ta.evaluate_pesq or ta.evaluate_mcd
                      or ta.evaluate_utmos or ta.evaluate_stoi or self.metrics.tb is not None)
        synth_batches: list = []
        n_collected = 0
        for batch in val_loader:
            host = self._device_batch(batch)
            if want_synth and n_collected < ta.val_synth_utterances:
                synth_batches.append(host)
                n_collected += host["x"].shape[0]
            logs, _wav, _wav_hat = self.val_step(
                state, self._to_device(self._segment_batch(host, step * 131 + n)))
            for k, v in _fetch_scalars(logs).items():
                agg[k] = agg.get(k, 0.0) + v
            n += 1
        if not n:
            return {}
        t_synth = time.perf_counter()
        wav_pairs = (self._synthesise_val_utterances(state, synth_batches,
                                                     ta.val_synth_utterances)
                     if want_synth and synth_batches else [])
        t_metrics = time.perf_counter()
        if wav_pairs:
            # how much the synthesised val audio moved since the last
            # validation: a perceptual metric frozen while this moves is
            # saturated, not broken
            gen_wavs = [gen for _, gen in wav_pairs]
            prev = self._prev_val_wavs
            if prev is not None and len(prev) == len(gen_wavs):
                deltas = [float(np.mean(np.abs(g[:min(len(g), len(p))] - p[:min(len(g), len(p))])))
                          for g, p in zip(gen_wavs, prev)]
                agg["val/synth_wav_delta"] = float(np.mean(deltas)) * n
            self._prev_val_wavs = [g.copy() for g in gen_wavs]
            agg.update({k: v * n for k, v in self._perceptual_metrics(wav_pairs).items()})
        out = {k: v / n for k, v in agg.items()}
        t_end = time.perf_counter()
        out.update({"perf/val_seconds": t_end - t_start,
                    "perf/val_synth_seconds": t_metrics - t_synth,
                    "perf/val_metrics_seconds": t_end - t_metrics})
        self.metrics.log(step, out)
        if wav_pairs:
            self._log_samples(step, wav_pairs)
        log.info(f"val @ {step}: total={out['total_loss/val_total']:.4f}")
        return out

    def _perceptual_metrics(self, wav_pairs) -> dict:
        """The metrics `train_args` asks for on (ground truth, generated) pairs."""
        from . import metrics

        ta = self.cfg.train_args
        sr = self.cfg.generator.features.sample_rate
        refs16 = [metrics.resample_to_16k(gt, sr) for gt, _ in wav_pairs]
        gens16 = [metrics.resample_to_16k(gen, sr) for _, gen in wav_pairs]
        trimmed = [(r[:min(len(r), len(g))], g[:min(len(r), len(g))])
                   for r, g in zip(refs16, gens16)]
        out = {}
        if ta.evaluate_periodicity:
            perio, pitch_rmse, f1 = metrics.periodicity_metrics(refs16, gens16)
            out.update({"val/periodicity_loss": perio, "val/perio_pitch_loss": pitch_rmse,
                        "val/f1_score": f1})
        if ta.evaluate_mcd:
            out["val/mcd"] = float(np.mean([metrics.mel_cepstral_distortion(gt, gen, sr)
                                            for gt, gen in wav_pairs]))
        if ta.evaluate_stoi:
            out["val/stoi"] = metrics.stoi_score([r for r, _ in trimmed], [g for _, g in trimmed])
        if ta.evaluate_pesq:
            try:
                out["val/pesq"] = metrics.pesq_score([r for r, _ in trimmed],
                                                     [g for _, g in trimmed])
            except ImportError:
                log.warning("evaluate_pesq set but the pesq package is unavailable")
        if ta.evaluate_utmos:
            try:
                out["val/utmos"] = float(np.mean(metrics.utmos_score(gens16)))
            except ImportError as e:
                log.warning(f"evaluate_utmos set but unavailable: {e}")
        return out

    @torch.no_grad()
    def _synthesise_val_utterances(self, state: TrainState, host_batches, k: int):
        """Text -> wav through `synthesise_fixed` on up to `k` val utterances;
        returns [(gt_wav, gen_wav)] cut to their lengths. n_frames is the
        longest ground truth plus 25% and 8 frames, rounded up to the mel
        bucket."""
        from ..utils.bucketing import round_up_to_bucket

        hop = self.cfg.generator.features.hop_length
        gen = state.generator.eval()
        dev = lambda a: None if a is None else torch.as_tensor(a, device=self.device)  # noqa: E731
        pairs = []
        for host in host_batches:
            n_frames = round_up_to_bucket(int(host["mel_lengths"].max() * 1.25) + 8,
                                          self.cfg.data.mel_bucket_size)
            out = gen.synthesise_fixed(dev(host["x"]), dev(host["x_lengths"]),
                                       dev(host.get("sids")), dev(host.get("lids")),
                                       1.0, 1.0, 1.0, n_frames)
            wav_hat = out["wav"].float().cpu().numpy()
            gen_lens = out["wav_lengths"].cpu().numpy()
            gt_lens = host.get("wav_lengths")
            if gt_lens is None:
                gt_lens = np.asarray(host["mel_lengths"]) * hop
            for i in range(wav_hat.shape[0]):
                pairs.append((np.asarray(host["wav"][i][:int(gt_lens[i])], np.float32),
                              wav_hat[i][:int(gen_lens[i])]))
                if len(pairs) >= k:
                    return pairs
        return pairs

    def _log_samples(self, step: int, wav_pairs):
        """Ground-truth and generated audio and the generated mel to TensorBoard."""
        if self.metrics.tb is None:
            return
        from ..data.dsp import log_mel_spectrogram_np

        f = self.cfg.generator.features
        for i in range(min(2, len(wav_pairs))):
            gt, gen = wav_pairs[i]
            self.metrics.tb.add_audio(f"wav/original_{i}", gt[:, None], step, f.sample_rate)
            self.metrics.tb.add_audio(f"wav/generated_{i}", gen[:, None], step, f.sample_rate)
            mel = log_mel_spectrogram_np(np.asarray(gen, np.float32), f.sample_rate, f.n_fft,
                                         f.hop_length, f.win_length, f.n_feats, f.f_min, f.f_max)
            lo, hi = mel.min(), mel.max()
            img = (mel - lo) / max(hi - lo, 1e-6)
            self.metrics.tb.add_image(f"mel/generated_{i}",
                                      np.ascontiguousarray(img[None, ::-1, :]), step)

    def export_inference_checkpoint(self, state: TrainState, path: str):
        save_inference_checkpoint(path, self.cfg, state.generator.state_dict())

    def _start_profile(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profile(self, profiler):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        os.makedirs(os.path.join(self.out_dir, "profile"), exist_ok=True)
        profiler.export_chrome_trace(os.path.join(self.out_dir, "profile", "trace.json"))
        return None

    @staticmethod
    def _loader_state(loader) -> Optional[dict]:
        return loader.state_dict() if hasattr(loader, "state_dict") else None

    @staticmethod
    def _device_batch(batch: dict) -> dict:
        return {k: v for k, v in batch.items() if k in BATCH_KEYS}

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items() if v is not None}

    def _segment_batch(self, batch: dict, step: int) -> dict:
        """Sample the GAN segment starts on the host and keep only the
        matching ground-truth crop (`wav_seg`) of the waveform, seeded by
        (config seed, step) as JAX seeds process 0, so a resumed run draws
        the same starts."""
        wav = batch.get("wav")
        if wav is None:
            return batch
        from ..ops.segments import host_sample_segment_starts, host_slice_wav_segments

        seg = min(self.cfg.generator.segment_size, batch["mel"].shape[-1])
        hop = self.cfg.generator.features.hop_length
        rng = np.random.default_rng((self.cfg.seed * 1_000_003 + step) & 0x7FFFFFFF)
        start = host_sample_segment_starts(rng, batch["mel_lengths"], seg)
        out = {k: v for k, v in batch.items() if k not in ("wav", "wav_lengths")}
        out["start_idx"] = start
        out["wav_seg"] = host_slice_wav_segments(wav, start, seg, hop)
        if self.cfg.train_args.wire_mel_dtype == "bfloat16":
            # half the bytes of the largest transfer; the steps read mel as f32
            out["mel"] = torch.as_tensor(out["mel"]).to(torch.bfloat16)
        return out
