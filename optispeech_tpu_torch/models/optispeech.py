"""Top-level model API: prepare_input / synthesise / synthesise_on_device,
and the inference checkpoint (save_checkpoint / load_from_checkpoint).

Port of `optispeech_tpu/models/optispeech.py`. Inference runs in two stages
as in JAX: token-rate `encode` at a text bucket, one host sync that reads the
predicted frame count and picks the mel bucket, then frame-rate `decode`.
`synthesise_on_device` runs both with a fixed frame cap and no sync, inside
the span `synthesise` (`utils/tracing.py`).
`compute_dtype=torch.bfloat16` runs the generator in bf16, as JAX's
`compute_dtype=jnp.bfloat16` does; the weights and checkpoints stay float32.
"""

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..config import ExperimentConfig, InferenceArgs
from ..ops.mulaw import mulaw_encode, pack_valid_rows
from ..text import TextProcessor
from ..utils import tracing
from ..utils.bucketing import round_up_to_bucket
from ..utils.device import resolve_device
from ..values import InferenceInputs, InferenceOutputs
from .generator import OptiSpeechGenerator
from .init import init_like_flax


def with_fused_blocks(cfg: ExperimentConfig) -> ExperimentConfig:
    """Route the decoder (when it is ConvNeXt) and the vocoder trunk through
    the fused block, as the JAX package's `load_from_checkpoint(fused=True)`."""
    g = cfg.generator
    kw = {"vocoder": dataclasses.replace(g.vocoder, fused_pallas=True)}
    if g.decoder.kind == "convnext":
        kw["decoder"] = dataclasses.replace(g.decoder, fused_pallas=True)
    return dataclasses.replace(cfg, generator=dataclasses.replace(g, **kw))


class OptiSpeech:
    def __init__(self, cfg: ExperimentConfig, seed: int = 0, device=None,
                 speakers: Optional[list[str]] = None, state_dict: Optional[dict] = None,
                 compute_dtype: torch.dtype = torch.float32):
        """Build the model on `device` (default: the card; raises when there
        is none), computing in `compute_dtype` (float32 or bfloat16). Weights
        come from `state_dict` when given, else from a seeded initialisation
        with flax's distributions."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.inference_args: InferenceArgs = cfg.inference_args
        self.text_processor = TextProcessor.from_config(cfg.data.text_processor)
        self.num_speakers = cfg.generator.num_speakers
        self.speakers = speakers or []
        self.sample_rate = cfg.generator.features.sample_rate
        self.hop_length = cfg.generator.features.hop_length
        self.text_bucket = cfg.data.text_bucket_size
        self.mel_bucket = cfg.data.mel_bucket_size

        generator = OptiSpeechGenerator(cfg.generator, dtype=compute_dtype)
        if state_dict is None:
            init_like_flax(generator, torch.Generator().manual_seed(seed))
        else:
            generator.load_state_dict(state_dict, strict=True)
        self.generator = generator.to(self.device).eval()

    @classmethod
    def load_from_jax_params(cls, cfg: ExperimentConfig, params_np: dict, device=None,
                             speakers: Optional[list[str]] = None,
                             compute_dtype: torch.dtype = torch.float32) -> "OptiSpeech":
        """Build from a JAX generator param tree given as nested numpy dicts."""
        from ..compat.from_jax import state_dict_from_jax_params

        return cls(cfg, device=device, speakers=speakers,
                   state_dict=state_dict_from_jax_params(params_np, cfg.generator),
                   compute_dtype=compute_dtype)

    def save_checkpoint(self, path: str):
        """Write an inference checkpoint (`config.json` with the config and
        the speakers, `generator.pt`) that `load_from_checkpoint` reads."""
        from ..training.checkpoint import save_inference_checkpoint

        save_inference_checkpoint(path, self.cfg, self.generator.state_dict(),
                                  speakers=self.speakers)

    @classmethod
    def load_from_checkpoint(cls, path: str, device=None, fused: bool = False,
                             compute_dtype: torch.dtype = torch.float32) -> "OptiSpeech":
        """Build from an inference checkpoint (`save_checkpoint`,
        `save_inference_checkpoint`);
        `fused=True` routes the decoder and the vocoder trunk through the
        fused block (`with_fused_blocks`)."""
        from ..training.checkpoint import load_inference_checkpoint

        cfg, state_dict, meta = load_inference_checkpoint(path)
        if fused:
            cfg = with_fused_blocks(cfg)
        return cls(cfg, device=device, speakers=meta.get("speakers") or [],
                   state_dict=state_dict, compute_dtype=compute_dtype)

    # ------------------------------------------------------------------
    def _tensors(self, inputs: InferenceInputs):
        """Pad the ids to the text bucket and move the inputs to the device.

        The ids, the lengths and the sids and lids where given go in one
        int64 host buffer, pinned on a card, and move in one non-blocking
        copy: no host sync, so the host can issue the next call while the
        card still runs this one. The buffer is a fresh tensor of PyTorch's
        caching host allocator, which hands its memory out again only once
        the copy that reads it has run."""
        inputs = inputs.as_numpy()
        b, t_text = inputs.x.shape
        x = np.zeros((b, round_up_to_bucket(t_text, self.text_bucket)), np.int64)
        x[:, :t_text] = inputs.x
        parts = [x, inputs.x_lengths, inputs.sids, inputs.lids]
        sizes = [0 if a is None else np.size(a) for a in parts]
        host = torch.empty(sum(sizes), dtype=torch.int64, pin_memory=self.device.type == "cuda")
        np.concatenate([np.asarray(a, np.int64).ravel() for a in parts if a is not None],
                       out=host.numpy())
        flat = host.to(self.device, non_blocking=True)
        x, x_lengths, sids, lids = (None if a is None else t.view(np.shape(a))
                                    for a, t in zip(parts, flat.split(sizes)))
        return (x, x_lengths.to(torch.int32), sids, lids, float(inputs.d_factor),
                float(inputs.p_factor), float(inputs.e_factor))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def synthesise_on_device(self, inputs: InferenceInputs, n_frames: int, pcm16: bool = False,
                             mulaw: bool = False):
        """Text -> waveform with a fixed frame cap; returns device tensors with
        no host sync: the serving hot path. The wire formats are computed on
        the device: `pcm16=True` adds `wav_pcm16` (int16); `mulaw=True` adds
        `wav_mulaw` (uint8 µ-law codes, `ops/mulaw.py`), `wav_mulaw_packed`
        (every row's valid prefix at cumulative offsets, so that a fetch
        ships only real samples) and `wav_offsets`."""
        rows, width = inputs.x.shape
        bucket = self.text_bucket  # text_width: the width `_tensors` pads x to
        with tracing.span("synthesise", rows=rows, n_frames=n_frames,
                          text_width=max(-(-width // bucket) * bucket, bucket)):
            out = self.generator.synthesise_fixed(*self._tensors(inputs), n_frames=n_frames)
            if pcm16:
                out["wav_pcm16"] = torch.round(out["wav"] * 32767.0).to(torch.int16)
            if mulaw:
                codes = mulaw_encode(out["wav"])
                out["wav_mulaw"] = codes
                out["wav_mulaw_packed"], out["wav_offsets"] = pack_valid_rows(
                    codes, out["wav_lengths"])
        return out

    def fetch_packed(self, packed: torch.Tensor, n_valid: int, bucket: int = 65536) -> np.ndarray:
        """The valid prefix of a packed code buffer (`wav_mulaw_packed`) as
        numpy: a slice on the device, rounded up to `bucket`, then one copy
        to the host."""
        n = min(-(-int(n_valid) // bucket) * bucket, packed.shape[0])
        return packed[:n].cpu().numpy()[: int(n_valid)]

    # ------------------------------------------------------------------
    def prepare_input(
        self,
        text: str,
        *,
        language: str | None = None,
        speaker: str | int | None = None,
        d_factor: float = None,
        p_factor: float = None,
        e_factor: float = None,
        split_sentences: bool = True,
    ) -> InferenceInputs:
        languages = self.text_processor.languages
        if language is None:
            language = languages[0]
        if self.num_speakers > 1:
            if speaker is None:
                sid = 0
            elif isinstance(speaker, str):
                try:
                    sid = self.speakers.index(speaker)
                except (ValueError, IndexError):
                    raise ValueError(
                        f"A speaker with the given name `{speaker}` was not found in speaker list"
                    )
            else:
                sid = int(speaker)
        else:
            sid = None
        if self.text_processor.is_multi_language:
            try:
                lid = languages.index(language)
            except (ValueError, IndexError):
                raise ValueError(
                    f"A language with the given name `{language}` was not found in language list"
                )
        else:
            lid = None

        input_ids, clean_text = self.text_processor(
            text, lang=language, split_sentences=split_sentences
        )
        if split_sentences:
            lengths = [len(phids) for phids in input_ids]
        else:
            lengths = [len(input_ids)]
            input_ids = [input_ids]

        sids = [sid] * len(input_ids) if sid is not None else None
        lids = [lid] * len(input_ids) if lid is not None else None
        return InferenceInputs.from_ids_and_lengths(
            ids=input_ids,
            lengths=lengths,
            clean_text=clean_text,
            sids=sids,
            lids=lids,
            d_factor=d_factor or self.inference_args.d_factor,
            p_factor=p_factor or self.inference_args.p_factor,
            e_factor=e_factor or self.inference_args.e_factor,
        )

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def synthesise(self, inputs: InferenceInputs, max_frames: int | None = None) -> InferenceOutputs:
        """Two-stage synthesis with exact mel bucketing; numpy outputs.

        The timers stop after a device synchronise, so latency and RTF count
        device work, as the JAX timers (which stop after a device fetch) do."""
        x, x_lengths, sids, lids, d, p, e = self._tensors(inputs)

        am_t0 = time.perf_counter()
        enc = self.generator.encode(x, x_lengths, sids, lids, d, p, e)
        y_lengths = enc["y_lengths"].cpu().numpy()  # host sync: picks the mel bucket
        n_frames = round_up_to_bucket(int(y_lengths.max()), self.mel_bucket)
        if max_frames is not None:
            n_frames = min(n_frames, max_frames)
            y_lengths = np.minimum(y_lengths, n_frames)
        self._sync()
        am_infer = (time.perf_counter() - am_t0) * 1000

        v_t0 = time.perf_counter()
        dec = self.generator.decode(
            enc["hidden"], enc["durations"], enc["x_mask"],
            torch.as_tensor(y_lengths.astype(np.int32), device=self.device), n_frames,
            pitch=enc["pitch"] if self.cfg.generator.vocoder.f0_cond else None,
        )
        self._sync()
        wav = dec["wav"].cpu().numpy()
        wav_lengths = dec["wav_lengths"].cpu().numpy()
        v_infer = (time.perf_counter() - v_t0) * 1000

        # RTF over the audio produced, not the bucket-padded buffer
        wav_t = int(wav_lengths.max()) / (self.sample_rate * 1e-3)
        am_rtf = am_infer / wav_t
        v_rtf = v_infer / wav_t
        return InferenceOutputs(
            wav=wav,
            wav_lengths=wav_lengths,
            durations=enc["durations"].cpu().numpy(),
            pitch=enc["pitch"].cpu().numpy(),
            energy=enc["energy"].cpu().numpy(),
            latency=am_infer + v_infer,
            rtf=am_rtf + v_rtf,
            am_rtf=am_rtf,
            v_rtf=v_rtf,
        )
