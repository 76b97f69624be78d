"""Generator composition: text -> frames -> waveform, plus the AM losses.

Port of `optispeech_tpu/models/generator.py`:
- `forward`: the training forward at padded text/mel buckets (alignment,
  MAS durations, teacher-forced predictors, a segment crop for the
  vocoder, losses), in training mode with the caller's `torch.Generator`;
- `encode`: token rate, text bucket in, durations/pitch/energy out;
- `decode`: frame rate, at a mel bucket `n_frames` chosen by the caller;
- `synthesise_fixed`: both, with durations kept on the device and the
  output capped at `n_frames`.
The inference methods expect eval mode, as JAX runs them deterministic.

`dtype` is the compute dtype, float32 or bfloat16 (flax's `dtype=`, passed
down the module tree as JAX passes it): the parameters stay float32 and the
activations run in `dtype`, but for JAX's float32 islands (the alignment
distance, MAS, the losses, the upsampling weights before their product) and
the waveform, which leaves in float32.

Spans (`utils/tracing.py`): `encode`, `decode` and, inside it, `decoder` and
`vocoder`; `train/mas` around the training forward's MAS.
"""

import torch
from torch import nn

from ..config import GeneratorConfig
from ..ops import (
    average_by_duration,
    expand_by_duration,
    forward_sum_loss,
    gaussian_upsample,
    get_random_segments,
    get_segments,
    sequence_mask,
    viterbi_decode,
    viterbi_decode_extract,
)
from ..parallel.mesh import mean_share
from ..utils import tracing
from .losses import fastspeech2_loss
from .modules.alignment import AlignmentModule
from .modules.conformer import ConformerBackbone
from .modules.convnext import ConvNeXtBackbone
from .modules.core import (
    DurationPredictor,
    Embedding,
    EnergyPredictor,
    PitchPredictor,
    TextEmbedding,
)
from .modules.leanspeech import LeanSpeechBackbone
from .modules.lightspeech import LightSpeechTransformerDecoder, LightSpeechTransformerEncoder
from .modules.transformer import TransformerBackbone
from .vocoder.wavenext import WaveNeXt


def compute_dtype(name: str) -> torch.dtype:
    """The compute dtype that `train_args.compute_dtype` names: "float32" or
    "bfloat16"."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in dtypes:
        raise ValueError(f"compute_dtype {name!r}: float32 or bfloat16")
    return dtypes[name]


def make_backbone(cfg, dim, dtype=torch.float32, is_decoder=False):
    """The encoder or decoder stack of `cfg.kind`: convnext, lightspeech (its
    decoder adds positions), transformer, conformer or leanspeech."""
    if cfg.kind == "convnext":
        return ConvNeXtBackbone(dim, cfg.intermediate_dim, cfg.num_layers,
                                cfg.layer_scale_init_value, fused_pallas=cfg.fused_pallas,
                                drop_path=cfg.drop_path, dtype=dtype)
    if cfg.kind == "lightspeech":
        cls = LightSpeechTransformerDecoder if is_decoder else LightSpeechTransformerEncoder
        return cls(dim, tuple(cfg.kernel_sizes), cfg.activation, cfg.dropout, dtype=dtype)
    if cfg.kind == "transformer":
        return TransformerBackbone(dim, cfg.attention_heads, cfg.linear_units, cfg.num_blocks,
                                   cfg.dropout, cfg.positional_dropout_rate,
                                   cfg.attention_dropout_rate, dtype=dtype)
    if cfg.kind == "conformer":
        return ConformerBackbone(dim, cfg.attention_heads, cfg.linear_units, cfg.num_blocks,
                                 cfg.dropout, cfg.positional_dropout_rate,
                                 cfg.attention_dropout_rate, cfg.cnn_module_kernel,
                                 cfg.conv_norm, dtype=dtype)
    if cfg.kind == "leanspeech":
        return LeanSpeechBackbone(dim, cfg.kernel_size, cfg.num_layers, cfg.drop_path,
                                  dtype=dtype)
    raise ValueError(f"unknown backbone kind {cfg.kind}")


class OptiSpeechGenerator(nn.Module):
    def __init__(self, cfg: GeneratorConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype
        te = cfg.text_embedding
        self.text_embedding = TextEmbedding(cfg.dim, te.n_vocab, te.padding_idx,
                                            te.max_source_positions, te.dropout, dtype)
        self.encoder = make_backbone(cfg.encoder, cfg.dim, dtype)
        self.decoder = make_backbone(cfg.decoder, cfg.dim, dtype, is_decoder=True)
        dp, pp, ep = cfg.duration_predictor, cfg.pitch_predictor, cfg.energy_predictor
        self.duration_predictor = DurationPredictor(
            cfg.dim, dp.num_layers, dp.intermediate_dim, dp.kernel_size, dp.dropout, dp.separable,
            dtype)
        self.pitch_predictor = PitchPredictor(
            cfg.dim, pp.num_layers, pp.intermediate_dim, pp.kernel_size, pp.dropout,
            pp.embed_kernel_size, pp.separable, pp.embed_dropout, dtype)
        self.energy_predictor = EnergyPredictor(
            cfg.dim, ep.num_layers, ep.intermediate_dim, ep.kernel_size, ep.dropout,
            ep.embed_kernel_size, ep.separable, ep.embed_dropout, dtype)
        self.alignment_module = AlignmentModule(cfg.dim, cfg.features.n_feats, dtype)
        v = cfg.vocoder
        self.vocoder = WaveNeXt(cfg.dim, v.dim, v.intermediate_dim, v.num_layers,
                                cfg.features.n_fft, cfg.features.hop_length,
                                fused_pallas=v.fused_pallas, f0_cond=v.f0_cond,
                                drop_path=v.drop_path, dtype=dtype)
        if cfg.num_speakers > 1:
            self.sid_embed = Embedding(cfg.num_speakers, cfg.dim, dtype)
        if cfg.num_languages > 1:
            self.lid_embed = Embedding(cfg.num_languages, cfg.dim, dtype)

    def _encode_text(self, x, input_padding_mask, sids, lids, generator=None):
        h, _ = self.text_embedding(x, generator)
        h = self.encoder(h, input_padding_mask, generator=generator)
        zeros = lambda: torch.zeros((x.shape[0],), dtype=torch.long, device=x.device)  # noqa: E731
        if self.cfg.num_speakers > 1:
            sids = zeros() if sids is None else sids
            h = h + self.sid_embed(sids.reshape(-1))[:, None, :]
        if self.cfg.num_languages > 1:
            lids = zeros() if lids is None else lids
            h = h + self.lid_embed(lids.reshape(-1))[:, None, :]
        return h

    def forward(self, x, x_lengths, mel, mel_lengths, pitches, energies, sids=None, lids=None,
                start_idx=None, generator: torch.Generator | None = None,
                extract_durations: bool = False, mesh=None):
        """Training forward, or with `extract_durations` the validation forward.

        Args:
            x: (B, T_text) phoneme ids. mel: (B, n_feats, T_mel).
            pitches, energies: (B, T_mel) frame-level values.
            start_idx: optional (B,) segment starts sampled on the host; when
                given, `generator` is not used for the segment.
            generator: the step's RNG (dropout, drop path, segment starts).
            extract_durations: set by a caller that takes no gradient (the
                validation step): MAS runs the duration extraction
                (`viterbi_decode_extract`), whose bin loss has no gradient,
                instead of the training MAS.
            mesh: a data-parallel mesh (`parallel/mesh.py`): the losses
                are then this rank's share of the global batch's (the
                masked means over every rank's tokens, the per-item means
                over the world size).

        Returns a dict: wav_hat (B, segment*hop), start_idx, segment_size,
        loss and its parts, durations.
        """
        c = self.cfg
        t_text, t_mel = x.shape[1], mel.shape[-1]
        x_mask = sequence_mask(x_lengths, t_text)
        mel_mask = sequence_mask(mel_lengths, t_mel)
        input_padding_mask, target_padding_mask = ~x_mask, ~mel_mask

        h = self._encode_text(x, input_padding_mask, sids, lids, generator)
        log_p_attn = self.alignment_module(h, mel.transpose(1, 2).to(h.dtype), x_lengths,
                                           mel_lengths, x_masks=input_padding_mask)
        # the DP is detached inside viterbi_decode; the bin loss trains the
        # alignment module through its gather
        if extract_durations:
            durations, bin_loss = viterbi_decode_extract(log_p_attn, x_lengths, mel_lengths)
        else:
            with tracing.span("train/mas"):
                durations, bin_loss = viterbi_decode(log_p_attn, x_lengths, mel_lengths)
        duration_hat = self.duration_predictor(h.detach(), input_padding_mask, generator)

        pitches_tok = average_by_duration(durations, pitches, x_lengths, mel_lengths)
        energies_tok = average_by_duration(durations, energies, x_lengths, mel_lengths)
        h, pitch_hat = self.pitch_predictor(h, input_padding_mask, pitches_tok, generator)
        h, energy_hat = self.energy_predictor(h, input_padding_mask, energies_tok, generator)

        y = gaussian_upsample(h, durations, mel_mask, x_mask)
        y = self.decoder(y, target_padding_mask, generator=generator)

        segment_size = min(c.segment_size, t_mel)
        if start_idx is None:
            num_frames = torch.clamp(mel_lengths - 4, min=1)
            seg, start_idx = get_random_segments(generator, y.transpose(1, 2), num_frames,
                                                 segment_size)
        else:
            seg = get_segments(y.transpose(1, 2), start_idx, segment_size)
        seg = seg.transpose(1, 2)  # (B, S, C)
        if c.detach_vocoder_input:
            seg = seg.detach()
        f0 = get_segments(pitches[:, None, :], start_idx, segment_size)
        wav_hat = self.vocoder(seg, f0=f0.detach(), generator=generator)

        d_l, p_l, e_l = fastspeech2_loss(duration_hat, pitch_hat, energy_hat, durations,
                                         pitches_tok, energies_tok, x_lengths, t_text, mesh)
        # both are means over the items
        align_loss = mean_share(forward_sum_loss(log_p_attn, x_lengths, mel_lengths) + bin_loss,
                                mesh)
        lc = c.loss_coeffs
        loss = (align_loss * lc.lambda_align + d_l * lc.lambda_duration
                + p_l * lc.lambda_pitch + e_l * lc.lambda_energy)
        return {
            "wav_hat": wav_hat.float(), "start_idx": start_idx, "segment_size": segment_size,
            "loss": loss, "align_loss": align_loss, "duration_loss": d_l,
            "pitch_loss": p_l, "energy_loss": e_l, "durations": durations,
        }

    def encode(self, x, x_lengths, sids=None, lids=None,
               d_factor: float = 1.0, p_factor: float = 1.0, e_factor: float = 1.0):
        """Token-rate stage: hidden states and integer durations."""
        with tracing.span("encode"):
            x_mask = sequence_mask(x_lengths, x.shape[1])
            input_padding_mask = ~x_mask
            h = self._encode_text(x, input_padding_mask, sids, lids)
            durations = self.duration_predictor.infer(h, input_padding_mask, factor=d_factor)
            h, pitch = self.pitch_predictor.infer(h, input_padding_mask, p_factor)
            h, energy = self.energy_predictor.infer(h, input_padding_mask, e_factor)
            y_lengths = durations.sum(dim=1, dtype=torch.int32)
        return {
            "hidden": h, "durations": durations, "pitch": pitch, "energy": energy,
            "y_lengths": y_lengths, "x_mask": x_mask,
        }

    def synthesise_fixed(self, x, x_lengths, sids=None, lids=None, d_factor: float = 1.0,
                         p_factor: float = 1.0, e_factor: float = 1.0, n_frames: int = 1024):
        """Text -> waveform with no host sync: the output is capped at `n_frames`."""
        enc = self.encode(x, x_lengths, sids, lids, d_factor, p_factor, e_factor)
        y_lengths = torch.clamp(enc["y_lengths"], max=n_frames)
        dec = self.decode(enc["hidden"], enc["durations"], enc["x_mask"], y_lengths, n_frames,
                          pitch=enc["pitch"])
        return {**dec, "durations": enc["durations"], "pitch": enc["pitch"],
                "energy": enc["energy"], "y_lengths": y_lengths}

    def decode(self, hidden, durations, x_mask, y_lengths, n_frames: int, pitch=None):
        """Frame-rate stage: upsample -> decoder -> vocoder at `n_frames`.
        `pitch` (token level, p_factor applied) is required when the vocoder
        is f0-conditioned."""
        with tracing.span("decode"):
            y_mask = sequence_mask(y_lengths, n_frames)
            target_padding_mask = ~y_mask
            y = gaussian_upsample(hidden, durations.float(), y_mask, x_mask)
            with tracing.span("decoder"):
                y = self.decoder(y, target_padding_mask)
            f0_frames = None
            if self.cfg.vocoder.f0_cond:
                f0_frames, _ = expand_by_duration(pitch[..., None], durations, n_frames)
                f0_frames = f0_frames[..., 0] * y_mask.to(f0_frames.dtype)
            with tracing.span("vocoder"):
                wav = self.vocoder(y, f0=f0_frames, padding_mask=target_padding_mask)
        return {"wav": wav.float(), "wav_lengths": y_lengths * self.cfg.features.hop_length}
