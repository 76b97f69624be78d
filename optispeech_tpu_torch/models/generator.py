"""Generator composition, inference half: text -> frames -> waveform.

Port of the inference methods of `optispeech_tpu/models/generator.py`:
- `encode`: token rate, text bucket in, durations/pitch/energy out;
- `decode`: frame rate, at a mel bucket `n_frames` chosen by the caller;
- `synthesise_fixed`: both, with durations kept on the device and the
  output capped at `n_frames`.
Training (alignment, losses, segment crops) belongs to a later slice.
"""

import torch
from torch import nn

from ..config import GeneratorConfig
from ..ops import expand_by_duration, gaussian_upsample, sequence_mask
from .modules.convnext import ConvNeXtBackbone
from .modules.core import DurationPredictor, EnergyPredictor, PitchPredictor, TextEmbedding
from .vocoder.wavenext import WaveNeXt


def make_backbone(cfg, dim):
    if cfg.kind == "convnext":
        return ConvNeXtBackbone(dim, cfg.intermediate_dim, cfg.num_layers,
                                cfg.layer_scale_init_value, fused_pallas=cfg.fused_pallas)
    raise NotImplementedError(
        f"backbone kind `{cfg.kind}` is not ported yet (ROADMAP.md, queue A, slice 3)"
    )


class OptiSpeechGenerator(nn.Module):
    def __init__(self, cfg: GeneratorConfig):
        super().__init__()
        self.cfg = cfg
        te = cfg.text_embedding
        self.text_embedding = TextEmbedding(cfg.dim, te.n_vocab, te.padding_idx,
                                            te.max_source_positions)
        self.encoder = make_backbone(cfg.encoder, cfg.dim)
        self.decoder = make_backbone(cfg.decoder, cfg.dim)
        dp, pp, ep = cfg.duration_predictor, cfg.pitch_predictor, cfg.energy_predictor
        self.duration_predictor = DurationPredictor(
            cfg.dim, dp.num_layers, dp.intermediate_dim, dp.kernel_size, dp.dropout, dp.separable)
        self.pitch_predictor = PitchPredictor(
            cfg.dim, pp.num_layers, pp.intermediate_dim, pp.kernel_size, pp.dropout,
            pp.embed_kernel_size, pp.separable)
        self.energy_predictor = EnergyPredictor(
            cfg.dim, ep.num_layers, ep.intermediate_dim, ep.kernel_size, ep.dropout,
            ep.embed_kernel_size, ep.separable)
        v = cfg.vocoder
        self.vocoder = WaveNeXt(cfg.dim, v.dim, v.intermediate_dim, v.num_layers,
                                cfg.features.n_fft, cfg.features.hop_length,
                                fused_pallas=v.fused_pallas, f0_cond=v.f0_cond)
        if cfg.num_speakers > 1:
            self.sid_embed = nn.Embedding(cfg.num_speakers, cfg.dim)
        if cfg.num_languages > 1:
            self.lid_embed = nn.Embedding(cfg.num_languages, cfg.dim)

    def _encode_text(self, x, input_padding_mask, sids, lids):
        h, _ = self.text_embedding(x)
        h = self.encoder(h, input_padding_mask)
        zeros = lambda: torch.zeros((x.shape[0],), dtype=torch.long, device=x.device)  # noqa: E731
        if self.cfg.num_speakers > 1:
            sids = zeros() if sids is None else sids
            h = h + self.sid_embed(sids.reshape(-1))[:, None, :]
        if self.cfg.num_languages > 1:
            lids = zeros() if lids is None else lids
            h = h + self.lid_embed(lids.reshape(-1))[:, None, :]
        return h

    def encode(self, x, x_lengths, sids=None, lids=None,
               d_factor: float = 1.0, p_factor: float = 1.0, e_factor: float = 1.0):
        """Token-rate stage: hidden states and integer durations."""
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
        y_mask = sequence_mask(y_lengths, n_frames)
        target_padding_mask = ~y_mask
        y = gaussian_upsample(hidden, durations.float(), y_mask, x_mask)
        y = self.decoder(y, target_padding_mask)
        f0_frames = None
        if self.cfg.vocoder.f0_cond:
            f0_frames, _ = expand_by_duration(pitch[..., None], durations, n_frames)
            f0_frames = f0_frames[..., 0] * y_mask.to(f0_frames.dtype)
        wav = self.vocoder(y, f0=f0_frames, padding_mask=target_padding_mask)
        return {"wav": wav.float(), "wav_lengths": y_lengths * self.cfg.features.hop_length}
