"""Random segment cropping for GAN vocoder training (port of
`optispeech_tpu/ops/segments.py`). The device functions take a
`torch.Generator`; the host functions are numpy, as in JAX."""

import numpy as np
import torch


def get_segments(x: torch.Tensor, start_idxs: torch.Tensor, segment_size: int) -> torch.Tensor:
    """Crop (B, C, segment_size) segments of x (B, C, T) at (B,) start
    indices; indices past the end repeat the last frame."""
    offs = torch.arange(segment_size, device=x.device)
    idx = torch.clamp(start_idxs.long()[:, None] + offs[None, :], 0, x.shape[-1] - 1)
    return torch.gather(x, 2, idx[:, None, :].expand(-1, x.shape[1], -1))


def get_random_segments(generator: torch.Generator, x: torch.Tensor, x_lengths: torch.Tensor,
                        segment_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """start = floor(U[0,1) * max(len - segment_size, 0)) per item, drawn from
    `generator` (on x's device). Returns (segments (B, C, S), starts (B,) int32)."""
    max_start = torch.clamp(x_lengths - segment_size, min=0)
    u = torch.rand(x.shape[0], generator=generator, device=x.device)
    start_idxs = torch.floor(u * max_start).to(torch.int32)
    return get_segments(x, start_idxs, segment_size), start_idxs


def host_sample_segment_starts(rng: np.random.Generator, mel_lengths, segment_size: int):
    """Host (numpy) counterpart of the generator's segment sampling, with the
    same `max(mel_lengths - 4, 1)` bound. Returns (B,) int32 starts in frames."""
    num_frames = np.maximum(np.asarray(mel_lengths) - 4, 1)
    max_start = np.maximum(num_frames - segment_size, 0)
    u = rng.random(len(num_frames))
    return np.floor(u * max_start).astype(np.int32)


def host_slice_wav_segments(wav, start_idxs, segment_size: int, hop_length: int):
    """Slice (B, S*hop) ground-truth waveform segments out of a host (B, T_wav) batch."""
    wav = np.asarray(wav)
    idx = (np.asarray(start_idxs, np.int64)[:, None] * hop_length
           + np.arange(segment_size * hop_length)[None, :])
    idx = np.clip(idx, 0, wav.shape[-1] - 1)
    return np.take_along_axis(wav, idx, axis=1)
