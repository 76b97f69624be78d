"""µ-law (G.711-style, µ = 255) 8-bit audio companding for the serving wire.

Port of `optispeech_tpu/ops/mulaw.py`. The server computes the wire format
on the device, inside synthesis: pcm16 halves the float32 bytes that cross
to the host, µ-law quarters them at ~38 dB SNR on speech-shaped signals.

`mulaw_encode` and `pack_valid_rows` take tensors and run where they lie,
in float32 as the JAX functions do; `mulaw_decode` and `mulaw_encode_np`
are numpy, for clients and for host-side transcoding.
"""

import numpy as np
import torch

MU = 255.0


def mulaw_encode(wav: torch.Tensor, mu: float = MU) -> torch.Tensor:
    """float32 waveform in [-1, 1] -> uint8 µ-law codes, on wav's device."""
    x = torch.clamp(wav.float(), -1.0, 1.0)
    # divide by a float32 tensor: the card would multiply by the reciprocal
    # of a Python number, which rounds otherwise than JAX's division
    log1p_mu = torch.full((), np.log1p(mu), dtype=torch.float32, device=x.device)
    y = torch.sign(x) * torch.log1p(mu * torch.abs(x)) / log1p_mu
    return torch.round((y + 1.0) * 0.5 * 255.0).to(torch.uint8)


def mulaw_decode(codes, mu: float = MU) -> np.ndarray:
    """uint8 µ-law codes -> float32 waveform in [-1, 1] (numpy; client-side)."""
    y = np.asarray(codes).astype(np.float32) / 255.0 * 2.0 - 1.0
    return (np.sign(y) * ((1.0 + mu) ** np.abs(y) - 1.0) / mu).astype(np.float32)


def pack_valid_rows(codes: torch.Tensor, lengths: torch.Tensor):
    """Compact a padded (B, T) code matrix so that each row's valid prefix
    sits contiguously at cumulative offsets, on the device and without a
    host sync.

    Returns (packed (B*T,) with the valid data in the prefix and zeros
    after, offsets (B,) int32); the valid total is `lengths.sum()`. Unpack
    row i as packed[offsets[i] : offsets[i] + lengths[i]]. JAX drops the
    out-of-range writes (`mode="drop"`); here they go to one extra slot past
    the end, which is cut off."""
    b, t = codes.shape
    lengths = lengths.to(torch.int32)
    offs = torch.cumsum(lengths, 0, dtype=torch.int32) - lengths
    t_idx = torch.arange(t, dtype=torch.int32, device=codes.device)[None, :]
    pos = offs[:, None] + t_idx
    keep = (t_idx < lengths[:, None]) & (pos < b * t)
    pos = torch.where(keep, pos, b * t).reshape(-1).to(torch.int64)
    packed = torch.zeros(b * t + 1, dtype=codes.dtype, device=codes.device)
    packed.scatter_(0, pos, codes.reshape(-1))
    return packed[: b * t], offs


def mulaw_encode_np(wav, mu: float = MU) -> np.ndarray:
    """numpy twin of `mulaw_encode` (host-side transcoding in the server's
    mixed-format batches; equal to the device encode up to float32
    rounding at code boundaries)."""
    x = np.clip(np.asarray(wav, np.float32), -1.0, 1.0)
    y = np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)
    return np.round((y + 1.0) * 0.5 * 255.0).astype(np.uint8)
