"""Duration <-> frame mapping ops (port of `optispeech_tpu/ops/duration.py`).

All take a fixed frame count and explicit length vectors, as the JAX
functions do, so the port sees the same bucketed shapes.
"""

import torch

from .masking import sequence_mask

_NEG_INF = -1e9


def _interval_matrix(durations: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(B, n_frames, T_text) bool: frame t belongs to token k when
    cumsum_exclusive[k] <= t < cumsum[k]."""
    dur = durations.float()
    cs = torch.cumsum(dur, dim=1)
    cs_ex = cs - dur
    t = torch.arange(n_frames, dtype=torch.float32, device=dur.device)[None, :, None]
    return (cs_ex[:, None, :] <= t) & (cs[:, None, :] > t)


def expand_by_duration(x: torch.Tensor, durations: torch.Tensor,
                       n_frames: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Expand token-level features (B, T_text, C) to frame level; frames
    past the total duration are zero. Returns the (B, n_frames, C)
    expansion and the (B,) int32 total durations."""
    mult = _interval_matrix(durations, n_frames).to(x.dtype)
    lengths = durations.sum(dim=1).to(torch.int32)
    return torch.matmul(mult, x), lengths


def duration_to_frame_index(durations: torch.Tensor, n_frames: int) -> torch.Tensor:
    """Per-frame token index (B, n_frames) int32; frames past the total
    duration map to the last token index."""
    cs = torch.cumsum(durations.float(), dim=1)
    t = torch.arange(n_frames, dtype=torch.float32, device=cs.device)[None, :, None]
    idx = (cs[:, None, :] <= t).sum(dim=-1).to(torch.int32)
    return torch.clamp(idx, max=durations.shape[1] - 1)


def average_by_duration(durations: torch.Tensor, xs: torch.Tensor, text_lengths: torch.Tensor,
                        feats_lengths: torch.Tensor) -> torch.Tensor:
    """Average frame-level values xs (B, T_feats) into token-level means
    (B, T_text); tokens with no valid frame (padding included) get 0."""
    t_text, t_feats = durations.shape[1], xs.shape[1]
    frame_valid = sequence_mask(feats_lengths, t_feats)
    xs = torch.where(frame_valid, xs, 0.0).float()
    token_valid = sequence_mask(text_lengths, t_text)
    dur = torch.where(token_valid, durations, 0)
    m = (_interval_matrix(dur, t_feats) & frame_valid[:, :, None]).float()
    sums = torch.einsum("bft,bf->bt", m, xs)
    counts = m.sum(dim=1)
    avg = sums / torch.clamp(counts, min=1.0)
    return torch.where(token_valid & (counts > 0), avg, 0.0)


def gaussian_upsample(hs: torch.Tensor, ds: torch.Tensor, h_masks: torch.Tensor,
                      d_masks: torch.Tensor | None, delta: float = 0.1) -> torch.Tensor:
    """Gaussian upsampling with fixed temperature.

    Args:
        hs: (B, T_text, C) token hidden states.
        ds: (B, T_text) durations.
        h_masks: (B, T_feats) bool valid-frame mask; its width is the output
            length. Padded frames take position 0, as in the JAX function.
        d_masks: (B, T_text) bool valid-token mask (None: all valid).

    Returns (B, T_feats, C).
    """
    t_feats = h_masks.shape[-1]
    ds = ds.float()
    t = torch.arange(t_feats, dtype=torch.float32, device=hs.device)[None, :]
    t = t * h_masks.float()
    c = torch.cumsum(ds, dim=-1) - ds / 2
    energy = -delta * (t[:, :, None] - c[:, None, :]) ** 2
    if d_masks is not None:
        energy = torch.where(d_masks[:, None, :], energy, torch.full_like(energy, _NEG_INF))
    p_attn = torch.exp(energy - energy.max(dim=2, keepdim=True).values)
    p_attn = p_attn / p_attn.sum(dim=2, keepdim=True)
    return torch.matmul(p_attn.to(hs.dtype), hs)
