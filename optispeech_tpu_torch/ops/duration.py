"""Duration -> frame mapping ops (port of `optispeech_tpu/ops/duration.py`).

Both take a fixed output frame count and explicit length vectors, as the JAX
functions do, so the port sees the same bucketed shapes.
"""

import torch

_NEG_INF = -1e9


def expand_by_duration(x: torch.Tensor, durations: torch.Tensor,
                       n_frames: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Expand token-level features (B, T_text, C) to frame level.

    Frame t belongs to token k when cumsum_exclusive[k] <= t < cumsum[k];
    frames past the total duration are zero. Returns the (B, n_frames, C)
    expansion and the (B,) int32 total durations."""
    dur = durations.float()
    cs = torch.cumsum(dur, dim=1)
    cs_ex = cs - dur
    t = torch.arange(n_frames, dtype=torch.float32, device=x.device)[None, :, None]
    mult = ((cs_ex[:, None, :] <= t) & (cs[:, None, :] > t)).to(x.dtype)
    lengths = durations.sum(dim=1).to(torch.int32)
    return torch.matmul(mult, x), lengths


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
