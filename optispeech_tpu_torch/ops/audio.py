"""Scalar audio math helpers (port of `optispeech_tpu/ops/audio.py`)."""

import torch


def safe_log(x: torch.Tensor, clip_val: float = 1e-7) -> torch.Tensor:
    """log(clip(x, min=clip_val))."""
    return torch.log(torch.clamp(x, min=clip_val))


def dynamic_range_compression(x: torch.Tensor, clip_val: float = 1e-5):
    """Log-compression of mel magnitudes (JAX's with C = 1)."""
    return torch.log(torch.clamp(x, min=clip_val))
