"""Length/padding mask helpers (port of `optispeech_tpu/ops/masking.py`)."""

import torch


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """Boolean mask (B, T): True for valid (non-pad) positions."""
    pos = torch.arange(max_length, dtype=lengths.dtype, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def make_non_pad_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B, T) bool, True on valid positions."""
    return sequence_mask(lengths, max_length)


def make_pad_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B, T) bool, True on PAD positions."""
    return ~sequence_mask(lengths, max_length)
