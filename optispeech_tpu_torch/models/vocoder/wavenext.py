"""WaveNeXt vocoder: ConvNeXt trunk + linear waveform head.

Port of `optispeech_tpu/models/vocoder/wavenext.py`: conv embed (k=7)
[+ f0 embed (k=3) when `f0_cond`] -> LN -> ConvNeXt backbone -> Linear(dim ->
n_fft+2) -> Linear(n_fft+2 -> hop, no bias) -> (B, T*hop) -> clip [-1, 1].
The trunk runs fused (the CUDA kernel) only in eval mode; in training it
runs unfused with drop path. Every layer runs in the compute dtype
(`modules/core.py`); the waveform leaves in it, and the generator casts it
to float32.
"""

from typing import Optional

import torch
from torch import nn

from ..modules.convnext import ConvNeXtBackbone
from ..modules.core import Conv1d, LayerNorm, Linear, conv_btc


class WaveNeXtHead(nn.Module):
    """(B, T, H) frame features -> (B, T*hop) waveform."""

    def __init__(self, dim: int, n_fft: int, hop_length: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hop_length = hop_length
        self.linear_1 = Linear(dim, n_fft + 2, dtype=dtype)
        self.linear_2 = Linear(n_fft + 2, hop_length, bias=False, dtype=dtype)

    def forward(self, x):
        b, t, _ = x.shape
        audio = self.linear_2(self.linear_1(x)).reshape(b, t * self.hop_length)
        return torch.clamp(audio, -1.0, 1.0)


class WaveNeXt(nn.Module):
    def __init__(self, input_channels: int, dim: int = 384, intermediate_dim: int = 1152,
                 num_layers: int = 8, n_fft: int = 1024, hop_length: int = 256,
                 layer_scale_init_value: Optional[float] = None, fused_pallas: bool = False,
                 f0_cond: bool = False, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.f0_cond = f0_cond
        self.fused_pallas = fused_pallas
        self.embed = Conv1d(input_channels, dim, 7, padding=3, dtype=dtype)
        if f0_cond:
            self.f0_embed = Conv1d(1, dim, 3, padding=1, dtype=dtype)
        self.norm = LayerNorm(dim, 1e-6, dtype)
        self.backbone = ConvNeXtBackbone(dim, intermediate_dim, num_layers,
                                         layer_scale_init_value, drop_path=drop_path, dtype=dtype)
        self.head = WaveNeXtHead(dim, n_fft, hop_length, dtype)

    def forward(self, x, f0=None, padding_mask=None, generator: Optional[torch.Generator] = None,
                any_length: bool = False):
        """x: (B, T, input_channels) -> (B, T*hop). f0: frame-level pitch,
        (B, T), (B, 1, T) or (B, T, 1); required when `f0_cond` is on.
        `any_length`: the fused trunk's blocks run fused at any T
        (`ConvNeXtBlock.forward`)."""
        x = conv_btc(self.embed, x)
        if self.f0_cond:
            if f0 is None:
                raise ValueError("WaveNeXt(f0_cond=True) requires the f0 argument")
            f0 = f0.reshape(x.shape[0], x.shape[1], 1).to(x.dtype)
            x = x + conv_btc(self.f0_embed, f0)
        x = self.norm(x)
        x = self.backbone(x, padding_mask, fused=self.fused_pallas, generator=generator,
                          any_length=any_length)
        return self.head(x)
