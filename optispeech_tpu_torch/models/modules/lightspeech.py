"""LightSpeech separable-conv transformer backbone (the `light` configs).

Port of `optispeech_tpu/models/modules/lightspeech.py`. (B, T, C) in and
out, a (B, T) bool padding mask (True = PAD). Per-layer kernel sizes from
the config ([5, 25, 13, 9] encoder, [17, 21, 9, 13] decoder in
`configs/light.yaml`). Submodule names follow the reference's torch keys
(`encoder.layers.{i}.conv1.depthwise_conv.weight`, `decoder.pos_emb.scale`,
`encoder.layer_norm.weight`).

Three LayerNorm epsilons, as in JAX: 1e-6 in each layer, 1e-12 at the
encoder's end, 1e-5 at the decoder's end. Each layer zeroes the PAD frames
before its first separable conv only, so its second conv reads the first's
spill past the valid edge, as the reference's does.
"""

from typing import Optional, Sequence

import torch
from torch import nn

from .core import (
    DEFAULT_MAX_SOURCE_POSITIONS,
    ConvSeparable,
    LayerNorm,
    ScaledSinusoidalEmbedding,
    activation,
    conv_btc,
    dropout,
    keep_mask,
)


class EncSepConvLayer(nn.Module):
    """LN -> (mask) -> sepconv -> act -> dropout -> sepconv -> act -> dropout
    -> residual."""

    def __init__(self, dim: int, kernel_size: int, dropout: float = 0.0,
                 activation: str = "relu", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.act = activation
        self.layer_norm = LayerNorm(dim, 1e-6, dtype)
        self.conv1 = ConvSeparable(dim, dim, kernel_size, dropout=dropout, dtype=dtype)
        self.conv2 = ConvSeparable(dim, dim, kernel_size, dropout=dropout, dtype=dtype)

    def forward(self, x, padding_mask=None, generator: Optional[torch.Generator] = None):
        act = activation(self.act)
        h = keep_mask(self.layer_norm(x), padding_mask)
        h = dropout(act(conv_btc(self.conv1, h)), self.dropout, self.training, generator)
        h = dropout(act(conv_btc(self.conv2, h)), self.dropout, self.training, generator)
        return x + h


class LightSpeechTransformerEncoder(nn.Module):
    def __init__(self, dim: int, kernel_sizes: Sequence[int] = (5, 25, 13, 9),
                 activation: str = "relu", dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            [EncSepConvLayer(dim, k, dropout, activation, dtype) for k in kernel_sizes])
        self.layer_norm = LayerNorm(dim, 1e-12, dtype)

    def forward(self, x, padding_mask=None, generator: Optional[torch.Generator] = None):
        for layer in self.layers:
            x = layer(x, padding_mask, generator)
        return keep_mask(self.layer_norm(x), padding_mask)


class LightSpeechTransformerDecoder(nn.Module):
    """Adds scaled-sinusoidal positions (theta = max_source_positions, 2000)
    before the conv stack; its final LayerNorm leaves the PAD frames as
    they are."""

    def __init__(self, dim: int, kernel_sizes: Sequence[int] = (17, 21, 9, 13),
                 activation: str = "relu", dropout: float = 0.2,
                 max_source_positions: int = DEFAULT_MAX_SOURCE_POSITIONS,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.pos_emb = ScaledSinusoidalEmbedding(dim, theta=max_source_positions)
        self.layers = nn.ModuleList(
            [EncSepConvLayer(dim, k, dropout, activation, dtype) for k in kernel_sizes])
        self.layer_norm = LayerNorm(dim, 1e-5, dtype)

    def forward(self, x, padding_mask=None, generator: Optional[torch.Generator] = None):
        x = keep_mask(x + self.pos_emb(x.shape[1])[None].to(x.dtype), padding_mask)
        x = dropout(x, self.dropout, self.training, generator)
        for layer in self.layers:
            x = layer(x, padding_mask, generator)
        return self.layer_norm(x)
