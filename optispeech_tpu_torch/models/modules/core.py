"""Text embedding and variance (duration/pitch/energy) predictors.

Port of `optispeech_tpu/models/modules/core.py`. Modules take and return
(B, T, C) and a (B, T) bool padding mask (True = PAD); the NCW transposes
around the convolutions stay inside. Submodule names follow the reference's
torch state-dict keys (`duration_predictor.conv.{i}.0.weight`,
`pitch_predictor.embed.0.weight`).

Dropout runs only in training mode (`module.train()`), drawing from the
`torch.Generator` the caller passes, as flax draws from the "dropout" RNG.
"""

import math

import torch
from torch import nn

DEFAULT_MAX_SOURCE_POSITIONS = 2000


def conv_btc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCW conv module to a (B, T, C) tensor."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax `nn.Dropout`: keep each element with probability 1 - rate and
    scale it by 1 / (1 - rate); the identity outside training or at rate 0."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class ScaledSinusoidalEmbedding(nn.Module):
    """Sinusoidal positions with a learnable scalar scale."""

    def __init__(self, dim: int, theta: float = 10000.0):
        super().__init__()
        self.dim = dim
        self.theta = theta
        self.scale = nn.Parameter(torch.full((1,), dim ** -0.5))

    def forward(self, seq_len: int) -> torch.Tensor:
        half = self.dim // 2
        device = self.scale.device
        freq_seq = torch.arange(half, dtype=torch.float32, device=device) / half
        inv_freq = torch.pow(torch.tensor(self.theta, dtype=torch.float32, device=device), -freq_seq)
        pos = torch.arange(seq_len, dtype=torch.float32, device=device)
        emb = pos[:, None] * inv_freq[None, :]
        return torch.cat([emb.sin(), emb.cos()], dim=-1) * self.scale


class TextEmbedding(nn.Module):
    """sqrt(dim)-scaled token embedding + scaled sinusoidal positions.

    The PAD row is zeroed where it is used, by a multiply, as in the JAX
    module: the table's row `padding_idx` holds whatever the weights say."""

    def __init__(self, dim: int, n_vocab: int = 250, padding_idx: int = 0,
                 max_source_positions: int = DEFAULT_MAX_SOURCE_POSITIONS, dropout: float = 0.0):
        super().__init__()
        self.dim = dim
        self.padding_idx = padding_idx
        self.dropout = dropout
        self.embed_tokens = nn.Embedding(n_vocab, dim)
        self.embed_positions = ScaledSinusoidalEmbedding(dim, theta=max_source_positions)

    def forward(self, src_tokens: torch.Tensor, generator: torch.Generator | None = None):
        emb = self.embed_tokens(src_tokens)
        emb = emb * (src_tokens != self.padding_idx)[..., None].to(emb.dtype)
        embed = math.sqrt(self.dim) * emb
        x = embed + self.embed_positions(src_tokens.shape[1])[None, :, :].to(embed.dtype)
        return dropout(x, self.dropout, self.training, generator), embed


class ConvSeparable(nn.Module):
    """Depthwise + pointwise 1-D conv (the `light` variants' predictors).
    NCW in and out, like the torch convs it stands in for."""

    def __init__(self, in_channels: int, channels: int, kernel_size: int, dropout: float = 0.0):
        super().__init__()
        self.init_std = math.sqrt((4 * (1.0 - dropout)) / (kernel_size * channels))
        self.depthwise_conv = nn.Conv1d(in_channels, in_channels, kernel_size,
                                        padding=(kernel_size - 1) // 2, groups=in_channels,
                                        bias=False)
        self.pointwise_conv = nn.Conv1d(in_channels, channels, 1)

    def forward(self, x):
        return self.pointwise_conv(self.depthwise_conv(x))


def _conv(in_channels, channels, kernel_size, separable, dropout=0.0):
    if separable:
        return ConvSeparable(in_channels, channels, kernel_size, dropout=dropout)
    return nn.Conv1d(in_channels, channels, kernel_size, padding=(kernel_size - 1) // 2)


class VariancePredictor(nn.Module):
    """[conv -> ReLU -> LayerNorm(eps 1e-12) -> dropout] x N -> linear ->
    (B, T), zero on PAD."""

    def __init__(self, dim: int, num_layers: int = 2, intermediate_dim: int = 384,
                 kernel_size: int = 3, dropout: float = 0.1, separable: bool = False):
        super().__init__()
        self.dropout = dropout
        self.conv = nn.ModuleList()
        for i in range(num_layers):
            in_ch = dim if i == 0 else intermediate_dim
            # (conv, ReLU, LayerNorm): the reference's Sequential indices
            # (its Dropout came last), so its keys conv.{i}.0 / conv.{i}.2 match
            self.conv.append(nn.Sequential(
                _conv(in_ch, intermediate_dim, kernel_size, separable, dropout),
                nn.ReLU(), nn.LayerNorm(intermediate_dim, eps=1e-12),
            ))
        self.linear = nn.Linear(intermediate_dim, 1)

    def forward(self, x, padding_mask, generator: torch.Generator | None = None):
        for conv, relu, norm in self.conv:
            x = dropout(norm(relu(conv_btc(conv, x))), self.dropout, self.training, generator)
        x = self.linear(x)[..., 0]
        return x.masked_fill(padding_mask, 0.0)


class DurationPredictor(VariancePredictor):
    """Log-duration predictor (its forward, in training); `infer` gives
    integer frame counts."""

    clip_val = 1e-8

    def infer(self, x, padding_mask, factor: float = 1.0):
        durations = torch.exp(self(x, padding_mask)) - self.clip_val
        durations = torch.ceil(durations * factor)
        durations = torch.clamp(durations, min=0.0)
        return durations.masked_fill(padding_mask, 0.0).to(torch.int32)


class PitchPredictor(nn.Module):
    """Variance predictor + a value-embedding conv added back into the hidden
    stream: teacher-forced in training (`forward` embeds the target), the
    scaled prediction at inference (`infer`)."""

    def __init__(self, dim: int, num_layers: int = 5, intermediate_dim: int = 256,
                 kernel_size: int = 5, dropout: float = 0.5, embed_kernel_size: int = 9,
                 separable: bool = False, embed_dropout: float = 0.2):
        super().__init__()
        self.embed_dropout = embed_dropout
        self.predictor = VariancePredictor(dim, num_layers, intermediate_dim, kernel_size,
                                           dropout, separable)
        # a Sequential for the reference's key embed.0 (its Dropout came next)
        self.embed = nn.Sequential(_conv(1, dim, embed_kernel_size, separable))

    def _add_embedding(self, x, values, padding_mask, generator=None):
        emb = self.embed[0](values[:, None, :].to(x.dtype)).transpose(1, 2)
        emb = dropout(emb, self.embed_dropout, self.training, generator)
        return (x + emb) * (~padding_mask)[..., None].to(x.dtype)

    def forward(self, x, padding_mask, target, generator: torch.Generator | None = None):
        preds = self.predictor(x, padding_mask, generator)
        return self._add_embedding(x, target, padding_mask, generator), preds

    def infer(self, x, padding_mask, factor: float = 1.0):
        preds = self.predictor(x, padding_mask) * factor
        return self._add_embedding(x, preds, padding_mask), preds


class EnergyPredictor(PitchPredictor):
    """Identical structure to the pitch predictor."""
