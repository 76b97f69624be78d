"""Text embedding and variance (duration/pitch/energy) predictors.

Port of `optispeech_tpu/models/modules/core.py`. Modules take and return
(B, T, C) and a (B, T) bool padding mask (True = PAD); the NCW transposes
around the convolutions stay inside. Submodule names follow the reference's
torch state-dict keys (`duration_predictor.conv.{i}.0.weight`,
`pitch_predictor.embed.0.weight`).

Dropout runs only in training mode (`module.train()`), drawing from the
`torch.Generator` the caller passes, as flax draws from the "dropout" RNG.

`dtype` is flax's `dtype=`: the compute dtype, float32 or bfloat16. The
parameters stay float32 (flax's `param_dtype`) and are cast where they are
used, so the state dict and the optimiser state are the same in both. The
layers below (`Linear`, `Conv1d`, `LayerNorm`, `Embedding`, `gelu`) run in
float32 as the torch modules do, and in bfloat16 in flax's order.
"""

import math

import torch
from torch import nn
from torch.nn import functional as F

DEFAULT_MAX_SOURCE_POSITIONS = 2000


def _check_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {dtype}: float32 or bfloat16")
    return dtype


class Linear(nn.Linear):
    """`nn.Dense(dtype=)`: in bfloat16 the product of the bf16 operands is
    rounded to bf16 before the bias, cast to bf16, is added (a bias fused
    into the product would round once where flax rounds twice)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = _check_dtype(dtype)

    def forward(self, x):
        if self.compute_dtype == torch.float32:
            return super().forward(x)
        y = F.linear(x.to(self.compute_dtype), self.weight.to(self.compute_dtype))
        return y if self.bias is None else y + self.bias.to(self.compute_dtype)


class Conv1d(nn.Conv1d):
    """`nn.Conv(dtype=)`, NCW: in bfloat16 the convolution of the bf16
    operands is rounded, then the bias is added in bf16."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, padding: int = 0,
                 groups: int = 1, bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, padding=padding, groups=groups,
                         bias=bias)
        self.compute_dtype = _check_dtype(dtype)

    def forward(self, x):
        if self.compute_dtype == torch.float32:
            return super().forward(x)
        cd = self.compute_dtype
        y = F.conv1d(x.to(cd), self.weight.to(cd), None, self.stride, self.padding,
                     self.dilation, self.groups)
        return y if self.bias is None else y + self.bias.to(cd)[:, None]


class LayerNorm(nn.LayerNorm):
    """`nn.LayerNorm(dtype=)`: in bfloat16 the statistics and the affine
    step run in float32 and the output is rounded to bf16."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = _check_dtype(dtype)

    def forward(self, x):
        if self.compute_dtype == torch.float32:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(self.compute_dtype)


class Embedding(nn.Embedding):
    """`nn.Embed(dtype=)`: the looked-up rows in the compute dtype."""

    def __init__(self, num_embeddings: int, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(num_embeddings, dim)
        self.compute_dtype = _check_dtype(dtype)

    def forward(self, idx):
        return super().forward(idx).to(self.compute_dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax `nn.gelu(approximate=False)`: torch's exact GELU in float32; in
    bfloat16 the form JAX lowers it to, `(0.5 x) erfc(-x * bf16(1/sqrt 2))`,
    every step rounded to bf16 (torch's bf16 GELU rounds once, at the end)."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="none")
    return (0.5 * x) * torch.erfc(-x * 0.70703125)


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
                 max_source_positions: int = DEFAULT_MAX_SOURCE_POSITIONS, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.padding_idx = padding_idx
        self.dropout = dropout
        self.embed_tokens = Embedding(n_vocab, dim, dtype)
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

    def __init__(self, in_channels: int, channels: int, kernel_size: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.init_std = math.sqrt((4 * (1.0 - dropout)) / (kernel_size * channels))
        self.depthwise_conv = Conv1d(in_channels, in_channels, kernel_size,
                                     padding=(kernel_size - 1) // 2, groups=in_channels,
                                     bias=False, dtype=dtype)
        self.pointwise_conv = Conv1d(in_channels, channels, 1, dtype=dtype)

    def forward(self, x):
        return self.pointwise_conv(self.depthwise_conv(x))


def _conv(in_channels, channels, kernel_size, separable, dropout=0.0, dtype=torch.float32):
    if separable:
        return ConvSeparable(in_channels, channels, kernel_size, dropout=dropout, dtype=dtype)
    return Conv1d(in_channels, channels, kernel_size, padding=(kernel_size - 1) // 2,
                  dtype=dtype)


class VariancePredictor(nn.Module):
    """[conv -> ReLU -> LayerNorm(eps 1e-12) -> dropout] x N -> linear ->
    (B, T), zero on PAD."""

    def __init__(self, dim: int, num_layers: int = 2, intermediate_dim: int = 384,
                 kernel_size: int = 3, dropout: float = 0.1, separable: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.conv = nn.ModuleList()
        for i in range(num_layers):
            in_ch = dim if i == 0 else intermediate_dim
            # (conv, ReLU, LayerNorm): the reference's Sequential indices
            # (its Dropout came last), so its keys conv.{i}.0 / conv.{i}.2 match
            self.conv.append(nn.Sequential(
                _conv(in_ch, intermediate_dim, kernel_size, separable, dropout, dtype),
                nn.ReLU(), LayerNorm(intermediate_dim, 1e-12, dtype),
            ))
        self.linear = Linear(intermediate_dim, 1, dtype=dtype)

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
        # exp and the clip in the compute dtype (exp of a bf16 log-duration
        # taken in float32 would move some ceilings); the product with the
        # factor in float32, as in JAX's synthesis, whose factor is a float32
        # array (the same in bf16 at a power-of-two factor)
        durations = torch.exp(self(x, padding_mask)) - self.clip_val
        durations = torch.ceil(durations.float() * factor)
        durations = torch.clamp(durations, min=0.0)
        return durations.masked_fill(padding_mask, 0.0).to(torch.int32)


class PitchPredictor(nn.Module):
    """Variance predictor + a value-embedding conv added back into the hidden
    stream: teacher-forced in training (`forward` embeds the target), the
    scaled prediction at inference (`infer`)."""

    def __init__(self, dim: int, num_layers: int = 5, intermediate_dim: int = 256,
                 kernel_size: int = 5, dropout: float = 0.5, embed_kernel_size: int = 9,
                 separable: bool = False, embed_dropout: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dropout = embed_dropout
        self.predictor = VariancePredictor(dim, num_layers, intermediate_dim, kernel_size,
                                           dropout, separable, dtype)
        # a Sequential for the reference's key embed.0 (its Dropout came next)
        self.embed = nn.Sequential(_conv(1, dim, embed_kernel_size, separable, dtype=dtype))

    def _add_embedding(self, x, values, padding_mask, generator=None):
        emb = self.embed[0](values[:, None, :].to(x.dtype)).transpose(1, 2)
        emb = dropout(emb, self.embed_dropout, self.training, generator)
        return (x + emb) * (~padding_mask)[..., None].to(x.dtype)

    def forward(self, x, padding_mask, target, generator: torch.Generator | None = None):
        preds = self.predictor(x, padding_mask, generator)
        return self._add_embedding(x, target, padding_mask, generator), preds

    def infer(self, x, padding_mask, factor: float = 1.0):
        # float32 predictions, as JAX's synthesis gives (its factor is a
        # float32 array); the embedding takes them in the compute dtype
        preds = self.predictor(x, padding_mask).float() * factor
        return self._add_embedding(x, preds, padding_mask), preds


class EnergyPredictor(PitchPredictor):
    """Identical structure to the pitch predictor."""
