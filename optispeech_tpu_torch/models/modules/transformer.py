"""FastSpeech2-style Transformer encoder backbone (`configs/transformer.yaml`).

Port of `optispeech_tpu/models/modules/transformer.py`: pre-norm multi-head
self-attention blocks, a positionwise conv1d FFN, and sinusoidal positions
scaled by a learnable alpha. (B, T, C) in and out, a (B, T) bool padding
mask (True = PAD). Submodule names follow the reference's (ESPnet's) torch
keys: `encoder.transformer.embed.0.alpha`,
`encoder.transformer.encoders.{i}.self_attn.linear_q.weight`,
`.feed_forward.w_1.weight`, `.norm1.weight`, `encoder.transformer.after_norm`.

Attention is plain tensor operations in JAX's order (einsum, padded keys
set to -1e9, softmax), not `scaled_dot_product_attention`, whose masking
and rounding differ. LayerNorm eps is 1e-12 throughout. The output's PAD
frames are not zeroed: the reference returns them as they are, and the
variance predictors' convolutions read them.
"""

import math
from typing import Optional

import torch
from torch import nn

from .core import Conv1d, LayerNorm, Linear, conv_btc, dropout, softmax


def sinusoidal_encoding(length: int, dim: int, device=None) -> torch.Tensor:
    """The standard transformer positions (length, dim), float32. Computed
    in float64 and rounded, as the JAX package's numpy table is (numpy
    promotes its float32 positions by the float64 frequency scale)."""
    return sinusoids(torch.arange(length, dtype=torch.float64, device=device), dim)


def sinusoids(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """sin / cos of float64 positions `pos` interleaved over `dim`, float32."""
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float64, device=pos.device)
                    * -(math.log(10000.0) / dim))
    angles = pos[:, None] * div[None, :]
    pe = torch.stack([angles.sin(), angles.cos()], dim=-1).reshape(len(pos), dim)
    return pe.float()


def scaled_dot_attention(q, k, v, scores_extra, padding_mask, rate, training, generator):
    """softmax((q k^T + extra) / sqrt(d)) v over (B, H, T, d) heads, padded
    keys at -1e9, dropout on the weights; returns (B, T, H * d)."""
    b, h, t, d_k = q.shape
    scores = q @ k.transpose(-1, -2)
    if scores_extra is not None:
        scores = scores + scores_extra
    scores = scores / torch.tensor(math.sqrt(d_k), dtype=scores.dtype)
    if padding_mask is not None:
        scores = scores.masked_fill(padding_mask[:, None, None, :], -1e9)
    attn = dropout(softmax(scores), rate, training, generator)
    return (attn @ v).transpose(1, 2).reshape(b, t, h * d_k)


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.linear_q = Linear(dim, dim, dtype=dtype)
        self.linear_k = Linear(dim, dim, dtype=dtype)
        self.linear_v = Linear(dim, dim, dtype=dtype)
        self.linear_out = Linear(dim, dim, dtype=dtype)

    def forward(self, x, padding_mask=None, generator: Optional[torch.Generator] = None):
        b, t, c = x.shape
        heads = lambda y: y.reshape(b, t, self.num_heads, -1).transpose(1, 2)  # noqa: E731
        out = scaled_dot_attention(heads(self.linear_q(x)), heads(self.linear_k(x)),
                                   heads(self.linear_v(x)), None, padding_mask, self.dropout,
                                   self.training, generator)
        return self.linear_out(out)


class ConvFFN(nn.Module):
    """Positionwise conv1d FFN: w_1 -> ReLU -> dropout -> w_2."""

    def __init__(self, dim: int, linear_units: int, kernel_size: int = 1, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        pad = (kernel_size - 1) // 2
        self.w_1 = Conv1d(dim, linear_units, kernel_size, padding=pad, dtype=dtype)
        self.w_2 = Conv1d(linear_units, dim, kernel_size, padding=pad, dtype=dtype)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        h = dropout(torch.relu(conv_btc(self.w_1, x)), self.dropout, self.training, generator)
        return conv_btc(self.w_2, h)


class ScaledPositionalEncoding(nn.Module):
    """x + alpha * positions (ESPnet's ScaledPositionalEncoding; its alpha is
    a 0-d parameter, 1 at init)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.alpha = nn.Parameter(torch.tensor(1.0))

    def forward(self, x):
        pe = sinusoidal_encoding(x.shape[1], self.dim, x.device).to(x.dtype)
        return x + self.alpha.to(x.dtype) * pe[None]


class EncoderLayer(nn.Module):
    """Pre-norm block: x + attn(LN(x)), then x + FFN(LN(x))."""

    def __init__(self, dim: int, attention_heads: int, linear_units: int, dropout_rate: float,
                 attention_dropout_rate: float, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout_rate
        self.self_attn = MultiHeadSelfAttention(dim, attention_heads, attention_dropout_rate,
                                                dtype)
        self.feed_forward = ConvFFN(dim, linear_units, 1, dropout_rate, dtype)
        self.norm1 = LayerNorm(dim, 1e-12, dtype)
        self.norm2 = LayerNorm(dim, 1e-12, dtype)

    def forward(self, x, padding_mask, generator):
        drop = lambda y: dropout(y, self.dropout, self.training, generator)  # noqa: E731
        x = x + drop(self.self_attn(self.norm1(x), padding_mask, generator))
        return x + drop(self.feed_forward(self.norm2(x), generator))


class TransformerEncoder(nn.Module):
    """The reference's `transformer` submodule: positions, blocks, after_norm."""

    def __init__(self, dim: int, attention_heads: int, linear_units: int, num_blocks: int,
                 dropout_rate: float, positional_dropout_rate: float,
                 attention_dropout_rate: float, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.positional_dropout = positional_dropout_rate
        # a Sequential for the reference's key embed.0.alpha
        self.embed = nn.Sequential(ScaledPositionalEncoding(dim))
        self.encoders = nn.ModuleList([
            EncoderLayer(dim, attention_heads, linear_units, dropout_rate,
                         attention_dropout_rate, dtype) for _ in range(num_blocks)])
        self.after_norm = LayerNorm(dim, 1e-12, dtype)

    def forward(self, x, padding_mask, generator):
        x = dropout(self.embed[0](x), self.positional_dropout, self.training, generator)
        for layer in self.encoders:
            x = layer(x, padding_mask, generator)
        return self.after_norm(x)


class TransformerBackbone(nn.Module):
    def __init__(self, dim: int, attention_heads: int = 2, linear_units: int = 1024,
                 num_blocks: int = 4, dropout_rate: float = 0.2,
                 positional_dropout_rate: float = 0.2, attention_dropout_rate: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.transformer = TransformerEncoder(dim, attention_heads, linear_units, num_blocks,
                                              dropout_rate, positional_dropout_rate,
                                              attention_dropout_rate, dtype)

    def forward(self, x, padding_mask=None, generator: Optional[torch.Generator] = None):
        return self.transformer(x, padding_mask, generator)
