"""Conformer encoder backbone (`configs/conformer.yaml`).

Port of `optispeech_tpu/models/modules/conformer.py`: macaron FFNs (each
scaled by 0.5), Transformer-XL relative-position self-attention with
pos_bias_u / pos_bias_v and the relative shift, a conv module (pointwise,
GLU, depthwise k, norm, swish, pointwise), the input scaled by sqrt(dim),
a norm_final per block and an after_norm at the end. (B, T, C) in and out.
Submodule names follow the reference's (ESPnet's) torch keys:
`encoder.conformer.encoders.{i}.self_attn.pos_bias_u`,
`.feed_forward_macaron.w_1.weight`, `.conv_module.norm.weight`,
`encoder.conformer.after_norm.weight`.

The conv module's norm (`conv_norm`): "layernorm" (training from scratch;
flax's default epsilon, 1e-6) or "affine", the reference's BatchNorm1d with
its running statistics folded into a scale and a bias
(`compat/torch_import.py`), held as `conv_module.norm.weight` / `.bias`
either way. Neither the conv module's input nor the output's PAD frames
are zeroed, as in the reference.
"""

from typing import Optional

import torch
from torch import nn

from .core import Conv1d, LayerNorm, Linear, conv_btc, dropout, glu, sigmoid
from .transformer import ConvFFN, scaled_dot_attention, sinusoids


def rel_positional_encoding(t: int, dim: int, device=None) -> torch.Tensor:
    """(2t - 1, dim) positions t-1 down to -(t-1), float32 (computed in
    float64, as the JAX package's numpy table is)."""
    return sinusoids(torch.arange(t - 1, -t, -1, dtype=torch.float64, device=device), dim)


def _rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 2T-1) -> (B, H, T, T), out[q, k] = x[q, T-1 - (q-k)]: the
    Transformer-XL pad-and-reshape."""
    b, h, t, _ = x.shape
    x = nn.functional.pad(x, (1, 0))  # (B, H, T, 2T)
    x = x.reshape(b, h, 2 * t, t)[:, :, 1:, :].reshape(b, h, t, 2 * t - 1)
    return x[..., :t]


class RelPosSelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        d_k = dim // num_heads
        self.linear_q = Linear(dim, dim, dtype=dtype)
        self.linear_k = Linear(dim, dim, dtype=dtype)
        self.linear_v = Linear(dim, dim, dtype=dtype)
        self.linear_out = Linear(dim, dim, dtype=dtype)
        self.linear_pos = Linear(dim, dim, bias=False, dtype=dtype)
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, d_k))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, d_k))

    def forward(self, x, pos_emb, padding_mask=None, generator: Optional[torch.Generator] = None):
        b, t, _ = x.shape
        h = self.num_heads
        q, k, v = (lin(x).reshape(b, t, h, -1)
                   for lin in (self.linear_q, self.linear_k, self.linear_v))
        p = self.linear_pos(pos_emb).reshape(2 * t - 1, h, -1).permute(1, 2, 0)  # (H, d, 2T-1)
        # the biases are added before the heads' transpose, as in JAX
        q_u = (q + self.pos_bias_u.to(x.dtype)).transpose(1, 2)
        q_v = (q + self.pos_bias_v.to(x.dtype)).transpose(1, 2)
        out = scaled_dot_attention(q_u, k.transpose(1, 2), v.transpose(1, 2),
                                   _rel_shift(q_v @ p), padding_mask, self.dropout,
                                   self.training, generator)
        return self.linear_out(out)


class Affine(nn.Module):
    """x * weight + bias: the reference's BatchNorm1d frozen at its running
    statistics, folded into the two."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return x * self.weight.to(x.dtype) + self.bias.to(x.dtype)


class ConvModule(nn.Module):
    """pointwise x2 -> GLU -> depthwise k -> norm -> swish -> pointwise."""

    def __init__(self, dim: int, kernel_size: int = 7, norm_kind: str = "layernorm",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pointwise_conv1 = Conv1d(dim, 2 * dim, 1, dtype=dtype)
        self.depthwise_conv = Conv1d(dim, dim, kernel_size, padding=(kernel_size - 1) // 2,
                                     groups=dim, dtype=dtype)
        if norm_kind == "layernorm":
            self.norm = LayerNorm(dim, 1e-6, dtype)
        elif norm_kind == "affine":
            self.norm = Affine(dim)
        else:
            raise ValueError(f"unknown conv_norm {norm_kind}")
        self.pointwise_conv2 = Conv1d(dim, dim, 1, dtype=dtype)

    def forward(self, x):
        y = glu(conv_btc(self.pointwise_conv1, x))
        y = self.norm(conv_btc(self.depthwise_conv, y))
        y = y * sigmoid(y)  # flax nn.swish
        return conv_btc(self.pointwise_conv2, y)


class ConformerLayer(nn.Module):
    def __init__(self, dim: int, attention_heads: int, linear_units: int, dropout_rate: float,
                 attention_dropout_rate: float, cnn_module_kernel: int, conv_norm: str,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout_rate
        self.self_attn = RelPosSelfAttention(dim, attention_heads, attention_dropout_rate, dtype)
        self.feed_forward = ConvFFN(dim, linear_units, 1, dropout_rate, dtype)
        self.feed_forward_macaron = ConvFFN(dim, linear_units, 1, dropout_rate, dtype)
        self.conv_module = ConvModule(dim, cnn_module_kernel, conv_norm, dtype)
        for name in ("norm_ff", "norm_mha", "norm_ff_macaron", "norm_conv", "norm_final"):
            setattr(self, name, LayerNorm(dim, 1e-12, dtype))

    def forward(self, x, pos_emb, padding_mask, generator):
        drop = lambda y: dropout(y, self.dropout, self.training, generator)  # noqa: E731
        x = x + 0.5 * drop(self.feed_forward_macaron(self.norm_ff_macaron(x), generator))
        x = x + drop(self.self_attn(self.norm_mha(x), pos_emb, padding_mask, generator))
        x = x + drop(self.conv_module(self.norm_conv(x)))
        x = x + 0.5 * drop(self.feed_forward(self.norm_ff(x), generator))
        return self.norm_final(x)


class ConformerEncoder(nn.Module):
    """The reference's `conformer` submodule: blocks and after_norm."""

    def __init__(self, dim: int, attention_heads: int, linear_units: int, num_blocks: int,
                 dropout_rate: float, positional_dropout_rate: float,
                 attention_dropout_rate: float, cnn_module_kernel: int, conv_norm: str,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.positional_dropout = positional_dropout_rate
        self.encoders = nn.ModuleList([
            ConformerLayer(dim, attention_heads, linear_units, dropout_rate,
                           attention_dropout_rate, cnn_module_kernel, conv_norm, dtype)
            for _ in range(num_blocks)])
        self.after_norm = LayerNorm(dim, 1e-12, dtype)

    def forward(self, x, padding_mask, generator):
        # the input scaled by sqrt(dim) (in x's dtype), and the relative
        # positions shared by every block, each with its own dropout
        x = x * torch.sqrt(torch.tensor(float(self.dim), dtype=x.dtype))
        x = dropout(x, self.positional_dropout, self.training, generator)
        pos_emb = rel_positional_encoding(x.shape[1], self.dim, x.device).to(x.dtype)
        pos_emb = dropout(pos_emb, self.positional_dropout, self.training, generator)
        for layer in self.encoders:
            x = layer(x, pos_emb, padding_mask, generator)
        return self.after_norm(x)


class ConformerBackbone(nn.Module):
    def __init__(self, dim: int, attention_heads: int = 2, linear_units: int = 1024,
                 num_blocks: int = 4, dropout_rate: float = 0.2,
                 positional_dropout_rate: float = 0.2, attention_dropout_rate: float = 0.2,
                 cnn_module_kernel: int = 7, conv_norm: str = "layernorm",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conformer = ConformerEncoder(dim, attention_heads, linear_units, num_blocks,
                                          dropout_rate, positional_dropout_rate,
                                          attention_dropout_rate, cnn_module_kernel, conv_norm,
                                          dtype)

    def forward(self, x, padding_mask=None, generator: Optional[torch.Generator] = None):
        return self.conformer(x, padding_mask, generator)
