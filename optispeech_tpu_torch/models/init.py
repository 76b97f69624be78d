"""Seeded random initialisation with flax's distributions.

The JAX package initialises with flax's defaults and a few explicit
initialisers; this walks a torch module tree and draws from the same
distributions (not the same numbers) with one `torch.Generator`:
- ConvNeXt block convs and denses, WaveNeXt head: truncated normal, std 0.02,
  cut at two standard deviations;
- the token table: normal, std dim**-0.5; the speaker/language tables:
  normal, std features**-0.5 (flax `Embed`);
- separable convs: normal, std sqrt(4 (1 - dropout) / (k * channels));
- every other conv and dense: lecun normal (flax's default kernel_init);
- biases zero, LayerNorm weight one; layer scale and the position scale keep
  the constants their modules set.
"""

import math

import torch
from torch import nn

from .modules.convnext import ConvNeXtBlock
from .modules.core import ConvSeparable, TextEmbedding
from .vocoder.wavenext import WaveNeXtHead

# std of a standard normal truncated to [-2, 2], which lecun normal divides by
_TRUNC_STD = 0.87962566103423978


def _trunc_normal(w, std, g):
    nn.init.trunc_normal_(w, mean=0.0, std=std, a=-2 * std, b=2 * std, generator=g)


def _lecun_normal(w, g):
    fan_in = w[0].numel()  # (out, in/groups, k) or (out, in)
    _trunc_normal(w, math.sqrt(1.0 / fan_in) / _TRUNC_STD, g)


@torch.no_grad()
def init_like_flax(module: nn.Module, g: torch.Generator) -> None:
    done = set()
    for m in module.modules():
        if isinstance(m, ConvNeXtBlock):
            explicit = [(m.dwconv, 0.02), (m.pwconv1, 0.02), (m.pwconv2, 0.02)]
        elif isinstance(m, WaveNeXtHead):
            explicit = [(m.linear_1, 0.02), (m.linear_2, 0.02)]
        else:
            explicit = []
        for layer, std in explicit:
            _trunc_normal(layer.weight, std, g)
            done.add(layer)
        if isinstance(m, ConvSeparable):
            for layer in (m.depthwise_conv, m.pointwise_conv):
                nn.init.normal_(layer.weight, 0.0, m.init_std, generator=g)
                done.add(layer)
        if isinstance(m, TextEmbedding):
            nn.init.normal_(m.embed_tokens.weight, 0.0, m.dim ** -0.5, generator=g)
            done.add(m.embed_tokens)
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Linear)):
            if m not in done:
                _lecun_normal(m.weight, g)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding) and m not in done:
            nn.init.normal_(m.weight, 0.0, m.weight.shape[1] ** -0.5, generator=g)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
