"""A reference file for the tests: the plain reference's generator with a
HiFi-GAN-like vocoder in place of WaveNeXt (transposed convolutions, then
residual blocks of dilated convolutions), as a configuration whose vocoder
`reference/generator.py` lacks would name one with `"reference": "<file>"`.

It lives under `tests/reference/`, a second portion of the `reference`
namespace package that only the tests put on the import path.
"""

import math

import torch
from torch import nn
from torch.nn import functional as F

from reference import generator

SLOPE = 0.1  # LeakyReLU's


class ResBlock(nn.Module):
    """x + conv(lrelu(dilated conv(lrelu(x)))) for each dilation."""

    weight_init = ("normal", 0.01)  # HiFi-GAN's published init

    def __init__(self, ch, kernel, dilations):
        super().__init__()
        self.convs1 = nn.ModuleList([nn.Conv1d(ch, ch, kernel, dilation=d,
                                               padding=d * (kernel - 1) // 2) for d in dilations])
        self.convs2 = nn.ModuleList([nn.Conv1d(ch, ch, kernel, padding=(kernel - 1) // 2)
                                     for _ in dilations])

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(F.leaky_relu(c1(F.leaky_relu(x, SLOPE)), SLOPE))
        return x


class HiFiGAN(nn.Module):
    def __init__(self, in_dim, cfg, hop):
        super().__init__()
        rates, kernels = cfg["upsample_rates"], cfg["upsample_kernel_sizes"]
        if math.prod(rates) != hop:
            raise ValueError(f"upsample rates {rates} do not make the hop {hop}")
        ch = cfg["upsample_initial_channel"]
        self.n_kernels = len(cfg["resblock_kernel_sizes"])
        self.conv_pre = nn.Conv1d(in_dim, ch, 7, padding=3)
        self.ups, self.resblocks = nn.ModuleList(), nn.ModuleList()
        for i, (u, k) in enumerate(zip(rates, kernels)):
            self.ups.append(nn.ConvTranspose1d(ch >> i, ch >> (i + 1), k, u, padding=(k - u) // 2))
            self.resblocks.extend(ResBlock(ch >> (i + 1), rk, rd) for rk, rd in
                                  zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]))
        self.conv_post = nn.Conv1d(ch >> len(rates), 1, 7, padding=3)

    def forward(self, x, padding_mask):
        x = self.conv_pre((x * (~padding_mask)[..., None].float()).transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, SLOPE))
            blocks = self.resblocks[i * self.n_kernels:(i + 1) * self.n_kernels]
            x = sum(block(x) for block in blocks) / self.n_kernels
        return torch.tanh(self.conv_post(F.leaky_relu(x))).flatten(1)


class Generator(generator.Generator):
    def make_vocoder(self, g):
        return HiFiGAN(g["dim"], g["vocoder"], self.hop)
