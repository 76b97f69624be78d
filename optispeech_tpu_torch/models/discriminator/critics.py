"""Multi-period and multi-resolution discriminators (port of
`optispeech_tpu/models/discriminator/critics.py`).

MPD (HiFi-GAN: periods 2/3/5/7/11, weight-normed conv2d stacks over
(frame, period) views) and MRD (UnivNet: rectangular-window STFT magnitudes,
weight-normed conv2d stacks). Layout is NCHW; JAX's NHWC (B, H, W, C) maps
to (B, C, H, W), so the flattened scores keep JAX's order.

Weight norm is `torch.nn.utils.parametrizations.weight_norm(dim=0)`:
g (out, 1, 1, 1) and v (out, in, kh, kw), the norm over every axis but the
output channels, the axes flax's `nn.WeightNorm` norms over.
"""

import math

import torch
from torch import nn
from torch.nn import functional as F
from torch.nn.utils import parametrizations, parametrize

from ...ops.stft import stft_magnitude

LRELU_SLOPE = 0.1


def _leaky_relu(x):
    """JAX's leaky ReLU, `where(x >= 0, x, slope * x)`: its gradient at
    exactly 0 is 1, where F.leaky_relu's is the slope. Exact zeros occur:
    a zero stretch of the waveform (the padding past an utterance) through a
    zero bias."""
    return torch.where(x >= 0, x, x * LRELU_SLOPE)


def _wn_conv(in_ch, out_ch, kernel, stride, padding):
    return parametrizations.weight_norm(nn.Conv2d(in_ch, out_ch, kernel, stride, padding), dim=0)


def _weight_normed(module: nn.Module):
    return [m for m in module.modules() if parametrize.is_parametrized(m, "weight")]


@torch.no_grad()
def torch_weight_norm_init(module: nn.Module) -> None:
    """Set every weight-normed conv's g to ||v|| per output channel, so the
    effective kernel equals v, as `critics.py::torch_weight_norm_init` does
    for the flax scales."""
    for m in _weight_normed(module):
        g, v = m.parametrizations.weight.original0, m.parametrizations.weight.original1
        g.copy_(torch.linalg.vector_norm(v, dim=(1, 2, 3), keepdim=True))


@torch.no_grad()
def init_discriminator(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init with the JAX package's distributions: each kernel v
    uniform in +-1/sqrt(fan_in) (torch's Conv2d default, which the flax
    critics copy), zero biases, then g = ||v||."""
    for m in _weight_normed(module):
        v = m.parametrizations.weight.original1
        bound = 1.0 / math.sqrt(v[0].numel())
        v.uniform_(-bound, bound, generator=generator)
        nn.init.zeros_(m.bias)
    torch_weight_norm_init(module)


class DiscriminatorP(nn.Module):
    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        pad = (kernel_size // 2, 0)
        chans = [1, 32, 128, 512, 1024]
        self.convs = nn.ModuleList(
            [_wn_conv(chans[i], chans[i + 1], (kernel_size, 1), (stride, 1), pad)
             for i in range(4)]
            + [_wn_conv(1024, 1024, (kernel_size, 1), 1, pad)])
        self.conv_post = _wn_conv(1024, 1, (3, 1), 1, (1, 0))

    def forward(self, x):
        """x (B, T) -> (scores (B, frames*period), feature maps)."""
        b, t = x.shape
        if t % self.period:
            n_pad = self.period - t % self.period
            x = F.pad(x[:, None, :], (0, n_pad), mode="reflect")[:, 0]
            t += n_pad
        x = x.reshape(b, 1, t // self.period, self.period)
        fmap = []
        for i, conv in enumerate(self.convs):
            x = _leaky_relu(conv(x))
            if i > 0:
                fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


class DiscriminatorR(nn.Module):
    def __init__(self, resolution, channels: int = 64):
        super().__init__()
        self.resolution = tuple(resolution)  # (n_fft, hop, win_length)
        specs = [((7, 5), (2, 2), (3, 2)), ((5, 3), (2, 1), (2, 1)), ((5, 3), (2, 2), (2, 1)),
                 ((3, 3), (2, 1), (1, 1)), ((3, 3), (2, 2), (1, 1))]
        self.convs = nn.ModuleList(
            [_wn_conv(1 if i == 0 else channels, channels, k, s, p)
             for i, (k, s, p) in enumerate(specs)])
        self.conv_post = _wn_conv(channels, 1, (3, 3), 1, (1, 1))

    def forward(self, x):
        n_fft, hop, win = self.resolution
        mag = stft_magnitude(x, n_fft, hop, win, window="ones", center=True)
        x = mag.transpose(1, 2)[:, None]  # (B, 1, freq, frames)
        fmap = []
        for conv in self.convs:
            x = _leaky_relu(conv(x))
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap


class _MultiDiscriminator(nn.Module):
    def forward(self, y, y_hat):
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d in self.discriminators:
            s_r, f_r = d(y)
            s_g, f_g = d(y_hat)
            y_d_rs.append(s_r)
            y_d_gs.append(s_g)
            fmap_rs.append(f_r)
            fmap_gs.append(f_g)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


class MultiPeriodDiscriminator(_MultiDiscriminator):
    def __init__(self, periods=(2, 3, 5, 7, 11)):
        super().__init__()
        self.discriminators = nn.ModuleList([DiscriminatorP(p) for p in periods])


class MultiResolutionDiscriminator(_MultiDiscriminator):
    def __init__(self, resolutions=((1024, 256, 1024), (2048, 512, 2048), (512, 128, 512)),
                 channels: int = 64):
        super().__init__()
        self.discriminators = nn.ModuleList([DiscriminatorR(r, channels) for r in resolutions])
