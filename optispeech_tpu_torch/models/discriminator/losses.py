"""GAN and spectral reconstruction losses (port of
`optispeech_tpu/models/discriminator/losses.py`): hinge losses, feature
matching, mel L1 (torchaudio htk mel, power 1, log clip 1e-7) and
multi-resolution STFT (spectral convergence + log-magnitude L1, magnitudes
clamped at sqrt(1e-7)). The spectral math runs in float32.

Under data parallelism (`mesh`) the spectral convergence, a ratio of two
norms over the whole batch, is each rank's share of the global ratio
(`_global_norm_ratio`); the means are the callers' to divide by the world
size (`vocos.py`)."""

import math

import torch

from ...ops.audio import safe_log
from ...ops.stft import mel_filterbank, stft_magnitude
from ...parallel.mesh import all_reduce_sum, data_size, mean_share


def generator_adv_loss(disc_outputs):
    losses = [torch.clamp(1.0 - dg, min=0.0).mean() for dg in disc_outputs]
    return sum(losses), losses


def discriminator_adv_loss(real_outputs, generated_outputs):
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(real_outputs, generated_outputs):
        r = torch.clamp(1.0 - dr, min=0.0).mean()
        g = torch.clamp(1.0 + dg, min=0.0).mean()
        loss = loss + r + g
        r_losses.append(r)
        g_losses.append(g)
    return loss, r_losses, g_losses


def feature_matching_loss(fmap_r, fmap_g):
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.abs(rl - gl).mean()
    return loss


def mel_spec_reconstruction_loss(y_hat, y, sample_rate, n_fft, hop_length, win_length, n_mels,
                                 f_min, f_max, clip_val: float = 1e-7):
    fb = mel_filterbank(sample_rate, n_fft, n_mels, f_min, f_max, htk=True, norm=None,
                        device=y.device)

    def logmel(w):
        mag = stft_magnitude(w.float(), n_fft, hop_length, win_length, window="hann", center=True)
        return safe_log(mag @ fb.T, clip_val)

    return torch.abs(logmel(y) - logmel(y_hat)).mean()


def _stft_mag(x, fft_size, hop, win_length):
    return torch.clamp(stft_magnitude(x.float(), fft_size, hop, win_length, window="hann",
                                      center=True), min=math.sqrt(1e-7))


def _global_norm_ratio(num_sq, den_sq, mesh):
    """This rank's share of sqrt(N) / sqrt(D), where N and D are `num_sq`
    and `den_sq` summed over the data-parallel ranks: its value is the
    ratio over the world size, and its gradient, summed over the ranks, is
    the gradient of the ratio (the chain rule through N and D, with the
    all-reduced sums held as constants)."""
    total = all_reduce_sum(torch.stack([num_sq, den_sq]).detach(), mesh)
    n, d = total[0], total[1]
    ratio = torch.sqrt(n) / torch.sqrt(d)
    tiny = torch.finfo(ratio.dtype).tiny
    return (ratio / data_size(mesh)
            + (num_sq - num_sq.detach()) * (ratio / torch.clamp(2 * n, min=tiny))
            - (den_sq - den_sq.detach()) * (ratio / torch.clamp(2 * d, min=tiny)))


def stft_loss(x, y, fft_size, hop, win_length, mesh=None):
    """(spectral convergence, log-magnitude L1); with a `mesh`, this rank's
    shares of the global batch's."""
    x_mag = _stft_mag(x, fft_size, hop, win_length)
    y_mag = _stft_mag(y, fft_size, hop, win_length)
    mag = mean_share(torch.abs(torch.log(y_mag) - torch.log(x_mag)).mean(), mesh)
    if data_size(mesh) == 1:
        sc = torch.linalg.vector_norm(y_mag - x_mag) / torch.linalg.vector_norm(y_mag)
    else:
        sc = _global_norm_ratio(torch.sum((y_mag - x_mag) ** 2), torch.sum(y_mag ** 2), mesh)
    return sc, mag


def multi_resolution_stft_loss(x, y, fft_sizes=(1024, 2048, 512), hop_sizes=(120, 240, 50),
                               win_lengths=(600, 1200, 240), mesh=None):
    sc_loss, mag_loss = 0.0, 0.0
    for fs, ss, wl in zip(fft_sizes, hop_sizes, win_lengths):
        sc, mag = stft_loss(x, y, fs, ss, wl, mesh)
        sc_loss = sc_loss + sc
        mag_loss = mag_loss + mag
    n = len(fft_sizes)
    return sc_loss / n, mag_loss / n
