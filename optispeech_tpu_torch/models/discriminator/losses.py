"""GAN and spectral reconstruction losses (port of
`optispeech_tpu/models/discriminator/losses.py`): hinge losses, feature
matching, mel L1 (torchaudio htk mel, power 1, log clip 1e-7) and
multi-resolution STFT (spectral convergence + log-magnitude L1, magnitudes
clamped at sqrt(1e-7)). The spectral math runs in float32."""

import math

import torch

from ...ops.audio import safe_log
from ...ops.stft import mel_filterbank, stft_magnitude


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


def stft_loss(x, y, fft_size, hop, win_length):
    """(spectral convergence, log-magnitude L1)."""
    x_mag = _stft_mag(x, fft_size, hop, win_length)
    y_mag = _stft_mag(y, fft_size, hop, win_length)
    sc = torch.linalg.vector_norm(y_mag - x_mag) / torch.linalg.vector_norm(y_mag)
    mag = torch.abs(torch.log(y_mag) - torch.log(x_mag)).mean()
    return sc, mag


def multi_resolution_stft_loss(x, y, fft_sizes=(1024, 2048, 512), hop_sizes=(120, 240, 50),
                               win_lengths=(600, 1200, 240)):
    sc_loss, mag_loss = 0.0, 0.0
    for fs, ss, wl in zip(fft_sizes, hop_sizes, win_lengths):
        sc, mag = stft_loss(x, y, fs, ss, wl)
        sc_loss = sc_loss + sc
        mag_loss = mag_loss + mag
    n = len(fft_sizes)
    return sc_loss / n, mag_loss / n
