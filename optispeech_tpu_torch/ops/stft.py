"""STFT magnitudes and mel filterbanks (port of `optispeech_tpu/ops/stft.py`).

The JAX conventions, kept exactly: centre padding by reflection of
n_fft // 2 on both sides, frames of n_fft every hop samples, a window of
win_length centred in n_fft (periodic Hann by default), and the onesided DFT
as one float32 product against cos/sin bases, as in JAX's `method="matmul"`.
Layout is frame-major: (..., n_frames, n_fft // 2 + 1). The mel banks are
the numpy code of the JAX module (librosa slaney and htk variants).
"""

from functools import lru_cache

import numpy as np
import torch

from .audio import dynamic_range_compression


@lru_cache(maxsize=None)
def _hann_np(win_length: int, periodic: bool = True) -> np.ndarray:
    n = win_length + 1 if periodic else win_length
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / max(n - 1, 1))
    return w[:win_length].astype(np.float32)


@lru_cache(maxsize=None)
def _dft_basis(n_fft: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Real/imag DFT bases (n_fft, n_fft//2+1) for a onesided transform, kept
    on the device (up to 16 MB at n_fft 2048: not copied again every call)."""
    k = np.arange(n_fft // 2 + 1)
    n = np.arange(n_fft)
    ang = -2.0 * np.pi * np.outer(n, k) / n_fft
    return (torch.as_tensor(np.cos(ang).astype(np.float32), device=device),
            torch.as_tensor(np.sin(ang).astype(np.float32), device=device))


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """numpy's (and jnp.pad's) "reflect" on the last axis, pads longer than
    the signal included: the signal repeats mirrored with period 2(n-1)."""
    if pad == 0:
        return x
    n = x.shape[-1]
    pos = torch.arange(-pad, n + pad, device=x.device).abs() % (2 * (n - 1))
    return x[..., torch.where(pos < n, pos, 2 * (n - 1) - pos)]


def stft_magnitude(x: torch.Tensor, n_fft: int, hop_length: int, win_length: int | None = None,
                   window: str = "hann", center: bool = True,
                   magnitude_floor: float = 0.0) -> torch.Tensor:
    """Onesided STFT magnitude of x (..., T): (..., n_frames, n_fft//2 + 1).

    window: "hann" or "ones". magnitude_floor is added inside the square
    root; without it the power is clamped at 1e-14 first."""
    win_length = win_length or n_fft
    if window == "ones":
        win = np.ones((win_length,), np.float32)
    elif window == "hann":
        win = _hann_np(win_length)
    else:
        raise ValueError(f"unknown window {window}")
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        win = np.pad(win, (lpad, n_fft - win_length - lpad))
    if center:
        x = _reflect_pad(x, n_fft // 2)
    frames = x.float().unfold(-1, n_fft, hop_length) * torch.as_tensor(win, device=x.device)
    cos_b, sin_b = _dft_basis(n_fft, x.device)
    re, im = frames @ cos_b, frames @ sin_b
    power = re * re + im * im
    if magnitude_floor:
        return torch.sqrt(power + magnitude_floor)
    return torch.sqrt(torch.clamp(power, min=1e-14))


def _hz_to_mel(freq: np.ndarray, htk: bool) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep, mels)


def _mel_to_hz(mels: np.ndarray, htk: bool) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


@lru_cache(maxsize=None)
def _mel_filterbank_np(sample_rate: int, n_fft: int, n_mels: int, f_min: float, f_max: float,
                       htk: bool, norm: str | None) -> np.ndarray:
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel(np.array(f_min), htk), _hz_to_mel(np.array(f_max), htk),
                          n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        weights *= (2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, f_min: float, f_max: float,
                   htk: bool = False, norm: str | None = "slaney", device=None) -> torch.Tensor:
    """Mel filterbank (n_mels, n_fft//2 + 1): librosa's defaults with
    `htk=False, norm="slaney"`, torchaudio's training-loss bank with
    `htk=True, norm=None`."""
    return torch.as_tensor(_mel_filterbank_np(sample_rate, n_fft, n_mels, float(f_min),
                                              float(f_max), htk, norm), device=device)


def log_mel_spectrogram(wav: torch.Tensor, sample_rate: int, n_fft: int, hop_length: int,
                        win_length: int, n_mels: int, f_min: float, f_max: float,
                        center: bool = True) -> torch.Tensor:
    """Feature-extraction log-mel (..., T) -> (..., n_mels, F): a manual
    (n_fft - hop) / 2 reflect pad, then the centred STFT with a 1e-9
    magnitude floor, the slaney bank and log-compression."""
    wav = _reflect_pad(wav, int((n_fft - hop_length) / 2))
    mag = stft_magnitude(wav, n_fft, hop_length, win_length, window="hann", center=center,
                         magnitude_floor=1e-9)
    fb = mel_filterbank(sample_rate, n_fft, n_mels, f_min, f_max, device=wav.device)
    return dynamic_range_compression((mag @ fb.T).transpose(-1, -2))
