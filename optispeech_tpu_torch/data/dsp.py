"""Host-side (numpy) DSP that validation needs: the log-mel spectrogram
and the autocorrelation pitch tracker (the port's own copy of those parts of
`optispeech_tpu/data/dsp.py`).

`autocorr_pitch` gives f0 in Hz per frame, 0 where unvoiced, optionally
interpolated through unvoiced regions.
"""

import numpy as np

from ..ops.stft import _hann_np, _mel_filterbank_np


def _reflect_pad(x: np.ndarray, pad: int) -> np.ndarray:
    return np.pad(x, (pad, pad), mode="reflect") if pad else x


def _frames(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    n = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(n_fft)[None, :]
    return x[idx]


def stft_magnitude_np(
    wav: np.ndarray, n_fft: int, hop_length: int, win_length: int, center: bool = True
) -> np.ndarray:
    """torch.stft-convention magnitudes with the feature extractor's extra
    (n_fft-hop)/2 pre-pad. Returns (frames, n_fft//2+1)."""
    x = _reflect_pad(wav.astype(np.float64), int((n_fft - hop_length) / 2))
    if center:
        x = _reflect_pad(x, n_fft // 2)
    win = _hann_np(win_length).astype(np.float64)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        win = np.pad(win, (lpad, n_fft - win_length - lpad))
    frames = _frames(x, n_fft, hop_length) * win[None, :]
    spec = np.fft.rfft(frames, axis=-1)
    return np.sqrt(spec.real**2 + spec.imag**2 + 1e-9)


def log_mel_spectrogram_np(
    wav, sample_rate, n_fft, hop_length, win_length, n_mels, f_min, f_max, center=True
) -> np.ndarray:
    """(n_mels, frames) log-mel, slaney bank, log clipped at 1e-5."""
    mag = stft_magnitude_np(wav, n_fft, hop_length, win_length, center)
    fb = _mel_filterbank_np(sample_rate, n_fft, n_mels, float(f_min), float(f_max), False, "slaney")
    mel = fb @ mag.T
    return np.log(np.clip(mel, 1e-5, None)).astype(np.float32)


def autocorr_pitch(
    wav: np.ndarray,
    sample_rate: int,
    hop_length: int,
    n_frames: int,
    f_min: float = 65.0,
    f_max: float = 800.0,
    frame_length: int | None = None,
    voicing_threshold: float = 0.3,
    interpolate: bool = True,
) -> np.ndarray:
    frame_length = frame_length or int(4 * sample_rate / f_min)
    half = frame_length // 2
    x = np.pad(wav.astype(np.float64), (half, half), mode="reflect")
    lag_min = int(sample_rate / f_max)
    lag_max = min(int(sample_rate / f_min), frame_length - 1)

    f0 = np.zeros(n_frames, np.float64)
    voiced = np.zeros(n_frames, bool)
    for i in range(n_frames):
        start = i * hop_length
        frame = x[start : start + frame_length]
        if len(frame) < frame_length:
            frame = np.pad(frame, (0, frame_length - len(frame)))
        frame = frame - frame.mean()
        denom = np.dot(frame, frame)
        if denom < 1e-10:
            continue
        ac = np.correlate(frame, frame, mode="full")[frame_length - 1 :]
        ac = ac / (denom + 1e-12)
        seg = ac[lag_min : lag_max + 1]
        if len(seg) == 0:
            continue
        k = int(np.argmax(seg))
        if seg[k] < voicing_threshold:
            continue
        lag = lag_min + k
        # parabolic interpolation around the peak for sub-sample accuracy
        if 0 < k < len(seg) - 1:
            a, b, c = seg[k - 1], seg[k], seg[k + 1]
            denom2 = a - 2 * b + c
            if abs(denom2) > 1e-12:
                lag = lag + 0.5 * (a - c) / denom2
        f0[i] = sample_rate / lag
        voiced[i] = True

    if interpolate and voiced.any():
        idx = np.arange(n_frames)
        f0 = np.interp(idx, idx[voiced], f0[voiced])
    return f0.astype(np.float32)
