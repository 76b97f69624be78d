"""Host-side (numpy) DSP for offline preprocessing and validation (the
port's own copy of `optispeech_tpu/data/dsp.py`).

The log-mel spectrogram (double reflect pad, slaney bank, log clipped at
1e-5) and per-frame spectral energy; the autocorrelation pitch tracker (f0
in Hz per frame, 0 where unvoiced, optionally interpolated through unvoiced
regions); BS.1770 loudness; RBJ biquads; peak normalisation and an energy
silence trim. Numpy only, so preprocessing workers never touch the card.
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


def frame_energy_np(wav, n_fft, hop_length, win_length, center=True) -> np.ndarray:
    mag = stft_magnitude_np(wav, n_fft, hop_length, win_length, center)
    return np.sqrt((mag**2).sum(axis=-1)).astype(np.float32)


def trim_or_pad_to(x: np.ndarray, target: int) -> np.ndarray:
    """Cut or zero-pad the first axis of `x` to `target`."""
    if x.shape[0] >= target:
        return x[:target]
    pad = [(0, target - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad)


# ---------------------------------------------------------------------------
# Pitch extraction (host): normalized-autocorrelation tracker.
# The reference OptiSpeech defaults to pyworld DIO (a C++ dependency); this is a
# self-contained replacement with the same output contract: f0 in Hz per mel
# frame, 0 for unvoiced, optional linear interpolation through unvoiced
# regions (reference pitch_extractors.py:50-85).
# ---------------------------------------------------------------------------

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


class AutocorrelationPitchExtractor:
    """Pluggable extractor with the reference's constructor/call contract
    (pitch_extractors.py:24-47)."""

    def __init__(self, sample_rate, n_feats, hop_length, n_fft, win_length,
                 f_min, f_max, interpolate: bool = True, **_):
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.f_min = max(float(f_min), 50.0)
        self.interpolate = interpolate

    def __call__(self, wav, mel_length):
        return autocorr_pitch(
            wav, self.sample_rate, self.hop_length, mel_length,
            f_min=self.f_min, interpolate=self.interpolate,
        )


# ---------------------------------------------------------------------------
# Loudness normalization: BS.1770-style integrated loudness (pyloudnorm's
# algorithm re-implemented on scipy; reference utils/audio.py:41-58).
# ---------------------------------------------------------------------------

def _k_weighting_coeffs(sr: float):
    # pre-filter (high shelf) and RLB high-pass per ITU-R BS.1770-4
    f0, G, Q = 1681.9744509555319, 3.99984385397, 0.7071752369554193
    K = np.tan(np.pi * f0 / sr)
    Vh = 10.0 ** (G / 20.0)
    Vb = Vh**0.4996667741545416
    a0 = 1.0 + K / Q + K * K
    shelf_b = [(Vh + Vb * K / Q + K * K) / a0, 2.0 * (K * K - Vh) / a0, (Vh - Vb * K / Q + K * K) / a0]
    shelf_a = [1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0]
    f0, Q = 38.13547087613982, 0.5003270373253953
    K = np.tan(np.pi * f0 / sr)
    hp_b = [1.0, -2.0, 1.0]
    hp_a = [1.0, 2.0 * (K * K - 1.0) / (1.0 + K / Q + K * K), (1.0 - K / Q + K * K) / (1.0 + K / Q + K * K)]
    return (np.array(shelf_b), np.array(shelf_a)), (np.array(hp_b) / (1.0 + K / Q + K * K) * (1.0 + K / Q + K * K), np.array(hp_a))


def integrated_loudness(wav: np.ndarray, sample_rate: int) -> float:
    from scipy.signal import lfilter

    (sb, sa), (hb, ha) = _k_weighting_coeffs(sample_rate)
    y = lfilter(sb, sa, wav.astype(np.float64))
    y = lfilter(hb, ha, y)
    block = int(0.400 * sample_rate)
    hop = int(0.100 * sample_rate)
    if len(y) < block:
        y = np.pad(y, (0, block - len(y)))
    n_blocks = 1 + (len(y) - block) // hop
    power = np.array([np.mean(y[i * hop : i * hop + block] ** 2) for i in range(n_blocks)])
    loud = -0.691 + 10.0 * np.log10(np.maximum(power, 1e-12))
    gated = power[loud > -70.0]
    if len(gated) == 0:
        return -70.0
    rel_thresh = -0.691 + 10.0 * np.log10(gated.mean()) - 10.0
    gated2 = power[(loud > -70.0) & (loud > rel_thresh)]
    if len(gated2) == 0:
        return -70.0
    return float(-0.691 + 10.0 * np.log10(gated2.mean()))


def normalize_loudness(wav: np.ndarray, sample_rate: int, target_db: float = -24.0) -> np.ndarray:
    current = integrated_loudness(wav, sample_rate)
    gain = 10.0 ** ((target_db - current) / 20.0)
    return (wav * gain).astype(np.float32)


def _rbj_biquad_coeffs(sample_rate: float, cutoff_freq: float, q: float, kind: str):
    """Audio-EQ-cookbook (RBJ) biquad coefficients — the same filter
    torchaudio.functional.{lowpass,highpass}_biquad computes (the reference's
    band-limit knobs, feature_extractors/__init__.py:88-95)."""
    w0 = 2.0 * np.pi * cutoff_freq / sample_rate
    alpha = np.sin(w0) / (2.0 * q)
    cosw = np.cos(w0)
    if kind == "lowpass":
        b = np.array([(1 - cosw) / 2.0, 1 - cosw, (1 - cosw) / 2.0])
    elif kind == "highpass":
        b = np.array([(1 + cosw) / 2.0, -(1 + cosw), (1 + cosw) / 2.0])
    else:
        raise ValueError(f"unknown biquad kind {kind}")
    a = np.array([1 + alpha, -2 * cosw, 1 - alpha])
    return b / a[0], a / a[0]


def lowpass_biquad(wav: np.ndarray, sample_rate: int, cutoff_freq: float,
                   q: float = 0.707) -> np.ndarray:
    """Single-pole-pair Butterworth-style low-pass (torchaudio
    lowpass_biquad semantics: one RBJ biquad, default Q=0.707)."""
    from scipy.signal import lfilter

    b, a = _rbj_biquad_coeffs(sample_rate, cutoff_freq, q, "lowpass")
    return lfilter(b, a, wav.astype(np.float64)).astype(np.float32)


def highpass_biquad(wav: np.ndarray, sample_rate: int, cutoff_freq: float,
                    q: float = 0.707) -> np.ndarray:
    """RBJ high-pass biquad (torchaudio highpass_biquad semantics)."""
    from scipy.signal import lfilter

    b, a = _rbj_biquad_coeffs(sample_rate, cutoff_freq, q, "highpass")
    return lfilter(b, a, wav.astype(np.float64)).astype(np.float32)


def peak_normalize(wav: np.ndarray) -> np.ndarray:
    """librosa.util.normalize equivalent (max |x| -> 1)."""
    peak = np.max(np.abs(wav))
    return (wav / peak).astype(np.float32) if peak > 0 else wav.astype(np.float32)


def trim_silence_energy(
    wav: np.ndarray,
    sample_rate: int,
    threshold_db: float = -40.0,
    chunk: int = 720,
    keep_chunks_before: int = 1,
    keep_chunks_after: int = 1,
) -> np.ndarray:
    """Energy-based VAD trim with keep-margins (the role of the reference's
    silero/webrtcvad trimming, norm_audio/trim.py; the detector differs: no
    ONNX VAD model is needed)."""
    n = len(wav) // chunk
    if n == 0:
        return wav
    frames = wav[: n * chunk].reshape(n, chunk)
    rms_db = 10 * np.log10(np.mean(frames**2, axis=1) + 1e-10)
    active = np.where(rms_db > threshold_db)[0]
    if len(active) == 0:
        return wav
    start = max(active[0] - keep_chunks_before, 0) * chunk
    end = min(active[-1] + 1 + keep_chunks_after, n) * chunk
    return wav[start:end]
