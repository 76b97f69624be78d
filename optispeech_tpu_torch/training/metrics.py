"""Host-side perceptual evaluation metrics for validation (the port's own
copy of `optispeech_tpu/training/metrics.py`, numpy).

Periodicity distance, voiced/unvoiced F1 and log-F0 RMSE between reference
and generated audio (the autocorrelation tracker of data/dsp.py), mel-cepstral
distortion and STOI. UTMOS and PESQ stay optional dependencies, import-gated
(train_args.evaluate_utmos / evaluate_pesq).
"""

import numpy as np

from ..data.dsp import autocorr_pitch, log_mel_spectrogram_np


def _f0_and_periodicity(wav, sample_rate=16000, hop=160):
    n_frames = max(len(wav) // hop, 1)
    f0 = autocorr_pitch(wav, sample_rate, hop, n_frames, interpolate=False)
    voiced = f0 > 0
    return f0, voiced


def periodicity_metrics(ref_wavs: np.ndarray, gen_wavs: np.ndarray, sample_rate: int = 16000):
    """Returns (periodicity_rmse, log_f0_rmse_voiced, voicing_f1), averaged
    over the batch."""
    perio, pitch_rmse, f1s = [], [], []
    for ref, gen in zip(ref_wavs, gen_wavs):
        f0_r, v_r = _f0_and_periodicity(np.asarray(ref), sample_rate)
        f0_g, v_g = _f0_and_periodicity(np.asarray(gen), sample_rate)
        n = min(len(f0_r), len(f0_g))
        f0_r, v_r, f0_g, v_g = f0_r[:n], v_r[:n], f0_g[:n], v_g[:n]
        perio.append(np.sqrt(np.mean((v_r.astype(float) - v_g.astype(float)) ** 2)))
        both = v_r & v_g
        if both.any():
            pitch_rmse.append(np.sqrt(np.mean(
                (np.log2(f0_r[both]) - np.log2(f0_g[both])) ** 2
            )))
        tp = float((v_r & v_g).sum())
        prec = tp / max(v_g.sum(), 1)
        rec = tp / max(v_r.sum(), 1)
        f1s.append(2 * prec * rec / max(prec + rec, 1e-9))
    return (
        float(np.mean(perio)) if perio else 0.0,
        float(np.mean(pitch_rmse)) if pitch_rmse else 0.0,
        float(np.mean(f1s)) if f1s else 0.0,
    )


def mel_cepstral_distortion(ref_wav, gen_wav, sample_rate=24000, n_mfcc=13):
    """Mel-cepstral distortion, Kubichek convention (dB).

    Cepstra are the DCT-II (ortho) of the natural-log mel spectrogram —
    the standard "mcep" style — keeping coefficients c1..c{n_mfcc} (c0 is
    excluded, which makes the metric invariant to a global gain):

        MCD = (10 / ln 10) * mean_t sqrt(2 * sum_d (c_d - c'_d)^2)

    Expected ranges (time-aligned signals, no DTW): 0 for identical audio;
    ~4-8 dB for good TTS vs ground truth; >10 dB = badly mismatched spectra.
    Validated in tests against a torch.stft oracle, gain invariance, and
    ordering under increasing noise."""
    from scipy.fftpack import dct

    def mcep(w):
        mel = log_mel_spectrogram_np(np.asarray(w, np.float32), sample_rate,
                                     1024, 256, 1024, 80, 0.0, sample_rate / 2)
        return dct(mel.T, type=2, norm="ortho")[:, 1 : n_mfcc + 1]

    a, b = mcep(ref_wav), mcep(gen_wav)
    n = min(len(a), len(b))
    diff = a[:n] - b[:n]
    return float((10.0 / np.log(10.0)) * np.mean(
        np.sqrt(2.0 * np.sum(diff**2, axis=1))
    ))


_UTMOS_CACHE: dict = {}


def utmos_score(wavs_16khz, model_path: str | None = None):
    """Optional UTMOS MOS predictor, lazily loaded when
    train_args.evaluate_utmos is set: a local TorchScript export of a MOS
    predictor, given as `model_path` or $OPTISPEECH_UTMOS_JIT, that maps a
    (1, 1, T) 16 kHz float waveform to a (scalar-reducible) MOS tensor.
    Returns one score per wav."""
    import os

    path = model_path or os.environ.get("OPTISPEECH_UTMOS_JIT")
    if not path or not os.path.exists(path):
        raise ImportError(
            "UTMOS evaluation needs a local TorchScript MOS model: set "
            "$OPTISPEECH_UTMOS_JIT (or pass model_path) to the exported "
            "UTMOS .pt file"
        )
    if path not in _UTMOS_CACHE:
        import torch

        _UTMOS_CACHE[path] = torch.jit.load(path, map_location="cpu").eval()
    model = _UTMOS_CACHE[path]
    import torch

    scores = []
    with torch.no_grad():
        for w in wavs_16khz:
            x = torch.as_tensor(np.asarray(w, np.float32))[None, None, :]
            scores.append(float(model(x).float().mean()))
    return scores


def stoi_score(ref_wavs_16khz, gen_wavs_16khz):
    """Short-Time Objective Intelligibility (Taal et al. 2011), batch mean.

    Self-contained numpy implementation, always available. Inputs must be
    16 kHz. Returns mean STOI in [~0, 1]."""
    return float(np.mean([
        _stoi_single(np.asarray(r, np.float64), np.asarray(g, np.float64))
        for r, g in zip(ref_wavs_16khz, gen_wavs_16khz)
    ]))


def _stoi_octave_bands(sr=10000, n_fft=512, n_bands=15, f_start=150.0):
    """One-third-octave band matrix over rfft bins (Taal et al. Table I)."""
    f = np.linspace(0, sr / 2, n_fft // 2 + 1)
    cf = f_start * 2.0 ** (np.arange(n_bands) / 3.0)
    lo, hi = cf * 2 ** (-1 / 6), cf * 2 ** (1 / 6)
    bands = np.zeros((n_bands, len(f)))
    for i in range(n_bands):
        bands[i, (f >= lo[i]) & (f < hi[i])] = 1.0
    return bands


def _stoi_single(ref, gen, frame=256, n_fft=512, n_frames_seg=30, beta_db=-15.0):
    # resample 16 kHz -> 10 kHz (the STOI reference rate)
    from scipy.signal import resample_poly

    x = resample_poly(ref, 5, 8)
    y = resample_poly(gen, 5, 8)
    n = min(len(x), len(y))
    x, y = x[:n], y[:n]
    hop = frame // 2
    win = np.hanning(frame + 2)[1:-1]

    def frames(sig):
        m = 1 + max(0, (len(sig) - frame) // hop)
        idx = np.arange(frame)[None, :] + hop * np.arange(m)[:, None]
        return sig[idx] * win

    fx, fy = frames(x), frames(y)
    # silent-frame removal by ref energy (40 dB below loudest frame)
    e = 20 * np.log10(np.linalg.norm(fx, axis=1) + 1e-12)
    keep = e > e.max() - 40.0
    fx, fy = fx[keep], fy[keep]
    if len(fx) < n_frames_seg:
        return 1e-5
    X = np.abs(np.fft.rfft(fx, n_fft, axis=1))
    Y = np.abs(np.fft.rfft(fy, n_fft, axis=1))
    bands = _stoi_octave_bands(n_fft=n_fft)
    # (T, J) band envelopes
    Xb = np.sqrt((X[:, None, :] ** 2 * bands[None]).sum(-1)).T
    Yb = np.sqrt((Y[:, None, :] ** 2 * bands[None]).sum(-1)).T
    J, T = Xb.shape
    N = n_frames_seg
    d = []
    for m in range(N, T + 1):
        xs, ys = Xb[:, m - N : m], Yb[:, m - N : m]
        # scale + clip the degraded segment (eq. 3-4)
        alpha = np.sqrt((xs**2).sum(1, keepdims=True) / ((ys**2).sum(1, keepdims=True) + 1e-12))
        ys_c = np.minimum(ys * alpha, xs * (1 + 10 ** (-beta_db / 20)))
        xm = xs - xs.mean(1, keepdims=True)
        ym = ys_c - ys_c.mean(1, keepdims=True)
        corr = (xm * ym).sum(1) / (
            np.linalg.norm(xm, axis=1) * np.linalg.norm(ym, axis=1) + 1e-12
        )
        d.append(corr.mean())
    return float(np.mean(d))


def pesq_score(ref_wavs_16khz, gen_wavs_16khz):
    """Optional PESQ (needs the `pesq` package)."""
    try:
        from pesq import pesq
    except ImportError as e:
        raise ImportError("pesq package is required for PESQ evaluation") from e
    score = 0.0
    for ref, deg in zip(ref_wavs_16khz, gen_wavs_16khz):
        score += pesq(16000, np.asarray(ref), np.asarray(deg), "wb", on_error=1)
    return score / max(len(ref_wavs_16khz), 1)


def resample_to_16k(wav: np.ndarray, orig_sr: int) -> np.ndarray:
    from scipy.signal import resample_poly

    g = np.gcd(16000, orig_sr)
    return resample_poly(np.asarray(wav, np.float64), 16000 // g, orig_sr // g).astype(np.float32)
