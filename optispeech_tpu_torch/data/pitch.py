"""Host-side pitch trackers and their weighted ensemble (the port's own copy
of `optispeech_tpu/data/pitch.py`).

Three independent trackers under one constructor/__call__ contract:
normalised autocorrelation (data/dsp.py), YIN (cumulative-mean-normalised
difference, de Cheveigne & Kawahara 2002) and cepstral peak picking with
CPP voicing (Noll 1967); and the reference OptiSpeech's ensemble semantics:
stack -> weighted average -> UV mask (f0 <= f_min // 3.5 on the designated
detector) -> zero -> optional interpolation through unvoiced runs.

All trackers return f0 in Hz per mel frame, 0 when unvoiced (before
interpolation), trimmed/padded to `mel_length`.
"""

import numpy as np

from .dsp import AutocorrelationPitchExtractor, autocorr_pitch, trim_or_pad_to


def _interp_unvoiced(f0: np.ndarray) -> np.ndarray:
    """Linear interpolation through unvoiced (zero) runs, edge-held
    (reference BasePitchExtractor.perform_interpolation, :50-61)."""
    voiced = f0 > 0
    if not voiced.any():
        return f0
    idx = np.arange(len(f0))
    return np.interp(idx, idx[voiced], f0[voiced]).astype(f0.dtype)


def yin_pitch(
    wav: np.ndarray,
    sample_rate: int,
    hop_length: int,
    n_frames: int,
    f_min: float = 65.0,
    f_max: float = 800.0,
    frame_length: int | None = None,
    threshold: float = 0.15,
    interpolate: bool = True,
) -> np.ndarray:
    """YIN fundamental-frequency tracker (difference function + CMND +
    absolute threshold + parabolic refinement). Independent of the
    autocorrelation tracker's peak-picking, so ensemble averaging the two
    cancels uncorrelated octave/noise errors."""
    frame_length = frame_length or int(4 * sample_rate / f_min)
    tau_min = max(int(sample_rate / f_max), 2)
    tau_max = min(int(sample_rate / f_min) + 2, frame_length - 1)
    W = frame_length
    half = W // 2
    x = np.pad(wav.astype(np.float64), (half, half + tau_max), mode="reflect")

    f0 = np.zeros(n_frames, np.float64)
    for i in range(n_frames):
        start = i * hop_length
        seg = x[start : start + W + tau_max]
        if len(seg) < W + tau_max:
            seg = np.pad(seg, (0, W + tau_max - len(seg)))
        if np.dot(seg[:W], seg[:W]) < 1e-10:
            continue
        # difference d(tau) = e0 + e_tau - 2 * crosscorr(tau), tau in [0, tau_max]
        cross = np.correlate(seg, seg[:W], mode="valid")  # r[tau] = sum x[j] x[j+tau]
        cum = np.concatenate(([0.0], np.cumsum(seg * seg)))
        e_tau = cum[W + np.arange(tau_max + 1)] - cum[np.arange(tau_max + 1)]
        d = cum[W] + e_tau - 2.0 * cross
        d = np.maximum(d, 0.0)
        # cumulative-mean-normalized difference
        cmnd = np.ones(tau_max + 1)
        running = np.cumsum(d[1:])
        cmnd[1:] = d[1:] * np.arange(1, tau_max + 1) / np.maximum(running, 1e-12)
        # absolute threshold: first dip below `threshold`, descended to its
        # local minimum; unvoiced if no dip qualifies
        seg_cm = cmnd[tau_min : tau_max + 1]
        below = np.where(seg_cm < threshold)[0]
        if len(below) == 0:
            continue
        k = below[0]
        while k + 1 < len(seg_cm) and seg_cm[k + 1] < seg_cm[k]:
            k += 1
        tau = tau_min + k
        # parabolic interpolation on d() around the chosen lag
        if 0 < tau < tau_max:
            a, b, c = d[tau - 1], d[tau], d[tau + 1]
            denom = a - 2 * b + c
            if abs(denom) > 1e-12:
                tau = tau + 0.5 * (a - c) / denom
        f0[i] = sample_rate / tau

    if interpolate:
        f0 = _interp_unvoiced(f0)
    return f0.astype(np.float32)


class YINPitchExtractor:
    """Same constructor/__call__ contract as the reference extractors
    (pitch_extractors.py:24-47)."""

    def __init__(self, sample_rate, n_feats, hop_length, n_fft, win_length,
                 f_min, f_max, interpolate: bool = True, threshold: float = 0.15, **_):
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.f_min = max(float(f_min), 50.0)
        self.f_max = float(f_max) if f_max else 800.0
        self.threshold = threshold
        self.interpolate = interpolate

    def __call__(self, wav, mel_length):
        return trim_or_pad_to(
            yin_pitch(
                wav, self.sample_rate, self.hop_length, mel_length,
                f_min=self.f_min, f_max=min(self.f_max, 800.0),
                threshold=self.threshold, interpolate=self.interpolate,
            ),
            mel_length,
        )


def cepstrum_pitch(
    wav: np.ndarray,
    sample_rate: int,
    hop_length: int,
    n_frames: int,
    f_min: float = 65.0,
    f_max: float = 800.0,
    frame_length: int | None = None,
    cpp_threshold: float = 0.12,
    interpolate: bool = True,
) -> np.ndarray:
    """Cepstral pitch tracker (Noll 1967): real cepstrum peak in the
    [1/f_max, 1/f_min] quefrency band, voiced/unvoiced by cepstral peak
    prominence (peak height above a linear trend fitted over the band —
    the CPP measure). A third estimator family for the ensemble: its error
    modes (spectral, log-magnitude domain) are independent of both the
    autocorrelation and YIN (difference-function) time-domain trackers."""
    frame_length = frame_length or int(4 * sample_rate / f_min)
    n_fft = 1 << (frame_length - 1).bit_length()  # next pow2 >= frame
    tau_min = max(int(sample_rate / f_max), 2)
    tau_max = min(int(sample_rate / f_min) + 2, n_fft // 2 - 1)
    half = frame_length // 2
    x = np.pad(wav.astype(np.float64), (half, half + frame_length), mode="reflect")

    idx = np.arange(frame_length)[None, :] + hop_length * np.arange(n_frames)[:, None]
    frames = x[np.minimum(idx, len(x) - 1)] * np.hanning(frame_length)[None, :]
    spec = np.abs(np.fft.rfft(frames, n_fft, axis=1))
    ceps = np.fft.irfft(np.log(spec + 1e-10), n_fft, axis=1)[:, : tau_max + 1]

    band = ceps[:, tau_min : tau_max + 1]
    q = np.arange(tau_min, tau_max + 1, dtype=np.float64)
    # per-frame linear trend over the band (closed-form least squares)
    qm = q.mean()
    denom = ((q - qm) ** 2).sum()
    slope = ((q - qm)[None, :] * (band - band.mean(1, keepdims=True))).sum(1) / denom
    k = np.argmax(band, axis=1)
    peak = band[np.arange(n_frames), k]
    trend_at_peak = band.mean(1) + slope * (q[k] - qm)
    prominence = peak - trend_at_peak

    tau = (tau_min + k).astype(np.float64)
    # parabolic refinement around the cepstral peak
    t_int = tau_min + k
    ok = (t_int > tau_min) & (t_int < tau_max)
    a = ceps[np.arange(n_frames), np.maximum(t_int - 1, 0)]
    b = peak
    c = ceps[np.arange(n_frames), np.minimum(t_int + 1, tau_max)]
    den = a - 2 * b + c
    safe = np.where(np.abs(den) > 1e-12, den, 1.0)
    shift = np.where(np.abs(den) > 1e-12, 0.5 * (a - c) / safe, 0.0)
    tau = np.where(ok, tau + np.clip(shift, -1, 1), tau)

    energy = (frames**2).sum(1)
    voiced = (prominence > cpp_threshold) & (energy > 1e-8)
    f0 = np.where(voiced, sample_rate / tau, 0.0)

    if interpolate:
        f0 = _interp_unvoiced(f0)
    return f0.astype(np.float32)


class CepstralPitchExtractor:
    """Same constructor/__call__ contract as the reference extractors
    (pitch_extractors.py:24-47)."""

    def __init__(self, sample_rate, n_feats, hop_length, n_fft, win_length,
                 f_min, f_max, interpolate: bool = True,
                 cpp_threshold: float = 0.12, **_):
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.f_min = max(float(f_min), 50.0)
        self.f_max = min(float(f_max), 800.0) if f_max else 800.0
        self.cpp_threshold = cpp_threshold
        self.interpolate = interpolate

    def __call__(self, wav, mel_length):
        return trim_or_pad_to(
            cepstrum_pitch(
                wav, self.sample_rate, self.hop_length, mel_length,
                f_min=self.f_min, f_max=self.f_max,
                cpp_threshold=self.cpp_threshold, interpolate=self.interpolate,
            ),
            mel_length,
        )


class EnsemblePitchExtractor:
    """Weighted ensemble with the reference's UV-masking contract
    (pitch_extractors.py:219-250): stack member estimates, weighted-average,
    zero frames the designated UV detector marks unvoiced
    (f0 <= f_min // 3.5), then interpolate through the zeros.

    Members here: autocorrelation (weight 0.5, also the UV detector — the
    JDC role), YIN (0.3) and cepstral (0.2). All run with interpolate=False
    so the average blends real estimates only where each tracker is voiced."""

    def __init__(self, sample_rate, n_feats, hop_length, n_fft, win_length,
                 f_min, f_max, interpolate: bool = True, weights=(0.5, 0.3, 0.2), **_):
        kw = dict(sample_rate=sample_rate, n_feats=n_feats, hop_length=hop_length,
                  n_fft=n_fft, win_length=win_length, f_min=f_min, f_max=f_max,
                  interpolate=False)
        self._extractors = [AutocorrelationPitchExtractor(**kw), YINPitchExtractor(**kw),
                            CepstralPitchExtractor(**kw)]
        self._weights = np.asarray(weights, np.float64)
        self.uv_detector_index = 0
        self.uv_threshold = float(f_min) // 3.5
        self.interpolate = interpolate

    def __call__(self, wav, mel_length):
        preds = np.stack([ex(wav, mel_length) for ex in self._extractors], axis=0)
        uv_mask = preds[self.uv_detector_index] <= self.uv_threshold
        # per-frame renormalized weights: a member that says "unvoiced" (0)
        # must not drag the voiced average toward zero
        member_voiced = preds > self.uv_threshold
        w = self._weights[:, None] * member_voiced
        wsum = np.maximum(w.sum(axis=0), 1e-12)
        pitch = (w * preds).sum(axis=0) / wsum
        pitch[uv_mask] = 0.0
        if self.interpolate:
            pitch = _interp_unvoiced(pitch)
        return pitch.astype(np.float32)


PITCH_EXTRACTORS = {
    "autocorr": AutocorrelationPitchExtractor,
    "yin": YINPitchExtractor,
    "cepstrum": CepstralPitchExtractor,
    "ensemble": EnsemblePitchExtractor,
}


def make_pitch_extractor(name: str, features, interpolate: bool = True):
    """Build a pitch extractor by registry name from a FeatureConfig
    (reference: configs/data/feature_extractor/*.yaml pitch_extractor target)."""
    try:
        cls = PITCH_EXTRACTORS[name]
    except KeyError:
        raise ValueError(
            f"unknown pitch extractor {name!r}; available: {sorted(PITCH_EXTRACTORS)}"
        ) from None
    f = features
    return cls(
        sample_rate=f.sample_rate, n_feats=f.n_feats, hop_length=f.hop_length,
        n_fft=f.n_fft, win_length=f.win_length, f_min=f.f_min, f_max=f.f_max,
        interpolate=interpolate,
    )
