"""Spectral voice-activity detection and silence trimming (the port's own
copy of `optispeech_tpu/data/vad.py`).

Each chunk of an utterance gets a speech probability from three features:

- adaptive SNR: chunk RMS vs the signal's own noise floor (10th percentile),
- spectral flatness: speech (harmonic) spectra are peaky, noise is flat,
- speech-band energy ratio: fraction of power in 80-4000 Hz.

The trim keeps the first..last speech chunk with keep-margins and returns
the audio untrimmed when no chunk is speech, as the reference OptiSpeech's
model-based trim does. The simpler energy-gate trim is in data/dsp.py.
"""

import numpy as np


class SpectralVoiceActivityDetector:
    """Per-chunk speech probabilities for a whole utterance.

    The detector is two-pass: pass 1 measures the utterance's noise floor,
    pass 2 scores each chunk — which is why (unlike the reference's streaming
    Silero wrapper, vad.py) the API takes the full array at once."""

    def __init__(self, snr_gate_db: float = 6.0, snr_softness_db: float = 3.0,
                 band: tuple = (80.0, 4000.0)):
        self.snr_gate_db = snr_gate_db
        self.snr_softness_db = snr_softness_db
        self.band = band

    def __call__(self, wav: np.ndarray, sample_rate: int,
                 samples_per_chunk: int = 480) -> np.ndarray:
        n = len(wav) // samples_per_chunk
        if n == 0:
            return np.zeros(0, np.float64)
        chunks = wav[: n * samples_per_chunk].astype(np.float64).reshape(n, samples_per_chunk)

        rms_db = 10.0 * np.log10(np.mean(chunks**2, axis=1) + 1e-12)
        floor_db = np.percentile(rms_db, 10.0)
        snr = _sigmoid((rms_db - floor_db - self.snr_gate_db) / self.snr_softness_db)

        win = np.hanning(samples_per_chunk)
        spec = np.abs(np.fft.rfft(chunks * win[None, :], axis=1)) ** 2 + 1e-12
        # spectral flatness: geometric/arithmetic mean of the power spectrum
        flatness = np.exp(np.mean(np.log(spec), axis=1)) / np.mean(spec, axis=1)
        peakiness = 1.0 - np.clip(flatness / 0.5, 0.0, 1.0)
        # speech-band power fraction
        freqs = np.fft.rfftfreq(samples_per_chunk, 1.0 / sample_rate)
        in_band = (freqs >= self.band[0]) & (freqs <= self.band[1])
        band_ratio = spec[:, in_band].sum(axis=1) / spec.sum(axis=1)

        return snr * np.clip(0.6 * peakiness + 0.4 * band_ratio, 0.0, 1.0)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.clip(x, -30, 30)))


def trim_silence_spectral(
    wav: np.ndarray,
    sample_rate: int,
    threshold: float = 0.2,
    samples_per_chunk: int = 480,
    keep_chunks_before: int = 2,
    keep_chunks_after: int = 2,
    detector: SpectralVoiceActivityDetector | None = None,
) -> np.ndarray:
    """Trim to the main speech block with keep-margins (reference
    trim.py:8-54 semantics: no speech found -> return the audio untrimmed)."""
    detector = detector or SpectralVoiceActivityDetector()
    probs = detector(wav, sample_rate, samples_per_chunk)
    speech = np.where(probs >= threshold)[0]
    if len(speech) == 0:
        return wav
    n_chunks = len(probs)
    first = max(0, int(speech[0]) - keep_chunks_before)
    last = min(n_chunks - 1, int(speech[-1]) + keep_chunks_after)
    if last == n_chunks - 1:
        # keep the unscored tail remainder (< samples_per_chunk): speech
        # reaching the final scored chunk likely continues into it
        return wav[first * samples_per_chunk :]
    return wav[first * samples_per_chunk : (last + 1) * samples_per_chunk]
