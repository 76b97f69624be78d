"""WAV I/O and resampling on scipy (the port's own copy of
`optispeech_tpu/utils/wavio.py`)."""

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def load_wav(path, sr: int | None = None, mono: bool = True):
    """Returns (float32 waveform in [-1, 1], sample_rate)."""
    file_sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if mono and data.ndim == 2:
        data = data.mean(axis=1)
    if sr is not None and sr != file_sr:
        g = np.gcd(int(sr), int(file_sr))
        data = resample_poly(data, sr // g, file_sr // g).astype(np.float32)
        file_sr = sr
    return data, file_sr


def save_wav(path, wav: np.ndarray, sr: int):
    wav = np.clip(np.asarray(wav, np.float32), -1.0, 1.0)
    wavfile.write(path, sr, (wav * 32767.0).astype(np.int16))
