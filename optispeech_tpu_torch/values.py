"""Value containers for the public inference API.

Capability parity with the reference optispeech/values.py (InferenceInputs /
InferenceOutputs with padding helpers); numpy is the interchange format, and
CPU tensors are accepted transparently.
"""

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class BaseValueContainer:
    def as_tuple(self):
        return dataclasses.astuple(self)

    def as_dict(self):
        return dataclasses.asdict(self)

    def as_numpy(self):
        kwargs = {}
        for name, value in self.as_dict().items():
            if value is not None and hasattr(value, "shape"):
                kwargs[name] = np.asarray(value)
            else:
                kwargs[name] = value
        return type(self)(**kwargs)


@dataclass(kw_only=True)
class InferenceInputs(BaseValueContainer):
    """(reference values.py:72-87)."""

    clean_text: str
    x: np.ndarray
    x_lengths: np.ndarray
    sids: Optional[np.ndarray] = None
    lids: Optional[np.ndarray] = None
    d_factor: float = 1.0
    p_factor: float = 1.0
    e_factor: float = 1.0

    @classmethod
    def from_ids_and_lengths(cls, ids, lengths, **kwargs) -> "InferenceInputs":
        x = numpy_pad_sequences(ids).astype(np.int64)
        x_lengths = np.array(lengths, dtype=np.int64)
        for key in ("sids", "lids"):
            if kwargs.get(key) is not None:
                kwargs[key] = np.asarray(kwargs[key], dtype=np.int64)
        return cls(x=x, x_lengths=x_lengths, **kwargs).as_numpy()


@dataclass(kw_only=True)
class InferenceOutputs(BaseValueContainer):
    """(reference values.py:90-111)."""

    wav: np.ndarray
    wav_lengths: np.ndarray
    latency: float
    rtf: float
    durations: Optional[np.ndarray] = None
    pitch: Optional[np.ndarray] = None
    energy: Optional[np.ndarray] = None
    am_rtf: Optional[float] = None
    v_rtf: Optional[float] = None

    def __iter__(self):
        return iter(self.unbatched_wavs())

    def unbatched_wavs(self):
        return numpy_unpad_sequences(np.asarray(self.wav), np.asarray(self.wav_lengths))


def numpy_pad_sequences(sequences, maxlen=None, value=0):
    """Pad a list of variable-length sequences into (B, maxlen)
    (reference values.py:114-137)."""
    if maxlen is None:
        maxlen = max(len(seq) for seq in sequences)
    padded = np.full((len(sequences), maxlen), value)
    for i, seq in enumerate(sequences):
        padded[i, : len(seq)] = seq
    return padded


def numpy_unpad_sequences(sequences, lengths):
    """Split (B, T...) back into a list of per-item prefixes
    (reference values.py:140-170)."""
    lengths = np.asarray(lengths)
    if lengths.ndim != 1:
        raise ValueError("lengths must be a 1D array")
    if (lengths < 0).any() or (lengths > sequences.shape[-1]).any():
        raise ValueError("lengths must be between 0 and max_len")
    return [sequences[i, ..., : int(lengths[i])] for i in range(sequences.shape[0])]
