"""The device-resident feature cache (port of
`optispeech_tpu/data/device_cache.py`).

The packed training split is padded, normalised and uploaded once to the
device (the card unless the caller asks for the CPU); each train step then
ships only one (B, 2) int32 tensor of item indices and segment starts, and
the batch is gathered on the device (`gather_arenas`: row selects, a slice
to the batch's bucketed lengths and one flat gather of the waveform
segment).

The features are those of the packed host path (`data/packed.py`):
- the uv-threshold zeroes pitch before normalisation (uv = f_min // 3.5);
- normalisation comes after zero-padding, so the padding holds the
  normalised zero;
- items longer than max_text_len / max_mel_len (rounded up to the buckets)
  are truncated and their lengths clamped;
- `DeviceCacheLoader` keeps `PackedLoader`'s batch order, shard slicing and
  resume contract.
`mel_dtype="bfloat16"` stores the mel arena in bf16 and `wav_dtype="int16"`
the waveform as int16 codes (`wav * 32767`, clipped, truncated), scaled back
by 1/32767 at the gather.
"""

import mmap
from typing import Optional

import numpy as np
import torch

from ..config import DataStatistics
from ..utils.bucketing import round_up_to_bucket
from ..utils.device import resolve_device
from ..utils.pylogger import get_pylogger
from .packed import _HEADER, _ITEM, _MAGIC, PackedLoader

log = get_pylogger(__name__)

ARENA_KEYS = ("x", "mel", "pitch", "energy", "wav")


class PackedArena:
    """Pure-Python mmap reader of the .pak format (`data/packed.py`'s writer)."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        magic, _version, n_items, n_feats, hop = _HEADER.unpack_from(self._mm, 0)
        if magic != _MAGIC:
            raise IOError(f"{path}: not a packed dataset (magic {magic!r})")
        self.n_items = int(n_items)
        self.n_feats = int(n_feats)
        self.hop_length = int(hop)
        self._items = [_ITEM.unpack_from(self._mm, _HEADER.size + i * _ITEM.size)
                       for i in range(self.n_items)]
        column = lambda k: np.array([it[k] for it in self._items], np.int32)  # noqa: E731
        self.text_lens, self.wav_lens, self.mel_lens = column(5), column(6), column(7)
        self.sids, self.lids = column(8), column(9)

    def __len__(self):
        return self.n_items

    def _view(self, off: int, count: int, dtype) -> np.ndarray:
        return np.frombuffer(self._mm, dtype=dtype, count=count, offset=off)

    def text(self, i: int) -> np.ndarray:
        it = self._items[i]
        return self._view(it[0], it[5], np.int32)

    def wav(self, i: int) -> np.ndarray:
        it = self._items[i]
        return self._view(it[1], it[6], np.float32)

    def mel(self, i: int) -> np.ndarray:
        it = self._items[i]
        return self._view(it[2], self.n_feats * it[7], np.float32).reshape(self.n_feats, it[7])

    def pitch(self, i: int) -> np.ndarray:
        it = self._items[i]
        return self._view(it[3], it[7], np.float32)

    def energy(self, i: int) -> np.ndarray:
        it = self._items[i]
        return self._view(it[4], it[7], np.float32)

    def close(self):
        self._mm.close()
        self._f.close()


class DeviceFeatureCache:
    """Padded, normalised feature arenas resident on `device` (the card by
    default; raises without one unless a device is given)."""

    def __init__(self, pak_path: str, statistics: DataStatistics, f_min: float = 80.0,
                 device=None, do_normalize: bool = True, text_bucket: int = 32,
                 mel_bucket: int = 128, max_text_len: Optional[int] = None,
                 max_mel_len: Optional[int] = None, mel_dtype: str = "float32",
                 wav_dtype: str = "float32"):
        if mel_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"mel_dtype {mel_dtype!r}: float32 or bfloat16")
        if wav_dtype not in ("float32", "int16"):
            raise ValueError(f"wav_dtype {wav_dtype!r}: float32 or int16")
        self.device = resolve_device(device)
        arena = PackedArena(pak_path)
        self.n_items = arena.n_items
        self.n_feats = arena.n_feats
        self.hop_length = arena.hop_length
        # the raw lengths order the loader's batches, as PackedDataset's do
        self.text_lens = arena.text_lens.copy()
        self.mel_lens = arena.mel_lens.copy()

        t_text, t_mel = int(arena.text_lens.max()), int(arena.mel_lens.max())
        if max_text_len:
            t_text = min(t_text, max_text_len)
        if max_mel_len:
            t_mel = min(t_mel, max_mel_len)
        t_text = round_up_to_bucket(t_text, text_bucket)
        t_mel = round_up_to_bucket(t_mel, mel_bucket)
        self.t_text_max, self.t_mel_max = t_text, t_mel
        t_wav = t_mel * arena.hop_length

        n = arena.n_items
        x = np.zeros((n, t_text), np.int32)
        mel = np.zeros((n, arena.n_feats, t_mel), np.float32)
        pitch = np.zeros((n, t_mel), np.float32)
        energy = np.zeros((n, t_mel), np.float32)
        wav = np.zeros((n, t_wav), np.float32)
        for i in range(n):
            tl = min(int(arena.text_lens[i]), t_text)
            ml = min(int(arena.mel_lens[i]), t_mel)
            wl = min(int(arena.wav_lens[i]), t_wav)
            x[i, :tl] = arena.text(i)[:tl]
            mel[i, :, :ml] = arena.mel(i)[:, :ml]
            pitch[i, :ml] = arena.pitch(i)[:ml]
            energy[i, :ml] = arena.energy(i)[:ml]
            wav[i, :wl] = arena.wav(i)[:wl]
        np.clip(wav, -1.0, 1.0, out=wav)
        pitch[pitch <= float(f_min // 3.5)] = 0.0
        if do_normalize:
            s = statistics
            mel = (mel - s.mel_mean) / s.mel_std
            pitch = (pitch - s.pitch_mean) / s.pitch_std
            energy = (energy - s.energy_mean) / s.energy_std
        self.wav_scale = None
        if wav_dtype == "int16":
            wav = np.clip(wav * 32767.0, -32768, 32767).astype(np.int16)
            self.wav_scale = 1.0 / 32767.0
        has_sids = bool((arena.sids >= 0).all())
        has_lids = bool((arena.lids >= 0).all())
        sids, lids = arena.sids, arena.lids
        arena.close()

        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
        self.x = put(x)
        # rounded to bf16 on the host, so the card never holds the float32 arena
        self.mel = (put(mel) if mel_dtype == "float32"
                    else torch.from_numpy(mel).to(torch.bfloat16).to(self.device))
        self.pitch = put(pitch)
        self.energy = put(energy)
        self.wav = put(wav)
        self.d_text_lens = put(np.minimum(self.text_lens, t_text).astype(np.int32))
        self.d_mel_lens = put(np.minimum(self.mel_lens, t_mel).astype(np.int32))
        self.d_sids = put(sids) if has_sids else None
        self.d_lids = put(lids) if has_lids else None
        self.arena_bytes = sum(getattr(self, k).numel() * getattr(self, k).element_size()
                               for k in ARENA_KEYS)
        log.info(f"Device feature cache: {n} items, arenas ({t_text} text, {t_mel} mel, "
                 f"{t_wav} wav) = {self.arena_bytes / 1e9:.3f} GB on {self.device}")

    def arenas(self) -> dict:
        d = dict(x=self.x, mel=self.mel, pitch=self.pitch, energy=self.energy, wav=self.wav,
                 text_lens=self.d_text_lens, mel_lens=self.d_mel_lens)
        if self.d_sids is not None:
            d["sids"] = self.d_sids
        if self.d_lids is not None:
            d["lids"] = self.d_lids
        return d

    def gather(self, idx, start_idx, t_text: int, t_mel: int, segment_size: int) -> dict:
        return gather_arenas(self.arenas(), idx, start_idx, t_text, t_mel, segment_size,
                             self.hop_length, self.wav_scale)


def gather_arenas(arenas: dict, idx: torch.Tensor, start_idx: torch.Tensor, t_text: int,
                  t_mel: int, segment_size: int, hop_length: int,
                  wav_scale: Optional[float] = None) -> dict:
    """A training batch gathered on the arenas' device.

    idx: (B,) item indices; start_idx: (B,) segment starts in mel frames;
    t_text/t_mel: the batch's bucketed lengths; segment_size: the GAN
    segment in mel frames (clamped to t_mel). The waveform segment is one
    flat gather whose positions are clipped to the arena's width, as
    `ops/segments.py::host_slice_wav_segments` clips them. Entries without
    speaker or language ids are left out rather than set to None."""
    idx = idx.long()
    seg = min(segment_size, t_mel)
    wav = arenas["wav"]
    t_wav_full = wav.shape[1]
    pos = (start_idx.long()[:, None] * hop_length
           + torch.arange(seg * hop_length, device=wav.device)[None, :])
    pos = torch.clamp(pos, 0, t_wav_full - 1)
    wav_seg = torch.take(wav, idx[:, None] * t_wav_full + pos)
    if wav_scale is not None:
        wav_seg = wav_seg.float() * wav_scale
    batch = dict(
        x=arenas["x"].index_select(0, idx)[:, :t_text],
        x_lengths=torch.clamp(arenas["text_lens"].index_select(0, idx), max=t_text),
        mel=arenas["mel"].index_select(0, idx)[:, :, :t_mel],
        mel_lengths=torch.clamp(arenas["mel_lens"].index_select(0, idx), max=t_mel),
        pitches=arenas["pitch"].index_select(0, idx)[:, :t_mel],
        energies=arenas["energy"].index_select(0, idx)[:, :t_mel],
        start_idx=start_idx, wav_seg=wav_seg)
    for key in ("sids", "lids"):
        if key in arenas:
            batch[key] = arenas[key].index_select(0, idx)
    return batch


class _LenTable:
    def __init__(self, text_lens, mel_lens):
        self.text_lens = text_lens
        self.mel_lens = mel_lens

    def __len__(self):
        return len(self.text_lens)


class DeviceCacheLoader(PackedLoader):
    """`PackedLoader`'s batch order, shard slicing and resume contract over a
    DeviceFeatureCache, yielding light batches {idx, t_text, t_mel,
    mel_lengths}: the device assembles the rest. t_text/t_mel come from the
    global batch, so every shard has the same shapes."""

    def __init__(self, cache: DeviceFeatureCache, batch_size: int, text_bucket: int,
                 mel_bucket: int, **kwargs):
        super().__init__(_LenTable(cache.text_lens, cache.mel_lens), batch_size, text_bucket,
                         mel_bucket, **kwargs)
        self.cache = cache

    def __iter__(self):
        for bat in self._batch_indices()[self._pos:]:
            t_text = int(self.ds.text_lens[bat].max())
            t_mel = int(self.ds.mel_lens[bat].max())
            if self.max_text_len:
                t_text = min(t_text, self.max_text_len)
            if self.max_mel_len:
                t_mel = min(t_mel, self.max_mel_len)
            t_text = min(round_up_to_bucket(t_text, self.text_bucket), self.cache.t_text_max)
            t_mel = min(round_up_to_bucket(t_mel, self.mel_bucket), self.cache.t_mel_max)
            if self.num_shards > 1:
                bat = self._shard(bat)
            self._pos += 1
            yield {"idx": np.ascontiguousarray(bat, np.int32), "t_text": t_text, "t_mel": t_mel,
                   "mel_lengths": np.minimum(self.ds.mel_lens[bat], t_mel).astype(np.int32)}
        self.epoch += 1
        self._pos = 0
