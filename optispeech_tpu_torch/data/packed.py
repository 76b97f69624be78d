"""The packed data path (port of `optispeech_tpu/data/packed.py`): one arena
file per split, written by `pack_dataset`, mmapped and collated by the host
C++ library `csrc/packed_dataset.cpp` (built into build/ at first use by
`ops/_build.py::load_host`).

`PackedDataset.assemble` pads, normalises and uv-thresholds a batch in
parallel C++ workers straight into numpy buffers; its arrays equal
`data/datamodule.py::BucketedCollate`'s bit for bit. `PackedLoader` orders
the batches as JAX's does (a pure function of the lengths, the seed and the
epoch), with the same shard slicing and resume contract.

There is no fallback: when the library does not build, the loader raises
with the compiler's output.
"""

import ctypes
import json
import struct
from pathlib import Path
from typing import Optional

import numpy as np

from ..config import DataStatistics
from ..utils.bucketing import round_up_to_bucket
from ..utils.pylogger import get_pylogger

log = get_pylogger(__name__)

_MAGIC = b"OSPK"
_HEADER = struct.Struct("<4sIQII8x")  # magic, version, n_items, n_feats, hop, reserved
_ITEM = struct.Struct("<QQQQQIIIiiI")
LIBRARY = "packed_dataset"  # csrc/packed_dataset.cpp


class _CStats(ctypes.Structure):
    _fields_ = [
        ("mel_mean", ctypes.c_float), ("mel_std", ctypes.c_float),
        ("energy_mean", ctypes.c_float), ("energy_std", ctypes.c_float),
        ("pitch_mean", ctypes.c_float), ("pitch_std", ctypes.c_float),
        ("uv_threshold", ctypes.c_float),
    ]


_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "pd_open": (ctypes.c_void_p, [ctypes.c_char_p]),
    "pd_close": (None, [ctypes.c_void_p]),
    "pd_num_items": (ctypes.c_uint64, [ctypes.c_void_p]),
    "pd_n_feats": (ctypes.c_uint32, [ctypes.c_void_p]),
    "pd_hop_length": (ctypes.c_uint32, [ctypes.c_void_p]),
    "pd_lengths": (None, [ctypes.c_void_p, _I64P, ctypes.c_int64, _I32P]),
    "pd_assemble_batch": (None, [
        ctypes.c_void_p, _I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(_CStats), ctypes.c_int, _I32P, _F32P, _F32P, _F32P, _F32P,
        _I32P, _I32P, _I32P, _I32P, _I32P, ctypes.c_int]),
}


def native_library() -> ctypes.CDLL:
    """The host collator, built on first use; raises when it does not build."""
    from ..ops import _build

    lib = _build.load_host(LIBRARY)
    for fn, (restype, argtypes) in _SIGNATURES.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def pack_dataset(filelist_path: str, output_path: str, n_feats: int, hop_length: int):
    """Convert the datafiles of a filelist (a .json and a .npz per utterance)
    into one packed arena file; returns `output_path`."""
    from .datamodule import parse_filelist

    paths = parse_filelist(filelist_path)
    records, blobs = [], []
    offset = _HEADER.size + _ITEM.size * len(paths)
    for p in paths:
        base = Path(p)
        with open(base.with_suffix(".json"), encoding="utf-8") as f:
            meta = json.load(f)
        arrays = np.load(base.with_suffix(".npz"), allow_pickle=False)
        text = np.asarray(meta["phoneme_ids"], np.int32)
        wav = arrays["wav"].astype(np.float32)
        mel = np.ascontiguousarray(arrays["mel"].astype(np.float32))
        pitch = arrays["pitch"].astype(np.float32)
        energy = arrays["energy"].astype(np.float32)
        if mel.shape[0] != n_feats:
            raise ValueError(f"{base}: mel rows {mel.shape[0]} != {n_feats}")
        mel_len = mel.shape[1]
        if pitch.shape[0] != mel_len or energy.shape[0] != mel_len:
            raise ValueError(f"{base}: pitch/energy lengths differ from the mel's {mel_len}")
        offs = []
        for arr in (text, wav, mel, pitch, energy):
            offs.append(offset)
            blobs.append(arr.tobytes())
            offset += arr.nbytes
        sid, lid = meta.get("sid"), meta.get("lid")
        records.append(_ITEM.pack(*offs, len(text), len(wav), mel_len,
                                  int(sid if sid is not None else -1),
                                  int(lid if lid is not None else -1), 0))
    with open(output_path, "wb") as f:
        f.write(_HEADER.pack(_MAGIC, 1, len(paths), n_feats, hop_length))
        for r in records:
            f.write(r)
        for b in blobs:
            f.write(b)
    log.info(f"Packed {len(paths)} utterances -> {output_path} ({offset / 1e6:.1f} MB)")
    return output_path


# ---------------------------------------------------------------------------
# Reader / loader
# ---------------------------------------------------------------------------

class PackedDataset:
    """A mmapped arena file with the host collator's batch assembly."""

    def __init__(self, path: str, statistics: DataStatistics, f_min: float = 80.0,
                 do_normalize: bool = True, n_threads: int = 8):
        self.lib = native_library()
        self.handle = self.lib.pd_open(str(path).encode())
        if not self.handle:
            raise IOError(f"cannot open packed dataset {path}")
        self.n_items = int(self.lib.pd_num_items(self.handle))
        self.n_feats = int(self.lib.pd_n_feats(self.handle))
        self.hop_length = int(self.lib.pd_hop_length(self.handle))
        self.stats = _CStats(statistics.mel_mean, statistics.mel_std,
                             statistics.energy_mean, statistics.energy_std,
                             statistics.pitch_mean, statistics.pitch_std,
                             float(f_min // 3.5))
        self.do_normalize = do_normalize
        self.n_threads = n_threads
        idxs = np.arange(self.n_items, dtype=np.int64)
        lens = np.zeros((self.n_items, 2), np.int32)
        self.lib.pd_lengths(self.handle, idxs.ctypes.data_as(_I64P), self.n_items,
                            lens.ctypes.data_as(_I32P))
        self.text_lens = lens[:, 0].copy()
        self.mel_lens = lens[:, 1].copy()

    def __len__(self):
        return self.n_items

    def __del__(self):
        if getattr(self, "handle", None) and getattr(self, "lib", None):
            self.lib.pd_close(self.handle)
            self.handle = None

    def assemble(self, indices, text_bucket: int, mel_bucket: int,
                 max_text_len: Optional[int] = None, max_mel_len: Optional[int] = None,
                 t_text: Optional[int] = None, t_mel: Optional[int] = None) -> dict:
        """The batch of `indices`, padded to the bucketed lengths of its
        longest item, or of `t_text`/`t_mel` when given (before rounding:
        the shards of one global batch pad to the global batch's lengths)."""
        indices = np.ascontiguousarray(indices, np.int64)
        n = len(indices)
        if n == 0 or indices.min() < 0 or indices.max() >= self.n_items:
            raise IndexError(f"indices must be a non-empty subset of [0, {self.n_items})")
        t_text = t_text or int(self.text_lens[indices].max())
        t_mel = t_mel or int(self.mel_lens[indices].max())
        if max_text_len:
            t_text = min(t_text, max_text_len)
        if max_mel_len:
            t_mel = min(t_mel, max_mel_len)
        t_text = round_up_to_bucket(t_text, text_bucket)
        t_mel = round_up_to_bucket(t_mel, mel_bucket)
        x = np.empty((n, t_text), np.int32)
        wav = np.empty((n, t_mel * self.hop_length), np.float32)
        mel = np.empty((n, self.n_feats, t_mel), np.float32)
        pitch = np.empty((n, t_mel), np.float32)
        energy = np.empty((n, t_mel), np.float32)
        xl, ml, wl, sids, lids = (np.empty(n, np.int32) for _ in range(5))
        i32 = lambda a: a.ctypes.data_as(_I32P)  # noqa: E731
        f32 = lambda a: a.ctypes.data_as(_F32P)  # noqa: E731
        self.lib.pd_assemble_batch(
            self.handle, indices.ctypes.data_as(_I64P), n, t_text, t_mel,
            ctypes.byref(self.stats), int(self.do_normalize),
            i32(x), f32(wav), f32(mel), f32(pitch), f32(energy),
            i32(xl), i32(ml), i32(wl), i32(sids), i32(lids), self.n_threads)
        return dict(x=x, wav=wav, mel=mel, pitches=pitch, energies=energy,
                    x_lengths=xl, mel_lengths=ml, wav_lengths=wl,
                    sids=sids if (sids >= 0).all() else None,
                    lids=lids if (lids >= 0).all() else None)


class PackedLoader:
    """Length-grouped shuffled loader over a PackedDataset (or any object
    with `text_lens`, `mel_lens` and `__len__`, for the order alone).

    Every shard computes the same global batch order and assembles only its
    `batch_size / num_shards` slice, padded to the global batch's lengths;
    `state_dict()` captures (epoch, position) so a restored run continues at
    the batch it stopped at."""

    def __init__(self, dataset, batch_size: int, text_bucket: int, mel_bucket: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 length_group_size: int = 8, max_text_len: Optional[int] = None,
                 max_mel_len: Optional[int] = None, shard_id: int = 0, num_shards: int = 1):
        if batch_size % num_shards:
            raise ValueError(f"global batch_size {batch_size} must be divisible by "
                             f"num_shards {num_shards}")
        self.ds = dataset
        self.batch_size = batch_size
        self.text_bucket = text_bucket
        self.mel_bucket = mel_bucket
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.length_group_size = length_group_size
        self.max_text_len = max_text_len
        self.max_mel_len = max_mel_len
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.epoch = 0
        self._pos = 0

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "pos": self._pos, "seed": self.seed}

    def load_state_dict(self, state: dict):
        self.epoch = int(state["epoch"])
        self._pos = int(state["pos"])
        self.seed = int(state.get("seed", self.seed))

    def __len__(self):
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_indices(self) -> list:
        """The epoch's global batches of item indices."""
        rng = np.random.default_rng(self.seed + self.epoch)
        idx = np.arange(len(self.ds))
        if self.shuffle:
            rng.shuffle(idx)
        group = self.batch_size * self.length_group_size
        batches = []
        for start in range(0, len(idx), group):
            chunk = idx[start:start + group]
            chunk = chunk[np.argsort(self.ds.mel_lens[chunk], kind="stable")]
            for b in range(0, len(chunk), self.batch_size):
                bat = chunk[b:b + self.batch_size]
                if len(bat) == self.batch_size or not self.drop_last:
                    if self.num_shards > 1 and len(bat) < self.batch_size:
                        # shards need equal, non-empty slices: wrap the partial batch
                        bat = np.resize(bat, self.batch_size)
                    batches.append(bat)
        if self.shuffle:
            rng.shuffle(batches)
        return batches

    def _shard(self, bat):
        local = self.batch_size // self.num_shards
        return bat[self.shard_id * local:(self.shard_id + 1) * local]

    def __iter__(self):
        for bat in self._batch_indices()[self._pos:]:
            t_text = t_mel = None
            if self.num_shards > 1:
                t_text = int(self.ds.text_lens[bat].max())
                t_mel = int(self.ds.mel_lens[bat].max())
                bat = self._shard(bat)
            self._pos += 1
            yield self.ds.assemble(bat, self.text_bucket, self.mel_bucket, self.max_text_len,
                                   self.max_mel_len, t_text=t_text, t_mel=t_mel)
        self.epoch += 1
        self._pos = 0
