"""Dataset + bucketed collation (the port's own copy of
`optispeech_tpu/data/datamodule.py`, numpy only).

Per-utterance `.json` (phoneme_ids, text, sid, lid) + `.npz` (wav, mel,
energy, pitch) files, sub-threshold pitch zeroing (uv_threshold = f_min/3.5),
dataset-statistics normalization of mel/energy/pitch. The collate pads to
bucket boundaries, so the steps see a handful of shapes, and batches are
length-grouped to cut padding waste. A background thread prefetches
collated batches. For the same seed and epoch the batch order is the JAX
package's.
"""

import json
import queue
import random
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from ..config import DataStatistics
from ..utils.bucketing import round_up_to_bucket


def parse_filelist(filelist_path):
    paths = Path(filelist_path).read_text(encoding="utf-8").splitlines()
    return [p for p in paths if p.strip()]


class TextWavDataset:
    """Reads the reference's preprocessed datafile format directly."""

    def __init__(self, filelist_path, f_min: float = 80.0, seed: Optional[int] = None):
        self.file_paths = parse_filelist(filelist_path)
        self.uv_threshold = f_min // 3.5
        if seed is not None:
            rnd = random.Random(seed)
            rnd.shuffle(self.file_paths)

    def __len__(self):
        return len(self.file_paths)

    def __getitem__(self, index):
        filepath = Path(self.file_paths[index])
        with open(filepath.with_suffix(".json"), encoding="utf-8") as f:
            meta = json.load(f)
        arrays = np.load(filepath.with_suffix(".npz"), allow_pickle=False)
        pitch = arrays["pitch"].astype(np.float32).copy()
        pitch[pitch <= self.uv_threshold] = 0.0
        return dict(
            x=np.asarray(meta["phoneme_ids"], np.int32),
            wav=arrays["wav"].astype(np.float32),
            mel=arrays["mel"].astype(np.float32),
            energy=arrays["energy"].astype(np.float32),
            pitch=pitch,
            sid=meta.get("sid"),
            lid=meta.get("lid"),
            text=meta.get("text", ""),
            filepath=str(filepath),
        )


class SyntheticDataset:
    """Deterministic synthetic utterances for tests and smoke runs."""

    def __init__(self, n_items=64, n_feats=100, hop_length=256, seed=0,
                 text_range=(24, 96), mel_range=(120, 480)):
        self.rng = np.random.default_rng(seed)
        self.items = []
        for _ in range(n_items):
            t_text = int(self.rng.integers(*text_range))
            t_mel = int(self.rng.integers(*mel_range))
            self.items.append(dict(
                x=self.rng.integers(3, 150, t_text).astype(np.int32),
                wav=(self.rng.normal(size=t_mel * hop_length) * 0.1).astype(np.float32),
                mel=self.rng.normal(size=(n_feats, t_mel)).astype(np.float32),
                energy=np.abs(self.rng.normal(size=t_mel)).astype(np.float32) * 20,
                pitch=np.abs(self.rng.normal(size=t_mel) * 50 + 200).astype(np.float32),
                sid=None, lid=None, text="synthetic", filepath=f"synthetic://{_}",
            ))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class BucketedCollate:
    """Zero-pad a list of items into one batch at bucket-rounded static shapes
    and apply dataset-statistics normalization (`do_normalize=False` leaves
    the features raw, as `cli/stats.py` needs them)."""

    def __init__(self, n_feats: int, statistics: DataStatistics, hop_length: int,
                 text_bucket: int = 32, mel_bucket: int = 128,
                 max_text_len: Optional[int] = None, max_mel_len: Optional[int] = None,
                 do_normalize: bool = True):
        self.n_feats = n_feats
        self.stats = statistics
        self.hop_length = hop_length
        self.text_bucket = text_bucket
        self.mel_bucket = mel_bucket
        self.max_text_len = max_text_len
        self.max_mel_len = max_mel_len
        self.do_normalize = do_normalize

    def __call__(self, batch: list[dict], t_text: Optional[int] = None,
                 t_mel: Optional[int] = None) -> dict:
        """`t_text`/`t_mel` force the padded lengths (before bucket
        rounding): the shards of one global batch all pad to the global
        batch's longest item, so that every rank steps at one shape."""
        b = len(batch)
        for item in batch:  # clamp overly long utterances to the caps
            if self.max_text_len:
                item["x"] = item["x"][: self.max_text_len]
            if self.max_mel_len:
                item["mel"] = item["mel"][:, : self.max_mel_len]
                item["energy"] = item["energy"][: self.max_mel_len]
                item["pitch"] = item["pitch"][: self.max_mel_len]
                item["wav"] = item["wav"][: self.max_mel_len * self.hop_length]

        t_text = t_text or max(i["x"].shape[-1] for i in batch)
        t_mel = t_mel or max(i["mel"].shape[-1] for i in batch)
        if self.max_text_len:
            t_text = min(t_text, self.max_text_len)
        if self.max_mel_len:
            t_mel = min(t_mel, self.max_mel_len)
        t_text = round_up_to_bucket(t_text, self.text_bucket)
        t_mel = round_up_to_bucket(t_mel, self.mel_bucket)
        t_wav = t_mel * self.hop_length

        x = np.zeros((b, t_text), np.int32)
        wav = np.zeros((b, t_wav), np.float32)
        mel = np.zeros((b, self.n_feats, t_mel), np.float32)
        pitches = np.zeros((b, t_mel), np.float32)
        energies = np.zeros((b, t_mel), np.float32)
        x_lengths = np.zeros(b, np.int32)
        wav_lengths = np.zeros(b, np.int32)
        mel_lengths = np.zeros(b, np.int32)
        sids, lids, texts, filepaths = [], [], [], []
        for i, item in enumerate(batch):
            xl, ml, wl = item["x"].shape[-1], item["mel"].shape[-1], item["wav"].shape[-1]
            wl = min(wl, t_wav)
            x[i, :xl] = item["x"]
            wav[i, :wl] = item["wav"][:wl]
            mel[i, :, :ml] = item["mel"]
            energies[i, : item["energy"].shape[-1]] = item["energy"]
            pitches[i, : item["pitch"].shape[-1]] = item["pitch"]
            x_lengths[i], mel_lengths[i], wav_lengths[i] = xl, ml, wl
            if item["sid"] is not None:
                sids.append(item["sid"])
            if item["lid"] is not None:
                lids.append(item["lid"])
            texts.append(item.get("text", ""))
            filepaths.append(item.get("filepath", ""))

        sids_arr = np.asarray(sids, np.int32) if sids else None
        lids_arr = np.asarray(lids, np.int32) if lids else None
        if sids_arr is not None:
            assert sids_arr.shape[0] == b, "Not all speaker IDs are provided"
        if lids_arr is not None:
            assert lids_arr.shape[0] == b, "Not all language IDs are provided"

        if self.do_normalize:
            s = self.stats
            wav = wav.clip(-1, 1)
            mel = (mel - s.mel_mean) / s.mel_std
            energies = (energies - s.energy_mean) / s.energy_std
            pitches = (pitches - s.pitch_mean) / s.pitch_std

        return dict(
            x=x, wav=wav, mel=mel,
            x_lengths=x_lengths, wav_lengths=wav_lengths, mel_lengths=mel_lengths,
            energies=energies, pitches=pitches,
            sids=sids_arr, lids=lids_arr,
            x_texts=texts, filepaths=filepaths,
        )


class DataLoader:
    """Length-grouped, shuffled batching with a background prefetch thread.

    Data parallel: pass `shard_id=rank, num_shards=world`. Every rank
    computes the same global batch order (same seed and epoch), then
    collates only its `batch_size / num_shards` slice of each batch, padded
    to the global batch's lengths (`_collate_shard`), so that the shards of
    the ranks put together are the global batch. A partial batch kept with
    `drop_last=False` is padded by wrapping its items, so no shard is short
    or empty.

    Resume: `state_dict()/load_state_dict()` capture (epoch, position) so a
    restored run continues from the exact batch it stopped at."""

    def __init__(self, dataset, batch_size: int, collate: BucketedCollate,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 length_group_size: int = 8, prefetch: int = 2,
                 shard_id: int = 0, num_shards: int = 1):
        if batch_size % num_shards:
            raise ValueError(f"global batch_size {batch_size} must be divisible by "
                             f"num_shards {num_shards}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.length_group_size = length_group_size
        self.prefetch = prefetch
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.epoch = 0
        self._pos = 0  # batches already consumed in the current epoch
        # (text_len, mel_len) per item, filled lazily: batch grouping needs
        # only lengths, so items are loaded once for the cache, not per epoch
        self._len_cache: dict[int, tuple[int, int]] = {}

    def _lengths_of(self, i: int) -> tuple[int, int]:
        if i not in self._len_cache:
            item = self.dataset[i]
            self._len_cache[i] = (item["x"].shape[-1], item["mel"].shape[-1])
        return self._len_cache[i]

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "pos": self._pos, "seed": self.seed}

    def load_state_dict(self, state: dict):
        self.epoch = int(state["epoch"])
        self._pos = int(state["pos"])
        self.seed = int(state.get("seed", self.seed))

    def _batch_indices(self):
        n = len(self.dataset)
        idx = list(range(n))
        rnd = random.Random(self.seed + self.epoch)
        if self.shuffle:
            rnd.shuffle(idx)
        # group nearby-length items into mega-chunks, sort inside, emit batches
        group = self.batch_size * self.length_group_size
        batches = []
        for start in range(0, n, group):
            chunk = idx[start : start + group]
            chunk.sort(key=lambda i: self._lengths_of(i)[1])
            for bstart in range(0, len(chunk), self.batch_size):
                bat = chunk[bstart : bstart + self.batch_size]
                if len(bat) == self.batch_size or not self.drop_last:
                    if self.num_shards > 1 and len(bat) < self.batch_size:
                        # equal, non-empty shards: wrap the partial batch
                        bat = (bat * -(-self.batch_size // len(bat)))[: self.batch_size]
                    batches.append(bat)
        if self.shuffle:
            rnd.shuffle(batches)
        return batches  # global batches; `_collate_shard` slices them

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _collate_shard(self, bat: list[int]) -> dict:
        """This shard's slice of the global batch `bat`, padded to the global
        batch's longest text and mel (from the length cache: only the
        slice's items are read in full)."""
        if self.num_shards == 1:
            return self.collate([self.dataset[i] for i in bat])
        lens = [self._lengths_of(i) for i in bat]
        local = self.batch_size // self.num_shards
        lo = self.shard_id * local
        items = [self.dataset[i] for i in bat[lo:lo + local]]
        return self.collate(items, t_text=max(n[0] for n in lens),
                            t_mel=max(n[1] for n in lens))

    def __iter__(self) -> Iterator[dict]:
        batches = self._batch_indices()[self._pos :]
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def worker():
            for bat in batches:
                q.put(self._collate_shard(bat))
            q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            self._pos += 1
            yield item
        self.epoch += 1
        self._pos = 0
