"""The port's sharded host loader (data/datamodule.py: `DataLoader(shard_id,
num_shards)`, `BucketedCollate(t_text=, t_mel=)`) against the JAX
package's on the CPU: for 2 and 4 shards, every batch of every shard
equal bit for bit to JAX's, a partial validation batch wrapped as JAX
wraps it, and the shards of each global batch, put together, the one
batch that one process collates from the same items."""

import numpy as np
import pytest

from optispeech_tpu import config as jax_config
from optispeech_tpu.data import datamodule as jax_dm
from optispeech_tpu_torch import config as torch_config
from optispeech_tpu_torch.data import datamodule as torch_dm

KEYS = ("x", "wav", "mel", "pitches", "energies", "x_lengths", "mel_lengths", "wav_lengths")
N_FEATS, HOP, BATCH = 20, 64, 8
DATA = dict(n_feats=N_FEATS, hop_length=HOP, text_range=(8, 40), mel_range=(20, 90))
# train: 36 items, shuffled, partial batch dropped; val: 10 items in order,
# the partial batch of 2 kept (and wrapped to 8 for the shards)
SPLITS = {"train": dict(n_items=36, shuffle=True, drop_last=True),
          "val": dict(n_items=10, shuffle=False, drop_last=False)}


def loaders(split, shard_id, num_shards):
    spec = SPLITS[split]
    kw = dict(shuffle=spec["shuffle"], seed=3, drop_last=spec["drop_last"],
              length_group_size=2, shard_id=shard_id, num_shards=num_shards)
    ours = torch_dm.DataLoader(
        torch_dm.SyntheticDataset(spec["n_items"], seed=1, **DATA), BATCH,
        torch_dm.BucketedCollate(N_FEATS, torch_config.DataStatistics(), HOP, 16, 32), **kw)
    theirs = jax_dm.DataLoader(
        jax_dm.SyntheticDataset(spec["n_items"], seed=1, **DATA), BATCH,
        jax_dm.BucketedCollate(N_FEATS, jax_config.DataStatistics(), HOP, 16, 32), **kw)
    return ours, theirs


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("num_shards", [2, 4])
def test_shards_equal_jax_and_make_the_global_batch(split, num_shards):
    shards = []
    for shard_id in range(num_shards):
        ours, theirs = loaders(split, shard_id, num_shards)
        got_epochs = []
        for _ in range(2):  # two epochs: the order moves with the epoch
            got = list(ours)
            want = list(theirs)
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert g["x"].shape[0] == BATCH // num_shards
                for k in KEYS:
                    assert g[k].dtype == w[k].dtype, k
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            got_epochs.append(got)
        shards.append(got_epochs)
    # the shards put together are one process's collate of each global batch
    ours, _ = loaders(split, 0, num_shards)
    one = torch_dm.BucketedCollate(N_FEATS, torch_config.DataStatistics(), HOP, 16, 32)
    for epoch in range(2):
        ours.epoch = epoch
        for n, bat in enumerate(ours._batch_indices()):
            assert len(bat) == BATCH
            want = one([ours.dataset[i] for i in bat])
            for k in KEYS:
                got = np.concatenate([shards[s][epoch][n][k] for s in range(num_shards)])
                np.testing.assert_array_equal(got, want[k], err_msg=k)
    if split == "val":  # 10 items: one full batch, then 2 items wrapped to 8
        tail = ours._batch_indices()[-1]
        assert len(set(tail)) == 2 and tail == (tail[:2] * 4)


def test_shards_need_a_divisible_batch():
    with pytest.raises(ValueError, match="must be divisible by num_shards 3"):
        loaders("train", 0, 3)
