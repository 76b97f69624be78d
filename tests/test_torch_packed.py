"""The port's packed data path (data/packed.py, csrc/packed_dataset.cpp,
cli/pack.py) against the JAX package on the CPU: the arena bytes equal JAX's
`pack_dataset`'s, the host collator's batches equal JAX's and the port's
`BucketedCollate` exactly, the batch order equals JAX's `PackedLoader`'s
for one and two shards, resume equals an uninterrupted run, and a compiler
that fails raises.

JAX's native library is never asked for (its build runs `make` in native/):
the JAX side is its pure-Python writer, its collate, and its loader's
order over a length table."""

import numpy as np
import pytest

from optispeech_tpu import config as jax_config
from optispeech_tpu.data import datamodule as jax_dm
from optispeech_tpu.data import packed as jax_packed
from optispeech_tpu.data.device_cache import _LenTable as JaxLenTable
from optispeech_tpu_torch import config as torch_config
from optispeech_tpu_torch.data import datamodule as torch_dm
from optispeech_tpu_torch.data.packed import PackedDataset, PackedLoader, pack_dataset
from torch_packed_data import HOP, N_FEATS, statistics, write_datafiles

KEYS = ("x", "wav", "mel", "pitches", "energies", "x_lengths", "mel_lengths", "wav_lengths")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("packed")
    filelist = write_datafiles(root, n=12)
    pak = pack_dataset(str(filelist), str(root / "train.pak"), N_FEATS, HOP)
    return root, filelist, pak


def _assert_same(got, want, keys=KEYS):
    for k in keys:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("speakers", [False, True])
def test_pak_bytes_equal_jax(tmp_path, speakers):
    filelist = write_datafiles(tmp_path, n=7, speakers=speakers)
    ours = pack_dataset(str(filelist), str(tmp_path / "ours.pak"), N_FEATS, HOP)
    theirs = jax_packed.pack_dataset(str(filelist), str(tmp_path / "jax.pak"), N_FEATS, HOP)
    assert open(ours, "rb").read() == open(theirs, "rb").read()


@pytest.mark.parametrize("override", [False, True])
def test_assemble_equals_bucketed_collate(data, override):
    """Every array bit for bit against JAX's collate and the port's, with
    and without the padded-length override."""
    _, filelist, pak = data
    stats = statistics(torch_config.DataStatistics)
    ds = PackedDataset(pak, stats, f_min=80.0)
    idx = np.array([3, 0, 7, 10, 5])
    pad = dict(t_text=37, t_mel=100) if override else {}
    got = ds.assemble(idx, text_bucket=16, mel_bucket=32, **pad)
    assert got["mel"].shape == (5, N_FEATS, 128 if override else 96)

    jax_ds = jax_dm.TextWavDataset(str(filelist), f_min=80.0)
    jax_collate = jax_dm.BucketedCollate(N_FEATS, statistics(jax_config.DataStatistics), HOP,
                                         text_bucket=16, mel_bucket=32)
    _assert_same(got, jax_collate([jax_ds[i] for i in idx], **pad))
    ds_t = torch_dm.TextWavDataset(str(filelist), f_min=80.0)
    collate = torch_dm.BucketedCollate(N_FEATS, stats, HOP, text_bucket=16, mel_bucket=32)
    _assert_same(got, collate([ds_t[i] for i in idx], **pad))
    assert got["sids"] is None and got["lids"] is None


def test_assemble_speakers_and_caps(tmp_path):
    """Speaker and language ids come through; caps at bucket multiples equal
    the collate's truncation."""
    filelist = write_datafiles(tmp_path, n=6, speakers=True, mel_range=(60, 90))
    pak = pack_dataset(str(filelist), str(tmp_path / "s.pak"), N_FEATS, HOP)
    stats = statistics(torch_config.DataStatistics)
    got = PackedDataset(pak, stats).assemble(np.arange(6), 16, 32, max_text_len=16,
                                             max_mel_len=64)
    jax_ds = jax_dm.TextWavDataset(str(filelist), f_min=80.0)
    want = jax_dm.BucketedCollate(N_FEATS, statistics(jax_config.DataStatistics), HOP, 16, 32,
                                  max_text_len=16, max_mel_len=64)([jax_ds[i] for i in range(6)])
    _assert_same(got, want, KEYS + ("sids", "lids"))
    assert got["mel"].shape[-1] == 64 and got["mel_lengths"].max() == 64


@pytest.mark.parametrize("num_shards,drop_last", [(1, True), (2, True), (2, False), (1, False)])
def test_batch_order_equals_jax(data, num_shards, drop_last):
    """The global batches are JAX's `PackedLoader._batch_indices` over the same
    lengths, seed and epoch (13 items: a partial batch, wrapped for shards)."""
    _, _, pak = data
    ds = PackedDataset(pak, statistics(torch_config.DataStatistics))
    lens = JaxLenTable(np.concatenate([ds.text_lens, ds.text_lens[:1]]),
                       np.concatenate([ds.mel_lens, ds.mel_lens[:1]]))
    for epoch in (0, 1):
        kw = dict(shuffle=True, seed=5, drop_last=drop_last, length_group_size=2,
                  num_shards=num_shards)
        ours = PackedLoader(lens, 4, 16, 32, **kw)
        theirs = jax_packed.PackedLoader(lens, 4, 16, 32, **kw)
        ours.epoch = theirs.epoch = epoch
        a, b = ours._batch_indices(), theirs._batch_indices()
        assert len(a) == len(b) == (3 if drop_last else 4)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_shards_concatenate_to_the_global_batch(data):
    _, _, pak = data
    ds = PackedDataset(pak, statistics(torch_config.DataStatistics))
    mk = lambda sid, n: PackedLoader(ds, 4, 16, 32, shuffle=True, seed=5,  # noqa: E731
                                     shard_id=sid, num_shards=n)
    for g, a, b in zip(mk(0, 1), mk(0, 2), mk(1, 2)):
        for key in KEYS:
            assert a[key].shape == b[key].shape, key
            np.testing.assert_array_equal(np.concatenate([a[key], b[key]]), g[key], err_msg=key)


def test_resume_equals_an_uninterrupted_run(data):
    _, _, pak = data
    ds = PackedDataset(pak, statistics(torch_config.DataStatistics))
    mk = lambda: PackedLoader(ds, 4, 16, 32, shuffle=True, seed=5)  # noqa: E731
    uninterrupted = mk()
    full = list(uninterrupted) + list(uninterrupted)  # two epochs
    loader = mk()
    it = iter(loader)
    next(it), next(it)
    saved = loader.state_dict()
    assert saved == {"epoch": 0, "pos": 2, "seed": 5}
    resumed = mk()
    resumed.load_state_dict(saved)
    rest = list(resumed) + list(resumed)
    assert len(rest) == len(full) - 2
    for got, want in zip(rest, full[2:]):
        _assert_same(got, want)
    assert resumed.state_dict() == {"epoch": 2, "pos": 0, "seed": 5}


def test_loader_yields_bucketed_finite_batches(data):
    _, _, pak = data
    ds = PackedDataset(pak, statistics(torch_config.DataStatistics))
    loader = PackedLoader(ds, 4, 16, 32, shuffle=False, drop_last=False)
    batches = list(loader)
    assert len(batches) == len(loader) == 3
    assert sorted(np.concatenate([b["mel_lengths"] for b in batches])) == sorted(ds.mel_lens)
    for b in batches:
        assert b["x"].shape[1] % 16 == 0 and b["mel"].shape[2] % 32 == 0
        assert b["wav"].shape[1] == b["mel"].shape[2] * HOP
        assert all(np.isfinite(b[k]).all() for k in ("wav", "mel", "pitches", "energies"))
        assert np.abs(b["wav"]).max() <= 1.0


def test_cli_pack_writes_the_arena(data, tmp_path):
    from optispeech_tpu_torch.cli.pack import main

    _, filelist, pak = data
    out = tmp_path / "cli.pak"
    assert main([str(filelist), str(out), "data.features.n_feats=20",
                 "data.features.hop_length=64"]) == 0
    assert out.read_bytes() == open(pak, "rb").read()


@pytest.mark.parametrize("cxx", ["false", "/nonexistent/c++"])
def test_a_failing_compiler_raises(data, monkeypatch, cxx):
    """No fallback: a host compiler that fails or is missing raises, with
    its output, when the dataset opens."""
    from optispeech_tpu_torch.ops import _build

    _, _, pak = data
    monkeypatch.setenv("CXX", cxx)
    monkeypatch.setattr(_build, "_LIBRARIES", {})
    with pytest.raises(RuntimeError, match="packed_dataset"):
        PackedDataset(pak, statistics(torch_config.DataStatistics))
    assert not _build.host_library_path("packed_dataset").exists()
