"""The port's device-resident feature cache (data/device_cache.py), its
cached train steps (training/step.py) and the trainer's cached path against
the JAX package on the CPU: the arena reads and the gathered batches equal
JAX's for float32, bfloat16 mel and int16 wav arenas, long items are
truncated, the loader's order and shard cover equal JAX's, a cached train
step equals JAX's from the same weights, the trainer's cached path equals
its host path, and a scan of two steps equals two steps.

JAX's native library is never asked for: the JAX side is its pure-Python
arena reader and device cache."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optispeech_tpu import config as jax_config
from optispeech_tpu.data import device_cache as jax_cache
from optispeech_tpu_torch import config as torch_config
from optispeech_tpu_torch.data.device_cache import (
    DeviceCacheLoader,
    DeviceFeatureCache,
    PackedArena,
    gather_arenas,
)
from optispeech_tpu_torch.data.packed import PackedDataset, PackedLoader, pack_dataset
from optispeech_tpu_torch.ops.segments import host_sample_segment_starts, host_slice_wav_segments
from test_train_step import tiny_experiment
from torch_packed_data import HOP, N_FEATS, statistics, write_datafiles
from torch_parity import no_dropout, to_torch_config, train_setup

torch.set_num_threads(1)

# logs of one step: float32 with other summation orders (tests/test_torch_train_step.py)
LOG_RTOL = 1e-4
BATCH_KEYS = ("x", "x_lengths", "mel", "mel_lengths", "pitches", "energies", "wav_seg")


@pytest.fixture(scope="module")
def pak(tmp_path_factory):
    root = tmp_path_factory.mktemp("cache")
    filelist = write_datafiles(root, n=12, speakers=True)
    return pack_dataset(str(filelist), str(root / "t.pak"), N_FEATS, HOP)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    from optispeech_tpu_torch.training import loggers

    monkeypatch.setitem(loggers._SINK_REGISTRY, "tensorboard", lambda *args: None)


def _caches(pak, **kw):
    ours = DeviceFeatureCache(pak, statistics(torch_config.DataStatistics), device="cpu", **kw)
    theirs = jax_cache.DeviceFeatureCache(pak, statistics(jax_config.DataStatistics), **kw)
    return ours, theirs


def _np(v):
    if isinstance(v, torch.Tensor):
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)


def test_arena_reads_equal_jax(pak):
    ours, theirs = PackedArena(pak), jax_cache.PackedArena(pak)
    assert (ours.n_items, ours.n_feats, ours.hop_length) == (12, N_FEATS, HOP)
    for name in ("text_lens", "wav_lens", "mel_lens", "sids", "lids"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name))
    for i in range(ours.n_items):
        for name in ("text", "wav", "mel", "pitch", "energy"):
            np.testing.assert_array_equal(getattr(ours, name)(i), getattr(theirs, name)(i))
    ours.close()
    theirs.close()


@pytest.mark.parametrize("mel_dtype,wav_dtype", [("float32", "float32"), ("bfloat16", "float32"),
                                                 ("float32", "int16")])
def test_gather_equals_jax(pak, mel_dtype, wav_dtype):
    ours, theirs = _caches(pak, text_bucket=16, mel_bucket=32, mel_dtype=mel_dtype,
                           wav_dtype=wav_dtype)
    assert (ours.t_text_max, ours.t_mel_max) == (theirs.t_text_max, theirs.t_mel_max)
    assert ours.mel.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[mel_dtype]
    assert ours.arena_bytes == theirs.arena_bytes
    for name in ("x", "mel", "pitch", "energy", "wav"):
        np.testing.assert_array_equal(_np(getattr(ours, name)), _np(getattr(theirs, name)))
    idx = np.array([3, 0, 7, 10, 11], np.int32)
    start = np.array([0, 5, 60, 2, 200], np.int32)  # the last clips at the arena's end
    got = ours.gather(torch.from_numpy(idx), torch.from_numpy(start), 32, 96, 16)
    want = theirs.gather(jnp.asarray(idx), jnp.asarray(start), 32, 96, 16)
    for k in BATCH_KEYS + ("sids", "lids"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)


def test_gather_equals_the_packed_host_path(pak):
    """The cached batch is the host collator's batch with `_segment_batch`'s
    crop: the same bits."""
    stats = statistics(torch_config.DataStatistics)
    cache = DeviceFeatureCache(pak, stats, device="cpu", text_bucket=16, mel_bucket=32)
    idx = np.array([3, 0, 7, 10])
    host = PackedDataset(pak, stats).assemble(idx, 16, 32)
    start = host_sample_segment_starts(np.random.default_rng(11), host["mel_lengths"], 24)
    host["wav_seg"] = host_slice_wav_segments(host["wav"], start, 24, HOP)
    got = cache.gather(torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(start),
                       host["x"].shape[1], host["mel"].shape[2], 24)
    for k in BATCH_KEYS + ("sids", "lids"):
        np.testing.assert_array_equal(got[k].numpy(), host[k], err_msg=k)


def test_long_items_are_truncated(pak):
    """max_text_len / max_mel_len clamp the arenas' widths (to the buckets
    above them), the lengths and the gathered features, as JAX's cache and
    the host collator do."""
    ours, theirs = _caches(pak, text_bucket=16, mel_bucket=32, max_text_len=12, max_mel_len=48)
    assert (ours.t_text_max, ours.t_mel_max) == (theirs.t_text_max, theirs.t_mel_max) == (16, 64)
    assert ours.mel_lens.max() > 64 and int(ours.d_mel_lens.max()) == 64
    idx = np.arange(12, dtype=np.int32)
    got = ours.gather(torch.from_numpy(idx), torch.zeros(12, dtype=torch.int32), 16, 64, 16)
    want = theirs.gather(jnp.asarray(idx), jnp.zeros(12, jnp.int32), 16, 64, 16)
    host = PackedDataset(pak, statistics(torch_config.DataStatistics)).assemble(
        idx, 16, 32, max_text_len=12, max_mel_len=48)
    for k in BATCH_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        if k != "wav_seg":
            np.testing.assert_array_equal(got[k].numpy(), host[k], err_msg=k)


@pytest.mark.parametrize("num_shards", [1, 2])
def test_loader_order_and_shards_equal_jax(pak, num_shards):
    """JAX's DeviceCacheLoader's light batches, shard by shard, and the same
    resume; the shards cover the global batch at one (t_text, t_mel)."""
    ours, theirs = _caches(pak, text_bucket=16, mel_bucket=32, max_mel_len=80)
    kw = dict(shuffle=True, seed=3, max_mel_len=80, num_shards=num_shards)
    for shard in range(num_shards):
        a = list(DeviceCacheLoader(ours, 4, 16, 32, shard_id=shard, **kw))
        b = list(jax_cache.DeviceCacheLoader(theirs, 4, 16, 32, shard_id=shard, **kw))
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            assert (x["t_text"], x["t_mel"]) == (y["t_text"], y["t_mel"])
            for k in ("idx", "mel_lengths"):
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k])
    glob = list(DeviceCacheLoader(ours, 4, 16, 32, shuffle=True, seed=3, max_mel_len=80))
    shards = [list(DeviceCacheLoader(ours, 4, 16, 32, shard_id=s, **kw))
              for s in range(num_shards)]
    for g, *parts in zip(glob, *shards):
        np.testing.assert_array_equal(np.concatenate([p["idx"] for p in parts]), g["idx"])
        assert all((p["t_text"], p["t_mel"]) == (g["t_text"], g["t_mel"]) for p in parts)
    loader = DeviceCacheLoader(ours, 4, 16, 32, **kw)
    next(iter(loader))
    resumed = DeviceCacheLoader(ours, 4, 16, 32, **kw)
    resumed.load_state_dict(loader.state_dict())
    rest = list(resumed)
    assert len(rest) == 2 and np.array_equal(rest[0]["idx"], shards[0][1]["idx"])


def test_light_batches_match_the_packed_loader(pak):
    """Same seed: the light batches name the host loader's items at its
    padded shapes."""
    stats = statistics(torch_config.DataStatistics)
    cache = DeviceFeatureCache(pak, stats, device="cpu", text_bucket=16, mel_bucket=32)
    ds = PackedDataset(pak, stats)
    light = list(DeviceCacheLoader(cache, 4, 16, 32, shuffle=True, seed=3))
    heavy = list(PackedLoader(ds, 4, 16, 32, shuffle=True, seed=3))
    for lb, hb in zip(light, heavy):
        assert lb["t_text"] == hb["x"].shape[1] and lb["t_mel"] == hb["mel"].shape[2]
        np.testing.assert_array_equal(lb["mel_lengths"], hb["mel_lengths"])
        np.testing.assert_array_equal(ds.assemble(lb["idx"], 16, 32)["x"], hb["x"])


def test_the_cache_lies_on_the_card_unless_asked(pak, monkeypatch, tmp_path):
    """Without a card and without a device, the cache and the packed
    training CLI raise rather than run on the CPU unasked."""
    from optispeech_tpu_torch.cli.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceFeatureCache(pak, statistics(torch_config.DataStatistics))
    for flags in ([], ["--device-cache"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--packed-train", pak, "--out-dir", str(tmp_path), "--no-print-config",
                  *flags])


def _cfg():
    cfg = no_dropout(tiny_experiment(pretraining_steps=0))
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, statistics=statistics(jax_config.DataStatistics), batch_size=4))


def test_cached_step_equals_jax(pak):
    """From the same weights, on the same (B, 2) indices and starts: the
    port's cached step against JAX's `make_cached_train_step`, every log
    within LOG_RTOL and the MAS durations equal."""
    from optispeech_tpu.training.step import make_cached_train_step as jax_cached_step
    from optispeech_tpu_torch.training.step import make_cached_train_step

    cfg = _cfg()
    jgen, jdisc, jstate, state = train_setup(cfg)
    ours, theirs = _caches(pak, text_bucket=16, mel_bucket=64)
    idx_start = np.stack([np.array([3, 0, 7, 10], np.int32),
                          np.array([0, 9, 20, 3], np.int32)], axis=1)
    t_text, t_mel = 32, 128

    batch = jax_cache.gather_arenas(theirs.arenas(), jnp.asarray(idx_start[:, 0]),
                                    jnp.asarray(idx_start[:, 1]), t_text, t_mel,
                                    cfg.generator.segment_size, HOP)
    forward = jax.jit(lambda p, b: jgen.apply(
        {"params": p}, b["x"], b["x_lengths"], b["mel"], b["mel_lengths"], b["pitches"],
        b["energies"], b["sids"], b["lids"], deterministic=True,
        start_idx=b["start_idx"])["durations"])
    jax_durations = np.asarray(forward(jstate.g_params, batch))
    _, jlogs = jax_cached_step(cfg, jgen, jdisc, theirs)(jstate, idx_start, t_text=t_text,
                                                         t_mel=t_mel)

    seen = []
    state.generator.register_forward_hook(lambda m, i, o: seen.append(o["durations"]))
    logs = make_cached_train_step(to_torch_config(cfg), ours, donate=True)(
        state, torch.from_numpy(idx_start), t_text=t_text, t_mel=t_mel)
    assert state.step == 1 and set(logs) == set(jlogs)
    np.testing.assert_array_equal(seen[0].numpy(), jax_durations)
    for k in jlogs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=LOG_RTOL, err_msg=k)


def _state(cfg, seed=0):
    from optispeech_tpu_torch.training.state import init_train_state

    return init_train_state(to_torch_config(cfg), "cpu", seed)


def test_scan_of_two_equals_two_steps(pak):
    from optispeech_tpu_torch.training.step import make_cached_scan_step, make_cached_train_step

    cfg = _cfg()
    cache = DeviceFeatureCache(pak, statistics(torch_config.DataStatistics), device="cpu",
                               text_bucket=16, mel_bucket=64, wav_dtype="int16")
    rng = np.random.default_rng(3)
    ks = torch.from_numpy(np.stack([
        np.stack([rng.permutation(12)[:4], rng.integers(0, 8, 4)], axis=1).astype(np.int32)
        for _ in range(2)]))
    shape = dict(t_text=cache.t_text_max, t_mel=cache.t_mel_max)
    tcfg = to_torch_config(cfg)
    seq, one = _state(cfg), make_cached_train_step(tcfg, cache)
    seq_logs = [one(seq, ks[k], **shape) for k in range(2)]
    scanned = _state(cfg)
    logs_k = make_cached_scan_step(tcfg, cache)(scanned, ks, **shape)
    assert scanned.step == seq.step == 2
    for k, v in logs_k.items():
        assert v.shape == (2,)
        np.testing.assert_array_equal(v.numpy(), torch.stack([s[k] for s in seq_logs]).numpy())
    for a, b in zip(seq.generator.parameters(), scanned.generator.parameters()):
        assert torch.equal(a, b)


def test_trainer_cached_path_equals_host_path(pak, tmp_path):
    """Trainer.fit over a DeviceCacheLoader and over the host collator's
    PackedLoader from one seed: the same batches, segment starts and
    parameters after two steps, bit for bit (the cached input path only
    moves where the batch is assembled)."""
    from optispeech_tpu_torch.training.trainer import Trainer

    cfg = dataclasses.replace(to_torch_config(_cfg()), log_every_n_steps=1,
                              val_every_n_steps=1000, ckpt_every_n_steps=100, seed=7)
    stats = cfg.data.statistics
    runs = {}
    for name, loader in (
            ("host", PackedLoader(PackedDataset(pak, stats), 4, 16, 64, shuffle=True, seed=9)),
            ("cached", DeviceCacheLoader(DeviceFeatureCache(pak, stats, device="cpu",
                                                            text_bucket=16, mel_bucket=64),
                                         4, 16, 64, shuffle=True, seed=9))):
        trainer = Trainer(cfg, out_dir=str(tmp_path / name), device="cpu")
        state = trainer.fit(loader, None, max_steps=2, state=trainer.init_or_restore_state())
        runs[name] = state
        assert state.step == 2 and loader.state_dict()["pos"] == 2
    for a, b in zip(runs["host"].generator.parameters(), runs["cached"].generator.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(runs["host"].discriminator.parameters(),
                    runs["cached"].discriminator.parameters()):
        assert torch.equal(a, b)


def test_cli_trains_packed_and_from_the_cache(pak, tmp_path):
    """`cli/train.py --packed-train --packed-val [--device-cache]` on the CPU:
    2 steps with a validation, a checkpoint and the inference export."""
    import json

    from optispeech_tpu_torch.cli.train import main
    from test_torch_trainer import CLI_OVERRIDES

    for flags in ([], ["--device-cache", "--cache-mel-dtype", "bfloat16",
                       "--cache-wav-dtype", "int16"]):
        out = tmp_path / ("cached" if flags else "host")
        assert main(["--packed-train", pak, "--packed-val", pak, "--device", "cpu",
                     "--max-steps", "2", "--out-dir", str(out), "--no-print-config", *flags,
                     *CLI_OVERRIDES, "data.max_mel_len=128", "data.mel_bucket_size=64"]) == 0
        assert (out / "checkpoints" / "2" / "state.pt").exists()
        assert (out / "inference_ckpt" / "generator.pt").exists()
        rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
        assert any("total_loss/val_total" in r for r in rows)
        assert all(np.isfinite(v) for r in rows for v in r.values())
