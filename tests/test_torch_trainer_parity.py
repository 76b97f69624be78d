"""The port's `Trainer.fit` against the JAX package's on the CPU: the slice as
a whole. `tiny_experiment()`'s sizes with every dropout and drop-path rate
at 0 and `num_devices=1`; the same `SyntheticDataset` and `BucketedCollate`
(each package's own copy) and so the same batches; the port's `TrainState`
holds JAX's initial weights through the bridge. Both run `fit(max_steps=3)`
with `val_every_n_steps=2`, `log_every_n_steps=1` and the periodicity
metrics, and every value of the two `metrics.jsonl` files but the `perf/*`
timings is compared, rtol 1e-4 (one train step's logs, tests/test_torch_train_step.py).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from optispeech_tpu.data import datamodule as jax_data
from optispeech_tpu.training.trainer import Trainer as JaxTrainer
from optispeech_tpu_torch.compat.from_jax import (
    discriminator_state_dict_from_jax_params,
    state_dict_from_jax_params,
)
from optispeech_tpu_torch.data import datamodule as torch_data
from optispeech_tpu_torch.training.trainer import Trainer
from test_train_step import tiny_experiment
from torch_parity import no_dropout, to_torch_config

torch.set_num_threads(1)

RTOL = 1e-4


def _config():
    cfg = no_dropout(tiny_experiment(pretraining_steps=0))
    return dataclasses.replace(
        cfg, log_every_n_steps=1, val_every_n_steps=2, ckpt_every_n_steps=100, num_devices=1,
        train_args=dataclasses.replace(cfg.train_args, evaluate_periodicity=True))


def _loaders(data, cfg):
    feats = cfg.generator.features
    ds = data.SyntheticDataset(n_items=8, n_feats=feats.n_feats, hop_length=feats.hop_length,
                               text_range=(8, 16), mel_range=(32, 64))
    collate = data.BucketedCollate(
        n_feats=feats.n_feats, statistics=cfg.data.statistics, hop_length=feats.hop_length,
        text_bucket=cfg.data.text_bucket_size, mel_bucket=cfg.data.mel_bucket_size,
        max_text_len=cfg.data.text_bucket_size, max_mel_len=cfg.data.mel_bucket_size)
    return (data.DataLoader(ds, 4, collate, shuffle=True, seed=5),
            data.DataLoader(ds, 4, collate, shuffle=False))


def _rows(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg, tmp = _config(), tmp_path_factory.mktemp("fit")
    jtrainer = JaxTrainer(cfg, out_dir=str(tmp / "jax"))
    jstate = jtrainer.init_or_restore_state()
    g_np = jax.tree_util.tree_map(np.asarray, jax.device_get(jstate.g_params))
    d_np = jax.tree_util.tree_map(np.asarray, jax.device_get(jstate.d_params))
    jtrainer.fit(*_loaders(jax_data, cfg), max_steps=3, state=jstate)

    tcfg = to_torch_config(cfg)
    # no TensorBoard sink in the port (its import is some 15 s here): the
    # periodicity metrics make both validations synthesise all the same
    from optispeech_tpu_torch.training import loggers

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(loggers._SINK_REGISTRY, "tensorboard", lambda *args: None)
        trainer = Trainer(tcfg, out_dir=str(tmp / "torch"), device="cpu")
    state = trainer.init_or_restore_state()  # logs the parameter counts at step 0
    state.generator.load_state_dict(state_dict_from_jax_params(g_np, tcfg.generator))
    state.discriminator.load_state_dict(
        discriminator_state_dict_from_jax_params(d_np, tcfg.discriminator))
    trainer.fit(*_loaders(torch_data, tcfg), max_steps=3, state=state)
    return _rows(tmp / "jax" / "metrics.jsonl"), _rows(tmp / "torch" / "metrics.jsonl")


def test_same_rows_and_keys(runs):
    jrows, rows = runs
    key = lambda r: (r["step"], sorted(k for k in r if not k.startswith("perf/")))  # noqa: E731
    assert [key(r) for r in rows] == [key(r) for r in jrows]
    assert [r["step"] for r in rows] == [0, 1, 2, 2, 3]
    assert "val/f1_score" in rows[3] and "total_loss/val_total" in rows[3]


def test_every_logged_value_matches_jax(runs):
    jrows, rows = runs
    for jr, r in zip(jrows, rows):
        for k, v in jr.items():
            if k != "step" and not k.startswith("perf/"):
                np.testing.assert_allclose(r[k], v, rtol=RTOL, atol=1e-7,
                                           err_msg=f"step {r['step']}: {k}")


def test_loader_batches_equal_jax():
    """The port's copy of the data module gives JAX's batches, in JAX's
    order, over two epochs and across a resume from a loader state."""
    cfg = _config()
    jtrain, _ = _loaders(jax_data, cfg)
    train, _ = _loaders(torch_data, to_torch_config(cfg))
    for epoch in range(2):
        for jb, b in zip(jtrain, train, strict=True):
            assert jb.keys() == b.keys()
            for k, v in jb.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(b[k], v, err_msg=f"epoch {epoch}: {k}")
                else:
                    assert b[k] == v, (epoch, k)
    jtrain.load_state_dict({"epoch": 5, "pos": 1, "seed": 9})
    train.load_state_dict({"epoch": 5, "pos": 1, "seed": 9})
    for jb, b in zip(jtrain, train, strict=True):
        np.testing.assert_array_equal(b["x"], jb["x"])


def test_validation_metrics_equal_jax():
    """The port's numpy copies of the perceptual metrics and the host
    log-mel give JAX's numbers on the same waveforms."""
    from optispeech_tpu.data import dsp as jax_dsp
    from optispeech_tpu.training import metrics as jax_metrics
    from optispeech_tpu_torch.data import dsp
    from optispeech_tpu_torch.training import metrics

    rng = np.random.default_rng(3)
    t = np.arange(24000) / 24000.0
    ref = [(0.5 * np.sin(2 * np.pi * 180 * t) + 0.05 * rng.normal(size=t.size)).astype(np.float32)
           for _ in range(2)]
    gen = [(r + 0.1 * rng.normal(size=r.size)).astype(np.float32) for r in ref]
    refs16 = [metrics.resample_to_16k(r, 24000) for r in ref]
    gens16 = [metrics.resample_to_16k(g, 24000) for g in gen]
    np.testing.assert_array_equal(refs16[0], jax_metrics.resample_to_16k(ref[0], 24000))
    assert metrics.periodicity_metrics(refs16, gens16) == jax_metrics.periodicity_metrics(
        refs16, gens16)
    assert metrics.mel_cepstral_distortion(ref[0], gen[0]) == (
        jax_metrics.mel_cepstral_distortion(ref[0], gen[0]))
    assert metrics.stoi_score(refs16, gens16) == jax_metrics.stoi_score(refs16, gens16)
    np.testing.assert_array_equal(
        dsp.log_mel_spectrogram_np(ref[0], 24000, 1024, 256, 1024, 100, 0.0, 8000.0),
        jax_dsp.log_mel_spectrogram_np(ref[0], 24000, 1024, 256, 1024, 100, 0.0, 8000.0))
