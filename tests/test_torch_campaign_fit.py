"""The campaign's training run (configs/campaign-ms.yaml), the port's
`Trainer.fit` against the JAX package's on the CPU.

campaign-ms at `torch_parity.TEST_WIDTHS` (its own feature block, 4 speakers
x 2 languages, en-g2p, `wire_mel_dtype: bfloat16`, periodicity, MCD and
STOI at validation, 8 synthesised utterances), every dropout at 0 and
`num_devices=1`. The data is the port's synthcorpus (8 utterances, 4
speakers x en-us / de) preprocessed once by the port's `cli/preprocess.py`;
each package reads the datafiles with its own dataset, collate and loader
(batch 4). The port's `TrainState` holds JAX's initial weights through the
bridge. Both run `fit(max_steps=3)` with `val_every_n_steps=2` and
`log_every_n_steps=1`, and every value of the two `metrics.jsonl` files but
the `perf/*` timings, the perceptual metrics included, is compared at rtol
1e-4 (tests/test_torch_trainer_parity.py).
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
from torch_parity import to_torch_config, yaml_config

torch.set_num_threads(1)

RTOL = 1e-4
PERCEPTUAL = ("val/periodicity_loss", "val/perio_pitch_loss", "val/f1_score", "val/mcd",
              "val/stoi")


def _loaders(data, cfg):
    feats = cfg.generator.features
    collate = data.BucketedCollate(
        n_feats=feats.n_feats, statistics=cfg.data.statistics, hop_length=feats.hop_length,
        text_bucket=cfg.data.text_bucket_size, mel_bucket=cfg.data.mel_bucket_size,
        max_text_len=cfg.data.max_text_len, max_mel_len=cfg.data.max_mel_len)
    train = data.TextWavDataset(cfg.data.train_filelist_path, f_min=feats.f_min, seed=1)
    val = data.TextWavDataset(cfg.data.valid_filelist_path, f_min=feats.f_min)
    return (data.DataLoader(train, cfg.data.batch_size, collate, shuffle=True, seed=5),
            data.DataLoader(val, cfg.data.batch_size, collate, shuffle=False, drop_last=False))


def _rows(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from optispeech_tpu_torch.cli import preprocess
    from optispeech_tpu_torch.data.synthcorpus import generate_corpus
    from optispeech_tpu_torch.training import loggers

    tmp = tmp_path_factory.mktemp("campaign")
    generate_corpus(str(tmp / "corpus"), n_utterances=8, seed=0, frontend="en-g2p")
    preprocess.main([str(tmp / "corpus"), str(tmp / "pre"), "--config", "campaign-ms",
                     "--val-fraction", "0.5", "--workers", "1"])
    cfg = yaml_config("campaign-ms", "data.batch_size=4",
                      f"data.train_filelist_path={tmp / 'pre' / 'train.txt'}",
                      f"data.valid_filelist_path={tmp / 'pre' / 'val.txt'}")
    cfg = dataclasses.replace(cfg, log_every_n_steps=1, val_every_n_steps=2,
                              ckpt_every_n_steps=100, num_devices=1)
    ta = cfg.train_args
    assert ta.wire_mel_dtype == "bfloat16" and ta.evaluate_mcd and ta.evaluate_stoi
    assert cfg.generator.num_speakers == 4 and cfg.data.text_processor.languages == ("en-us",
                                                                                      "de")

    jtrainer = JaxTrainer(cfg, out_dir=str(tmp / "jax"))
    jstate = jtrainer.init_or_restore_state()
    g_np = jax.tree_util.tree_map(np.asarray, jax.device_get(jstate.g_params))
    d_np = jax.tree_util.tree_map(np.asarray, jax.device_get(jstate.d_params))
    jtrainer.fit(*_loaders(jax_data, cfg), max_steps=3, state=jstate)

    tcfg = to_torch_config(cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(loggers._SINK_REGISTRY, "tensorboard", lambda *args: None)
        trainer = Trainer(tcfg, out_dir=str(tmp / "torch"), device="cpu")
    state = trainer.init_or_restore_state()
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
    assert set(PERCEPTUAL) <= set(rows[3])


def test_every_logged_value_matches_jax(runs):
    jrows, rows = runs
    for jr, r in zip(jrows, rows):
        for k, v in jr.items():
            if k != "step" and not k.startswith("perf/"):
                np.testing.assert_allclose(r[k], v, rtol=RTOL, atol=1e-7,
                                           err_msg=f"step {r['step']}: {k}")
    assert rows[3]["val/mcd"] > 0 and 0 < rows[3]["val/stoi"] <= 1
