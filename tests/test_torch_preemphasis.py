"""Preemphasis and dataset statistics (configs/mike.yaml, emily-light.yaml),
port against JAX on the CPU.

- `cli/preprocess.py --config mike` (preemphasis 0.5, then loudness and
  peak normalisation) on a synthcorpus sample: every datafile bit for bit,
  and the wav really filtered (it differs from the default config's).
- `FeatureExtractor` from emily-light's `data.preprocess` block: the four
  arrays bit for bit.
- `BucketedCollate(do_normalize=True)` under mike's statistics on those
  datafiles, and `cli/stats.py`: equal arrays and numbers.
- emily-light's light model (LightSpeech stacks, separable predictors) at
  test widths: `prepare_input -> synthesise` with durations exactly equal
  and wav atol 1e-4 (tests/test_torch_synthesis.py).
"""

import json

import numpy as np
import pytest
import torch

from optispeech_tpu import config as jax_config
from optispeech_tpu.utils.yamlcfg import load_experiment
from optispeech_tpu_torch import config as torch_config
from torch_parity import build_pair, to_torch_config, yaml_config

torch.set_num_threads(1)

ATOL = 1e-4
N_UTTERANCES = 3
FLAGS = ["--tokenizer", "en-g2p", "--val-fraction", "0.34", "--workers", "1"]


@pytest.fixture(scope="module")
def preprocessed(tmp_path_factory):
    """The same corpus through JAX's and the port's CLI at mike's config, and
    through the port's at the default config (no preemphasis)."""
    from optispeech_tpu.cli import preprocess as jax_cli
    from optispeech_tpu_torch.cli import preprocess as torch_cli
    from optispeech_tpu_torch.data.synthcorpus import generate_corpus

    root = tmp_path_factory.mktemp("mike")
    generate_corpus(str(root / "corpus"), n_utterances=N_UTTERANCES, seed=5, frontend="en-g2p")
    jax_cli.main([str(root / "corpus"), str(root / "jax"), "--config", "mike", *FLAGS])
    torch_cli.main([str(root / "corpus"), str(root / "torch"), "--config", "mike", *FLAGS])
    torch_cli.main([str(root / "corpus"), str(root / "plain"), *FLAGS])
    return root


def test_mike_config_sets_preemphasis():
    pp = load_experiment("mike").data.preprocess
    assert pp.preemphasis_filter_coef == 0.5
    assert load_experiment("emily-light").data.preprocess == pp


def test_preemphasis_datafiles_equal_jax(preprocessed):
    names = sorted(p.name for p in (preprocessed / "jax" / "data").iterdir())
    assert len(names) == 2 * N_UTTERANCES
    assert sorted(p.name for p in (preprocessed / "torch" / "data").iterdir()) == names
    for name in names:
        got, want = (preprocessed / p / "data" / name for p in ("torch", "jax"))
        if name.endswith(".json"):
            assert got.read_bytes() == want.read_bytes(), name
            continue
        with np.load(got) as g, np.load(want) as w, \
                np.load(preprocessed / "plain" / "data" / name) as plain:
            for key in ("wav", "mel", "energy", "pitch"):
                assert g[key].dtype == w[key].dtype, (name, key)
                np.testing.assert_array_equal(g[key], w[key], err_msg=f"{name}:{key}")
            assert g["wav"].shape == plain["wav"].shape
            assert not np.array_equal(g["wav"], plain["wav"]), name


def test_feature_extractor_at_emily_light_equals_jax(preprocessed):
    from optispeech_tpu.data.preprocess import FeatureExtractor as JaxExtractor
    from optispeech_tpu_torch.data.preprocess import FeatureExtractor

    jcfg = load_experiment("emily-light")
    pp = jcfg.data.preprocess
    kw = dict(preemphasis_filter_coef=pp.preemphasis_filter_coef,
              loudness_norm_target_db=pp.loudness_norm_target_db,
              pitch_extractor=pp.pitch_extractor)
    wav_path = str(next(iter(sorted((preprocessed / "corpus" / "wavs").iterdir()))))
    want = JaxExtractor(features=jcfg.data.features, **kw)(wav_path)
    got = FeatureExtractor(features=to_torch_config(jcfg).data.features, **kw)(wav_path)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_collate_under_mike_statistics_equals_jax(preprocessed):
    from optispeech_tpu.data.datamodule import BucketedCollate as JaxCollate
    from optispeech_tpu.data.datamodule import TextWavDataset as JaxDataset
    from optispeech_tpu_torch.data.datamodule import BucketedCollate, TextWavDataset

    jcfg = load_experiment("mike")
    tcfg = to_torch_config(jcfg)
    assert jcfg.data.statistics.pitch_mean == 113.678925
    feats = jcfg.data.features
    kw = dict(n_feats=feats.n_feats, hop_length=feats.hop_length, do_normalize=True)
    filelist = preprocessed / "torch" / "train.txt"
    got_ds, want_ds = TextWavDataset(filelist, f_min=feats.f_min), JaxDataset(filelist,
                                                                               f_min=feats.f_min)
    items = range(len(got_ds))
    got = BucketedCollate(statistics=tcfg.data.statistics, **kw)([got_ds[i] for i in items])
    want = JaxCollate(statistics=jcfg.data.statistics, **kw)([want_ds[i] for i in items])
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key
    # normalised with mike's statistics, not the defaults
    default = BucketedCollate(statistics=torch_config.DataStatistics(), **kw)(
        [got_ds[i] for i in items])
    assert not np.array_equal(default["pitches"], got["pitches"])
    assert isinstance(jcfg.data.statistics, jax_config.DataStatistics)


def test_stats_cli_at_mike_equals_jax(preprocessed, tmp_path):
    from optispeech_tpu.cli import stats as jax_stats
    from optispeech_tpu_torch.cli import stats as torch_stats

    out = {}
    for package, cli in (("jax", jax_stats), ("torch", torch_stats)):
        path = tmp_path / f"{package}.json"
        cli.main(["--config", "mike", "-o", str(path), "--batch-size", "2",
                  f"data.train_filelist_path={preprocessed / package / 'train.txt'}"])
        out[package] = json.loads(path.read_text())
    assert out["torch"] == out["jax"]


def test_light_model_under_emily_statistics_synthesises_as_jax():
    cfg = yaml_config("emily-light", "data.text_processor.tokenizer=en-g2p")
    assert cfg.generator.encoder.kind == "lightspeech"
    assert cfg.data.statistics.mel_mean == -4.363451
    japi, tapi = build_pair(cfg)
    kw = dict(d_factor=1.4, p_factor=1.1, e_factor=0.8)
    text = "A large size in stockings is hard to sell. The wrist was badly strained."
    jout = japi.synthesise(japi.prepare_input(text, **kw))
    tout = tapi.synthesise(tapi.prepare_input(text, **kw))
    np.testing.assert_array_equal(tout.durations, jout.durations)
    np.testing.assert_array_equal(tout.wav_lengths, jout.wav_lengths)
    np.testing.assert_allclose(tout.wav, jout.wav, atol=ATOL)
    np.testing.assert_allclose(tout.pitch, jout.pitch, atol=ATOL)
