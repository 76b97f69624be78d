"""`cli/preprocess.py` and `cli/stats.py` at the 48 kHz and 22.05 kHz feature
blocks (configs/ljspeech-48k.yaml, ljspeech-22k.yaml), port against JAX on
the CPU: the same synthcorpus sample through both packages' CLIs.

The corpus is the port's synthcorpus written at the config's rate, and for
22.05 kHz also at 24 kHz, so that `load_wav` resamples it (320:441) before
the features. The pitch trackers' frame length (4 * rate / f_min), the VAD's
bins and the slaney bank all follow the rate. Every output is held EQUAL to
JAX's, bit for bit (the data modules are numpy copies of JAX's): the
filelists, the id maps, each `.json` and each `.npz` array, and the
statistics.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from optispeech_tpu.utils.yamlcfg import load_experiment

N_UTTERANCES = 3
# (config, the rate the corpus is written at)
CASES = {"48k": ("ljspeech-48k", 48000), "22k": ("ljspeech-22k", 22050),
         "22k_from_24k": ("ljspeech-22k", 24000)}


@pytest.fixture(scope="module", params=list(CASES))
def preprocessed(request, tmp_path_factory):
    from optispeech_tpu.cli import preprocess as jax_cli
    from optispeech_tpu_torch.cli import preprocess as torch_cli
    from optispeech_tpu_torch.data.synthcorpus import generate_corpus

    name, sr = CASES[request.param]
    root = tmp_path_factory.mktemp(request.param)
    generate_corpus(str(root / "corpus"), n_utterances=N_UTTERANCES, sr=sr, seed=3,
                    frontend="en-g2p")
    flags = ["--config", name, "--tokenizer", "en-g2p", "--val-fraction", "0.34",
             "--workers", "1"]
    jax_cli.main([str(root / "corpus"), str(root / "jax"), *flags])
    train, val = torch_cli.main([str(root / "corpus"), str(root / "torch"), *flags])
    assert len(train) == 2 and len(val) == 1
    return name, {p: root / p for p in ("jax", "torch")}


def _filelist(out_dir, name):
    return [str(Path(p).relative_to(out_dir)) for p in
            (out_dir / name).read_text(encoding="utf-8").splitlines()]


def test_filelists_and_id_maps_equal_jax(preprocessed):
    _, dirs = preprocessed
    for name in ("train.txt", "val.txt", "speaker_ids.json", "language_ids.json"):
        if name.endswith(".txt"):
            assert _filelist(dirs["torch"], name) == _filelist(dirs["jax"], name), name
        else:
            assert (dirs["torch"] / name).read_bytes() == (dirs["jax"] / name).read_bytes(), name


def test_datafiles_equal_jax_bit_for_bit(preprocessed):
    config, dirs = preprocessed
    feats = load_experiment(config).data.features
    names = sorted(p.name for p in (dirs["jax"] / "data").iterdir())
    assert len(names) == 2 * N_UTTERANCES
    assert sorted(p.name for p in (dirs["torch"] / "data").iterdir()) == names
    for name in names:
        got, want = dirs["torch"] / "data" / name, dirs["jax"] / "data" / name
        if name.endswith(".json"):
            assert got.read_bytes() == want.read_bytes(), name
            continue
        with np.load(got) as g, np.load(want) as w:
            assert sorted(g.files) == sorted(w.files) == ["energy", "mel", "pitch", "wav"]
            for key in w.files:
                assert g[key].dtype == w[key].dtype, (name, key)
                np.testing.assert_array_equal(g[key], w[key], err_msg=f"{name}:{key}")
            assert g["mel"].shape[0] == feats.n_feats
            assert g["mel"].shape[1] == len(g["pitch"]) == len(g["energy"])
            assert (g["pitch"] > 0).any()


def test_stats_cli_equals_jax(preprocessed, tmp_path):
    from optispeech_tpu.cli import stats as jax_stats
    from optispeech_tpu_torch.cli import stats as torch_stats

    config, dirs = preprocessed
    out = {}
    for package, cli in (("jax", jax_stats), ("torch", torch_stats)):
        path = tmp_path / f"{package}.json"
        cli.main(["--config", config, "-o", str(path), "--batch-size", "2",
                  f"data.train_filelist_path={dirs[package] / 'train.txt'}"])
        out[package] = json.loads(path.read_text())
    assert out["torch"] == out["jax"]
    assert out["torch"]["pitch_max"] > out["torch"]["pitch_min"] >= 0
