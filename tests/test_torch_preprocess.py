"""The data pipeline, port against JAX on the CPU: synthcorpus -> preprocess
-> statistics, and each host DSP function on the way.

The port's data modules are numpy/scipy copies of the JAX package's, so
every output is held EQUAL to JAX's (bit for bit: same numpy, same order of
operations): the pitch trackers, the VAD, the loudness, the biquads, the
trims, the corpus's wavs and metadata, the preprocessed filelists, `.json`,
`.npz` arrays and id maps, and the statistics. The port's preprocessing runs
with two spawned workers, JAX's in-process, so the equality also shows that
the pool changes no output.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from optispeech_tpu import config as jax_config
from optispeech_tpu.data import dsp as jax_dsp
from optispeech_tpu.data import pitch as jax_pitch
from optispeech_tpu.data import vad as jax_vad
from optispeech_tpu_torch import config as torch_config
from optispeech_tpu_torch.data import dsp, pitch, vad

SR = 24000
N_UTTERANCES = 8


def _utterance(seed=0, silence_s=0.3):
    """A speech-like utterance (the corpus's formant synthesis) between two
    stretches of low noise, from a seed."""
    from optispeech_tpu_torch.data.synthcorpus import (DEFAULT_LANGUAGES, DEFAULT_SPEAKERS,
                                                       random_text, synth_utterance)

    rng = np.random.default_rng(seed)
    lang = DEFAULT_LANGUAGES[0]
    wav = synth_utterance(random_text(lang, rng, (2, 3)), DEFAULT_SPEAKERS[1], lang, seed=seed)
    pad = (rng.standard_normal(int(SR * silence_s)) * 1e-3).astype(np.float32)
    return np.concatenate([pad, wav, pad])


@pytest.fixture(scope="module")
def wav():
    return _utterance()


@pytest.mark.parametrize("name", ["autocorr", "yin", "cepstrum", "ensemble"])
@pytest.mark.parametrize("interpolate", [True, False])
def test_pitch_tracker_equals_jax(wav, name, interpolate):
    feats = torch_config.FeatureConfig()
    n_frames = len(wav) // feats.hop_length + 1
    got = pitch.make_pitch_extractor(name, feats, interpolate)(wav, n_frames)
    want = jax_pitch.make_pitch_extractor(name, jax_config.FeatureConfig(), interpolate)(
        wav, n_frames)
    assert got.dtype == want.dtype and got.shape == (n_frames,)
    assert (want > 0).any() and ((want == 0).any() or interpolate)
    np.testing.assert_array_equal(got, want)


def test_unknown_pitch_tracker_raises():
    with pytest.raises(ValueError, match="unknown pitch extractor"):
        pitch.make_pitch_extractor("dio", torch_config.FeatureConfig())


# each host DSP function on the same input: (the port's call, JAX's call)
DSP_CASES = {
    "vad_probabilities": (lambda w: vad.SpectralVoiceActivityDetector()(w, SR),
                          lambda w: jax_vad.SpectralVoiceActivityDetector()(w, SR)),
    "trim_silence_spectral": (lambda w: vad.trim_silence_spectral(w, SR),
                              lambda w: jax_vad.trim_silence_spectral(w, SR)),
    "trim_silence_energy": (lambda w: dsp.trim_silence_energy(w, SR),
                            lambda w: jax_dsp.trim_silence_energy(w, SR)),
    "integrated_loudness": (lambda w: np.float64(dsp.integrated_loudness(w, SR)),
                            lambda w: np.float64(jax_dsp.integrated_loudness(w, SR))),
    "normalize_loudness": (lambda w: dsp.normalize_loudness(w, SR, -20.0),
                           lambda w: jax_dsp.normalize_loudness(w, SR, -20.0)),
    "lowpass_biquad": (lambda w: dsp.lowpass_biquad(w, SR, 3000.0),
                       lambda w: jax_dsp.lowpass_biquad(w, SR, 3000.0)),
    "highpass_biquad": (lambda w: dsp.highpass_biquad(w, SR, 120.0, q=0.9),
                        lambda w: jax_dsp.highpass_biquad(w, SR, 120.0, q=0.9)),
    "peak_normalize": (lambda w: dsp.peak_normalize(0.3 * w),
                       lambda w: jax_dsp.peak_normalize(0.3 * w)),
    "frame_energy": (lambda w: dsp.frame_energy_np(w, 1024, 256, 1024),
                     lambda w: jax_dsp.frame_energy_np(w, 1024, 256, 1024)),
    "log_mel": (lambda w: dsp.log_mel_spectrogram_np(w, SR, 1024, 256, 1024, 100, 0, 8000),
                lambda w: jax_dsp.log_mel_spectrogram_np(w, SR, 1024, 256, 1024, 100, 0, 8000)),
    "trim_or_pad_to_longer": (lambda w: dsp.trim_or_pad_to(w[:, None], len(w) + 7),
                              lambda w: jax_dsp.trim_or_pad_to(w[:, None], len(w) + 7)),
    "trim_or_pad_to_shorter": (lambda w: dsp.trim_or_pad_to(w, 100),
                               lambda w: jax_dsp.trim_or_pad_to(w, 100)),
}


@pytest.mark.parametrize("case", list(DSP_CASES))
def test_dsp_function_equals_jax(wav, case):
    ours, theirs = DSP_CASES[case]
    got, want = ours(wav), theirs(wav)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if case.startswith("trim_silence"):
        assert 0 < len(got) < len(wav)  # the noise at both ends was cut


def _corpus(package, out_dir, frontend):
    if package == "jax":
        from optispeech_tpu.data.synthcorpus import generate_corpus
    else:
        from optispeech_tpu_torch.data.synthcorpus import generate_corpus
    return generate_corpus(str(out_dir), n_utterances=N_UTTERANCES, seed=0, frontend=frontend)


@pytest.mark.parametrize("frontend", ["char", "en-g2p"])
def test_generate_corpus_equals_jax(tmp_path, frontend):
    manifests = {p: _corpus(p, tmp_path / p, frontend) for p in ("jax", "torch")}
    assert manifests["torch"] == manifests["jax"]
    for name in ("metadata.csv", "manifest.json"):
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    wavs = sorted(p.name for p in (tmp_path / "jax" / "wavs").iterdir())
    assert len(wavs) == N_UTTERANCES
    assert sorted(p.name for p in (tmp_path / "torch" / "wavs").iterdir()) == wavs
    for name in wavs:
        assert (tmp_path / "torch" / "wavs" / name).read_bytes() == (
            tmp_path / "jax" / "wavs" / name).read_bytes(), name


def test_synthcorpus_main_writes_the_corpus(tmp_path, capsys):
    from optispeech_tpu_torch.data import synthcorpus

    synthcorpus.main([str(tmp_path / "c"), "--n-utterances", "2", "--frontend", "en-g2p"])
    manifest = json.loads(capsys.readouterr().out)
    assert manifest["n_utterances"] == 2 and manifest["frontend"] == "en-g2p"
    assert len((tmp_path / "c" / "metadata.csv").read_text().splitlines()) == 2


@pytest.fixture(scope="module")
def preprocessed(tmp_path_factory):
    """The same en-g2p corpus preprocessed by both packages' `cli/preprocess.py`
    at the flagship config (en-g2p, ensemble pitch): JAX in-process, the port
    with two spawned workers. Returns {package: output dir}."""
    from optispeech_tpu.cli import preprocess as jax_cli
    from optispeech_tpu_torch.cli import preprocess as torch_cli

    root = tmp_path_factory.mktemp("pipeline")
    _corpus("torch", root / "corpus", "en-g2p")
    flags = ["--tokenizer", "en-g2p", "--val-fraction", "0.25"]
    jax_cli.main([str(root / "corpus"), str(root / "jax"), *flags, "--workers", "1"])
    train, val = torch_cli.main([str(root / "corpus"), str(root / "torch"), *flags,
                                 "--workers", "2"])
    assert len(train) == 6 and len(val) == 2
    return {p: root / p for p in ("jax", "torch")}


def _filelist(out_dir, name):
    return [str(Path(p).relative_to(out_dir)) for p in
            (out_dir / name).read_text(encoding="utf-8").splitlines()]


def test_preprocess_writes_jax_filelists_and_id_maps(preprocessed):
    jax_dir, torch_dir = preprocessed["jax"], preprocessed["torch"]
    for name in ("train.txt", "val.txt"):
        assert _filelist(torch_dir, name) == _filelist(jax_dir, name), name
    for name in ("speaker_ids.json", "language_ids.json"):
        assert (torch_dir / name).read_bytes() == (jax_dir / name).read_bytes(), name
    assert len(json.loads((torch_dir / "speaker_ids.json").read_text())) == 4


def test_preprocess_writes_jax_datafiles(preprocessed):
    jax_dir, torch_dir = preprocessed["jax"], preprocessed["torch"]
    names = sorted(p.name for p in (jax_dir / "data").iterdir())
    assert len(names) == 2 * N_UTTERANCES
    assert sorted(p.name for p in (torch_dir / "data").iterdir()) == names
    for name in names:
        got, want = torch_dir / "data" / name, jax_dir / "data" / name
        if name.endswith(".json"):
            assert got.read_bytes() == want.read_bytes(), name
            continue
        with np.load(got) as g, np.load(want) as w:
            assert sorted(g.files) == sorted(w.files) == ["energy", "mel", "pitch", "wav"]
            for key in w.files:
                assert g[key].dtype == w[key].dtype, (name, key)
                np.testing.assert_array_equal(g[key], w[key], err_msg=f"{name}:{key}")


def test_stats_cli_equals_jax(preprocessed, tmp_path):
    from optispeech_tpu.cli import stats as jax_stats
    from optispeech_tpu_torch.cli import stats as torch_stats

    out = {}
    for package, cli in (("jax", jax_stats), ("torch", torch_stats)):
        path = tmp_path / f"{package}.json"
        cli.main(["-o", str(path), "--batch-size", "4",
                  f"data.train_filelist_path={preprocessed[package] / 'train.txt'}"])
        out[package] = json.loads(path.read_text())
    assert out["torch"] == out["jax"]
    assert out["torch"]["pitch_max"] > out["torch"]["pitch_min"] >= 0


@pytest.mark.parametrize("do_normalize", [False, True])
def test_collate_equals_jax(preprocessed, do_normalize):
    """Both packages' datasets and collates on the same datafiles: the
    batch is equal, raw (`do_normalize=False`, as the stats CLI reads it)
    or normalised."""
    from optispeech_tpu.data.datamodule import BucketedCollate as JaxCollate
    from optispeech_tpu.data.datamodule import TextWavDataset as JaxDataset
    from optispeech_tpu_torch.data.datamodule import BucketedCollate, TextWavDataset

    filelist = preprocessed["torch"] / "train.txt"
    stats = dict(pitch_mean=180.0, pitch_std=40.0, energy_mean=3.0, energy_std=2.0,
                 mel_mean=-4.0, mel_std=2.5)
    feats = torch_config.FeatureConfig()
    kw = dict(n_feats=feats.n_feats, hop_length=feats.hop_length, do_normalize=do_normalize)
    got_ds, want_ds = TextWavDataset(filelist, f_min=feats.f_min), JaxDataset(filelist,
                                                                               f_min=feats.f_min)
    got = BucketedCollate(statistics=torch_config.DataStatistics(**stats), **kw)(
        [got_ds[i] for i in range(4)])
    want = JaxCollate(statistics=jax_config.DataStatistics(**stats), **kw)(
        [want_ds[i] for i in range(4)])
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key
    raw = [got_ds[i]["pitch"] for i in range(4)]
    assert np.array_equal(got["pitches"][0, :len(raw[0])], raw[0]) != do_normalize
