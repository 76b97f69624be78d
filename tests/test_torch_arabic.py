"""The Arabic front end at configs/kareem.yaml (`arabic-buck`,
`normalize_text: false`, `add_bos_eos: false`, `add_blank: false`, one
language), port against JAX on the CPU.

- `prepare_input`: token ids EQUAL to JAX's for sentences in Arabic script
  (with and without diacritics) and in Buckwalter transliteration.
- `cli/preprocess.py --config kareem` on rows of such text, the wavs from the
  port's synthcorpus: filelists, `.json` (the ids) and `.npz` bit for bit.
- Synthesis at test widths under kareem's statistics: durations exactly
  equal, wav atol 1e-4 (tests/test_torch_synthesis.py).
"""

import numpy as np
import pytest
import torch

from optispeech_tpu.utils.yamlcfg import load_experiment
from torch_parity import build_pair, yaml_config

torch.set_num_threads(1)

ATOL = 1e-4
SENTENCES = [
    "السَّلامُ عَلَيكُم",
    "كِتابٌ جَديدٌ عَلى الطّاوِلَةِ.",
    "مَرحَباً بِالعالَمِ، كَيفَ حالُك؟",
    "ذَهَبَ الوَلَدُ إِلى المَدرَسَةِ صَباحاً",
    "مرحبا بكم في المدينة",  # no diacritics
    "Alsa~alAmu Ealaykum",  # Buckwalter
    "*ahaba Alwaladu <ilaY Almadrasapi SabAHAF.",
]


@pytest.fixture(scope="module")
def pair():
    cfg = yaml_config("kareem")
    tp = cfg.data.text_processor
    assert tp.tokenizer == "arabic-buck" and tp.languages == ("ar",)
    assert not (tp.normalize_text or tp.add_bos_eos or tp.add_blank)
    return build_pair(cfg)


@pytest.mark.parametrize("text", SENTENCES)
def test_token_ids_equal_jax(pair, text):
    japi, tapi = pair
    want = japi.prepare_input(text, split_sentences=False)
    got = tapi.prepare_input(text, split_sentences=False)
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.x_lengths, want.x_lengths)
    assert got.x.shape[0] == 1 and int(got.x_lengths[0]) > 3
    ids = got.x[0, :int(got.x_lengths[0])]
    assert ids.min() >= 1 and ids.max() < 49  # no padding inside, no blanks interleaved
    assert ids[-1] == 1  # `_eos_` from the phonetiser, no BOS/EOS added by the processor
    # asked to split sentences (prepare_input's default), one row of the same ids
    with pytest.warns(UserWarning, match="sentence splitting"):
        split = tapi.prepare_input(text)
    np.testing.assert_array_equal(split.x, want.x)


def test_default_sentence_split_raises_in_jax_only(pair):
    """JAX's Arabic tokenizer returns flat ids when asked to split, and its
    `prepare_input` (split_sentences=True by default; cli/serve.py always
    splits, cli/infer.py unless --no-split) raises; the port's returns one
    sentence."""
    japi, tapi = pair
    with pytest.warns(UserWarning), pytest.raises(TypeError):
        japi.prepare_input(SENTENCES[0])
    with pytest.warns(UserWarning):
        ids, text = tapi.text_processor(SENTENCES[0], lang="ar", split_sentences=True)
    assert text == SENTENCES[0] and len(ids) == 1
    assert ids[0] == tapi.text_processor(SENTENCES[0], lang="ar")[0]


def test_synthesis_under_kareem_statistics_equals_jax(pair):
    japi, tapi = pair
    assert tapi.cfg.data.statistics.pitch_mean == 125.052887
    text = SENTENCES[3]
    kw = dict(d_factor=1.3, p_factor=1.2, e_factor=1.1, split_sentences=False)
    jout = japi.synthesise(japi.prepare_input(text, **kw))
    tout = tapi.synthesise(tapi.prepare_input(text, **kw))
    np.testing.assert_array_equal(tout.durations, jout.durations)
    np.testing.assert_array_equal(tout.wav_lengths, jout.wav_lengths)
    np.testing.assert_allclose(tout.wav, jout.wav, atol=ATOL)


@pytest.fixture(scope="module")
def preprocessed(tmp_path_factory):
    """A 4-row corpus of Arabic sentences (2-column metadata: one speaker,
    one language) on the port's synthcorpus wavs, through both CLIs."""
    from optispeech_tpu.cli import preprocess as jax_cli
    from optispeech_tpu_torch.cli import preprocess as torch_cli
    from optispeech_tpu_torch.data.synthcorpus import generate_corpus

    root = tmp_path_factory.mktemp("kareem")
    generate_corpus(str(root / "corpus"), n_utterances=4, seed=7, frontend="char")
    rows = [line.split("|")[0] for line in
            (root / "corpus" / "metadata.csv").read_text().splitlines()]
    (root / "corpus" / "metadata.csv").write_text(
        "".join(f"{fid}|{SENTENCES[i]}\n" for i, fid in enumerate(rows)), encoding="utf-8")
    flags = ["--config", "kareem", "--val-fraction", "0.25", "--workers", "1"]
    jax_cli.main([str(root / "corpus"), str(root / "jax"), *flags])
    train, val = torch_cli.main([str(root / "corpus"), str(root / "torch"), *flags])
    assert len(train) == 3 and len(val) == 1
    return root


def test_preprocess_at_kareem_equals_jax(preprocessed):
    import json

    jax_dir, torch_dir = preprocessed / "jax", preprocessed / "torch"
    for name in ("train.txt", "val.txt"):
        assert [p.rsplit("/", 1)[-1] for p in (torch_dir / name).read_text().splitlines()] == [
            p.rsplit("/", 1)[-1] for p in (jax_dir / name).read_text().splitlines()]
    assert not (torch_dir / "speaker_ids.json").exists()
    names = sorted(p.name for p in (jax_dir / "data").iterdir())
    assert len(names) == 8 and sorted(p.name for p in (torch_dir / "data").iterdir()) == names
    n_feats = load_experiment("kareem").data.features.n_feats
    for name in names:
        got, want = torch_dir / "data" / name, jax_dir / "data" / name
        if name.endswith(".json"):
            assert got.read_bytes() == want.read_bytes(), name
            meta = json.loads(got.read_text(encoding="utf-8"))
            assert meta["text"] in SENTENCES and meta["phoneme_ids"][-1] == 1
            continue
        with np.load(got) as g, np.load(want) as w:
            for key in ("wav", "mel", "energy", "pitch"):
                np.testing.assert_array_equal(g[key], w[key], err_msg=f"{name}:{key}")
            assert g["mel"].shape[0] == n_feats
