"""Inference from the command line, port against JAX on the CPU.

- `OptiSpeech.save_checkpoint` -> `load_from_checkpoint` reads back the same
  config, speakers and weights, and synthesises the same wav.
- A JAX inference checkpoint (orbax `params/` + `config.json`) converted by
  `scripts/jax_ckpt_to_torch.py` and loaded in the port: durations exactly
  equal, wav within 1e-4 of JAX's (`tests/test_torch_synthesis.py`'s ATOL).
- Both packages' `cli/infer.py` on the same weights (the port on
  `--device cpu`), plain, `--fused` and with the prompt options: the
  `gen-*.wav` files read back agree within 1e-4 plus one int16 step
  (the files hold round-toward-zero int16 codes, so a 1e-4 difference can
  move a code by one).
- `--bf16` and `--bf16 --fused` against JAX's `--bf16` (JAX's fused
  blocks run the Pallas kernel in interpret mode): the same wav lengths and
  the wavs within `BF16_WAV_RTOL` of max|wav| (tests/test_torch_bf16.py
  says why bf16 is held to a tolerance). Without a card and without
  `--device` the CLI raises rather than fall back to the CPU.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import small_config, to_torch_config

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-4
WAV_ATOL = ATOL + 1.0 / 32767.0  # plus one int16 step of the written files
BF16_WAV_RTOL = 3e-2  # tests/test_torch_bf16.py's WAV_RTOL
TEXT = "The birch canoe slid on the smooth planks. Glue the sheet to the dark blue background."
SPEAKERS = ["ann", "bob", "cy"]
CONFIGS = {
    "single": dict(),
    "multi": dict(num_speakers=3, languages=("en-us", "en-gb")),
}


def _converter():
    spec = importlib.util.spec_from_file_location("jax_ckpt_to_torch",
                                                  REPO / "scripts" / "jax_ckpt_to_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module", params=list(CONFIGS))
def checkpoints(request, tmp_path_factory):
    """(config name, JAX OptiSpeech, its inference checkpoint, the port's
    checkpoint converted from it)."""
    from optispeech_tpu.models.optispeech import OptiSpeech as JaxOptiSpeech

    name = request.param
    root = tmp_path_factory.mktemp(f"ckpt_{name}")
    speakers = SPEAKERS if name == "multi" else None
    japi = JaxOptiSpeech(small_config(**CONFIGS[name]), seed=0, speakers=speakers)
    japi.save_checkpoint(str(root / "jax"))
    _converter().main([str(root / "jax"), str(root / "torch")])
    return name, japi, root / "jax", root / "torch"


def _prompt(name):
    return dict(speaker=2, language="en-gb") if name == "multi" else {}


def test_converted_jax_checkpoint_synthesises_as_jax(checkpoints):
    """The ROADMAP A1 gate."""
    from optispeech_tpu_torch.models.optispeech import OptiSpeech

    name, japi, _, converted = checkpoints
    tapi = OptiSpeech.load_from_checkpoint(str(converted), device="cpu")
    assert tapi.cfg == to_torch_config(japi.cfg)
    assert tapi.speakers == (SPEAKERS if name == "multi" else [])
    meta = json.loads((converted / "config.json").read_text())
    assert set(meta) == {"config", "speakers"}
    jout = japi.synthesise(japi.prepare_input(TEXT, **_prompt(name)))
    tout = tapi.synthesise(tapi.prepare_input(TEXT, **_prompt(name)))
    np.testing.assert_array_equal(tout.durations, jout.durations)
    np.testing.assert_array_equal(tout.wav_lengths, jout.wav_lengths)
    np.testing.assert_allclose(tout.wav, jout.wav, atol=ATOL)


def test_converter_refuses_an_incomplete_tree(checkpoints, tmp_path):
    """A JAX checkpoint whose params lack a module the config asks for is an
    error, not a partly random model."""
    import shutil

    import orbax.checkpoint as ocp

    _, japi, jax_ckpt, _ = checkpoints
    broken = tmp_path / "broken"
    broken.mkdir()
    shutil.copy(jax_ckpt / "config.json", broken / "config.json")
    params = {k: v for k, v in japi.params.items() if k != "vocoder"}
    ocp.PyTreeCheckpointer().save(str(broken / "params"), params)
    with pytest.raises(KeyError, match="lack `vocoder"):
        _converter().convert(str(broken), str(tmp_path / "out"))
    assert not (tmp_path / "out" / "generator.pt").exists()


@pytest.mark.parametrize("fused", [False, True])
def test_save_checkpoint_round_trip(tmp_path, fused):
    from optispeech_tpu_torch.models.optispeech import OptiSpeech, with_fused_blocks

    cfg = to_torch_config(small_config(**CONFIGS["multi"]))
    if fused:
        cfg = with_fused_blocks(cfg)
    model = OptiSpeech(cfg, seed=5, device="cpu", speakers=SPEAKERS)
    model.save_checkpoint(str(tmp_path / "ckpt"))
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["config.json",
                                                                       "generator.pt"]
    loaded = OptiSpeech.load_from_checkpoint(str(tmp_path / "ckpt"), device="cpu", fused=fused)
    assert loaded.cfg == model.cfg and loaded.speakers == SPEAKERS
    want_sd, got_sd = model.generator.state_dict(), loaded.generator.state_dict()
    assert set(got_sd) == set(want_sd)
    assert all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd)
    inputs = model.prepare_input(TEXT, speaker="bob", language="en-gb")
    want, got = model.synthesise(inputs), loaded.synthesise(inputs)
    np.testing.assert_array_equal(got.durations, want.durations)
    np.testing.assert_array_equal(got.wav, want.wav)


def _read_wavs(out_dir):
    from optispeech_tpu_torch.utils.wavio import load_wav

    paths = sorted(Path(out_dir).glob("gen-*.wav"))
    return [p.name for p in paths], [load_wav(str(p)) for p in paths]


# the third case's flags: the prompt options the model takes
OPTIONS = {"single": ["--no-split", "--p-factor", "1.2", "--e-factor", "0.8"],
           "multi": ["--speaker", "1", "--language", "en-gb", "--d-factor", "1.5"]}


@pytest.mark.parametrize("case", ["plain", "fused", "options"])
def test_infer_clis_agree(checkpoints, tmp_path, case):
    from optispeech_tpu.cli import infer as jax_infer
    from optispeech_tpu_torch.cli import infer as torch_infer

    name, _, jax_ckpt, converted = checkpoints
    flags = {"plain": [], "fused": ["--fused"], "options": OPTIONS[name]}[case]
    jax_infer.main([str(jax_ckpt), TEXT, str(tmp_path / "jax"), *flags])
    out = torch_infer.main([str(converted), TEXT, str(tmp_path / "torch"), "--device", "cpu",
                            *flags])
    names, want = _read_wavs(tmp_path / "jax")
    got_names, got = _read_wavs(tmp_path / "torch")
    n_wavs = 1 if "--no-split" in flags else 2
    assert got_names == names == [f"gen-{i + 1}.wav" for i in range(n_wavs)]
    for (g, g_sr), (w, w_sr), length in zip(got, want, out.wav_lengths):
        assert g_sr == w_sr == 24000
        assert len(g) == len(w) == length
        np.testing.assert_allclose(g, w, atol=WAV_ATOL)
    assert out.rtf > 0 and out.latency > 0


@pytest.mark.parametrize("fused", [False, True], ids=["bf16", "bf16-fused"])
def test_infer_cli_bf16_matches_jax(checkpoints, tmp_path, monkeypatch, fused):
    import optispeech_tpu.ops.pallas_convnext as pc
    from optispeech_tpu.cli import infer as jax_infer
    from optispeech_tpu_torch.cli import infer as torch_infer

    name, _, jax_ckpt, converted = checkpoints
    flags = ["--bf16", "--fused"] if fused else ["--bf16"]
    orig = pc.convnext_block_fused
    monkeypatch.setattr(pc, "convnext_block_fused",
                        lambda *a, **kw: orig(*a, interpret=True, **kw))
    monkeypatch.setattr(pc, "fused_supported", lambda: True)
    jax_infer.main([str(jax_ckpt), TEXT, str(tmp_path / "jax"), *flags])
    out = torch_infer.main([str(converted), TEXT, str(tmp_path / "torch"), "--device", "cpu",
                            *flags])
    assert out.wav.dtype == np.float32
    names, want = _read_wavs(tmp_path / "jax")
    got_names, got = _read_wavs(tmp_path / "torch")
    assert got_names == names == ["gen-1.wav", "gen-2.wav"]
    for (g, _), (w, _), length in zip(got, want, out.wav_lengths):
        assert len(g) == len(w) == length
        rel = np.abs(g - w).max() / np.abs(w).max()
        print(f"{name} {flags}: max|port - jax| / max|jax| {rel:.3e}")
        assert rel <= BF16_WAV_RTOL


def test_infer_cli_needs_a_device_when_cuda_is_absent(checkpoints, tmp_path, monkeypatch):
    from optispeech_tpu_torch.cli import infer

    _, _, _, converted = checkpoints
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer.main([str(converted), TEXT, str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
