"""The port's model zoo CLI (cli/models.py) against a local file:// index
of a port artifact (`export/exporter.py`): `ls`, `download` and replaying
the downloaded artifact, an unknown id, an index path that escapes the
destination, no zoo given; and the gradio gates of cli/demo.py and
cli/gradio_ui.py, with their callbacks driven on a stub model (gradio is
absent here)."""

import json
import sys
import types

import numpy as np
import pytest
import torch

from optispeech_tpu_torch.cli import demo, gradio_ui
from optispeech_tpu_torch.cli.models import ZOO_ENV, download_model, get_models, main
from torch_parity import small_config, to_torch_config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """A zoo holding one exported port artifact (one text bucket, batch 1)."""
    from optispeech_tpu_torch.export.exporter import export_model
    from optispeech_tpu_torch.models.optispeech import OptiSpeech

    root = tmp_path_factory.mktemp("zoo")
    art = root / "en" / "tiny"
    model = OptiSpeech(to_torch_config(small_config()), seed=0, device="cpu")
    export_model(model, str(art), text_buckets=(32,), batch_sizes=(1,),
                 stream_chunk_frames=0)
    files = sorted(str(p.relative_to(root)) for p in art.rglob("*") if p.is_file())
    (root / "models.json").write_text(json.dumps({"models": [
        {"id": "en-tiny", "name": "tiny test voice", "lang": "en", "files": files}]}))
    return root.as_uri() + "/", art, files


def test_ls_and_download_an_artifact_that_replays(zoo, tmp_path, capsys):
    from optispeech_tpu_torch.export.exporter import ExportedOptiSpeech

    url, art, files = zoo
    assert [m["id"] for m in get_models(url)] == ["en-tiny"]
    assert main(["--zoo-url", url, "ls"]) == 0
    assert "en-tiny" in capsys.readouterr().out
    dest = download_model(url, "en-tiny", str(tmp_path / "dl"))
    assert dest == str((tmp_path / "dl" / "en-tiny").resolve())
    for f in files:  # the layout is kept, byte for byte
        assert (tmp_path / "dl" / "en-tiny" / f).read_bytes() == (art.parents[1] / f).read_bytes()
    model = ExportedOptiSpeech(str(tmp_path / "dl" / "en-tiny" / "en" / "tiny"), device="cpu")
    out = model.synthesise(model.prepare_input("A short test sentence."))
    assert np.isfinite(out.wav).all() and out.wav_lengths[0] > 0


def test_download_through_the_environment_variable(zoo, tmp_path, monkeypatch):
    url, _, files = zoo
    monkeypatch.setenv(ZOO_ENV, url)
    assert main(["download", "en-tiny", str(tmp_path / "env")]) == 0
    assert all((tmp_path / "env" / "en-tiny" / f).exists() for f in files)


def test_unknown_model_and_no_zoo(zoo, tmp_path, monkeypatch):
    url, _, _ = zoo
    with pytest.raises(SystemExit, match="unknown model id `nope`"):
        download_model(url, "nope", str(tmp_path / "dl"))
    monkeypatch.delenv(ZOO_ENV, raising=False)
    with pytest.raises(SystemExit, match="no model zoo given"):
        main(["ls"])


def test_index_paths_that_escape_are_refused(tmp_path):
    zoo = tmp_path / "zoo"
    zoo.mkdir()
    (tmp_path / "escape.bin").write_bytes(b"x")
    (zoo / "models.json").write_text(json.dumps(
        {"models": [{"id": "evil", "files": ["../../escape.bin"]},
                    {"id": "abs", "files": [str(tmp_path / "escape.bin")]}]}))
    for model_id in ("evil", "abs"):
        with pytest.raises(SystemExit, match="outside"):
            download_model(zoo.as_uri() + "/", model_id, str(tmp_path / "dl"))
    assert not any((tmp_path / "dl").rglob("*.bin"))


@pytest.mark.parametrize("entry", [lambda: gradio_ui.main(["/nonexistent"]),
                                   lambda: demo.main(["/nonexistent"])],
                         ids=["gradio_ui", "demo"])
def test_gradio_gates(entry):
    try:
        import gradio  # noqa: F401
        pytest.skip("gradio is installed; the gate is not reached")
    except ImportError:
        pass
    with pytest.raises(SystemExit, match="gradio"):
        entry()


class StubModel:
    """Records the synthesis calls the UI makes; returns two sentences."""
    sample_rate = 24000
    speakers = ["alice", "bob"]

    def __init__(self):
        self.calls = []

    def prepare_input(self, text, **kw):
        self.calls.append(("prepare_input", text, kw))
        return "inputs"

    def synthesise(self, inputs):
        from optispeech_tpu_torch.values import InferenceOutputs

        self.calls.append(("synthesise", inputs))
        wav = np.arange(12, dtype=np.float32).reshape(2, 6)
        return InferenceOutputs(wav=wav, wav_lengths=np.array([6, 4]), latency=12.0, rtf=0.5)


def test_build_ui_wires_the_synthesis_callback(monkeypatch):
    """`build_ui` over a stub gradio: the button's callback prepares the text
    cut to the char limit, with the speaker and the factors, and returns the
    sentences' audio joined."""
    clicks = []

    class Widget:
        def __init__(self, *args, **kw):
            self.args, self.kw = args, kw

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def click(self, fn, inputs, outputs):
            clicks.append((fn, inputs, outputs))

    fake = types.ModuleType("gradio")
    for name in ("Blocks", "Textbox", "Dropdown", "Slider", "Audio", "Button"):
        setattr(fake, name, Widget)
    monkeypatch.setitem(sys.modules, "gradio", fake)
    model = StubModel()
    gradio_ui.build_ui(model, char_limit=9)
    (fn, inputs, outputs), = clicks
    assert len(inputs) == 5 and len(outputs) == 2
    (sr, wav), stats = fn("Some long text.", "bob", 1.5, 0.9, 1.1)
    assert model.calls[0] == ("prepare_input", "Some long",
                              dict(speaker="bob", split_sentences=True, d_factor=1.5,
                                   p_factor=0.9, e_factor=1.1))
    assert sr == 24000 and wav.tolist() == list(range(6)) + list(range(6, 10))
    assert stats == "RTF: 0.5000  latency: 12 ms"


def test_demo_callback_synthesises_sentence_by_sentence():
    model = StubModel()
    (sr, wav), stats = demo.make_tts(model)("One. Two.", 1.0, 1.2, 0.8)
    assert model.calls[0] == ("prepare_input", "One. Two.",
                              dict(d_factor=1.0, p_factor=1.2, e_factor=0.8,
                                   split_sentences=True))
    assert sr == 24000 and len(wav) == 10 and stats == "RTF 0.5000 | latency 12 ms"
