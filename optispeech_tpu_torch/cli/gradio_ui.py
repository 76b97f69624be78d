"""Gradio demo UI over an exported artifact (port of
`optispeech_tpu/cli/gradio_ui.py`): a text box, a speaker choice and the
d/p/e sliders, to an audio player. `gradio` is an optional dependency: the
module imports without it, and `main` exits with a message when it is
missing.

Usage:
    python -m optispeech_tpu_torch.cli.gradio_ui ARTIFACT_DIR [--host 0.0.0.0 --port 7860]
        [--share] [--char-limit N] [--device cpu]

The artifact is an `export/exporter.py` directory (`cli/export.py`), loaded
by `ExportedOptiSpeech` on the card unless `--device` says otherwise.
"""

import argparse

import numpy as np


def make_speak(model, char_limit=None):
    """The UI's callback: (text, speaker, d, p, e) -> ((sample rate, wav),
    stats line), through `model.prepare_input` and `model.synthesise`."""

    def speak(text, speaker, d_factor, p_factor, e_factor):
        if char_limit:
            text = text[:char_limit]
        inputs = model.prepare_input(text, speaker=(speaker or None), split_sentences=True,
                                     d_factor=d_factor, p_factor=p_factor, e_factor=e_factor)
        out = model.synthesise(inputs)
        wav = np.concatenate([w.squeeze() for w in out.unbatched_wavs()])
        return (model.sample_rate, wav), f"RTF: {out.rtf:.4f}  latency: {out.latency:.0f} ms"

    return speak


def build_ui(model, char_limit=None):
    import gradio as gr

    speakers = getattr(model, "speakers", None) or []
    with gr.Blocks(title="OptiSpeech") as ui:
        text = gr.Textbox(label="Text", lines=3)
        speaker = (gr.Dropdown(speakers, label="Speaker", value=speakers[0])
                   if speakers else gr.Textbox(visible=False))
        d = gr.Slider(0.5, 2.0, value=1.0, label="Rate (d_factor)")
        p = gr.Slider(0.5, 2.0, value=1.0, label="Pitch (p_factor)")
        e = gr.Slider(0.5, 2.0, value=1.0, label="Energy (e_factor)")
        audio = gr.Audio(label="Output")
        stats = gr.Textbox(label="Stats", interactive=False)
        gr.Button("Speak").click(make_speak(model, char_limit), [text, speaker, d, p, e],
                                 [audio, stats])
    return ui


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Gradio demo for an exported OptiSpeech artifact")
    p.add_argument("artifact", help="exported artifact directory (cli/export.py)")
    p.add_argument("-s", "--share", action="store_true", help="generate a gradio share link")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--char-limit", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="device of the replay (default: the CUDA card; `cpu` when asked)")
    args = p.parse_args(argv)

    try:
        import gradio  # noqa: F401
    except ImportError:
        raise SystemExit("gradio is not installed; `pip install gradio` to use the demo UI")
    from ..export.exporter import ExportedOptiSpeech

    model = ExportedOptiSpeech(args.artifact, device=args.device)
    build_ui(model, args.char_limit).launch(server_name=args.host, server_port=args.port,
                                            share=args.share)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
