"""Gradio demo of a live checkpoint (port of `optispeech_tpu/cli/demo.py`).

Usage:
    python -m optispeech_tpu_torch.cli.demo CKPT_DIR [--port 7860] [--share] [--device cpu]

CKPT_DIR is an inference checkpoint (`OptiSpeech.save_checkpoint`, the
trainer's `inference_ckpt/`, `cli/average.py`'s output), loaded with the
fused blocks on the card unless `--device` says otherwise. Needs the
optional `gradio` package: `main` exits with a message without it.
"""

import argparse

import numpy as np


def make_tts(model):
    """The demo's callback: (text, d, p, e) -> ((sample rate, wav), stats
    line), sentence by sentence through `model.synthesise`."""

    def tts(text, d_factor, p_factor, e_factor):
        inputs = model.prepare_input(text, d_factor=d_factor, p_factor=p_factor,
                                     e_factor=e_factor, split_sentences=True)
        out = model.synthesise(inputs)
        wav = np.concatenate(list(out))
        return (model.sample_rate, wav), f"RTF {out.rtf:.4f} | latency {out.latency:.0f} ms"

    return tts


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Web demo for an OptiSpeech checkpoint")
    p.add_argument("checkpoint")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--share", action="store_true")
    p.add_argument("--device", default=None,
                   help="device to synthesise on (default: the CUDA card; `cpu` when asked)")
    args = p.parse_args(argv)

    try:
        import gradio as gr
    except ImportError:
        raise SystemExit("The demo requires the optional `gradio` package (pip install gradio).")
    from ..models.optispeech import OptiSpeech

    model = OptiSpeech.load_from_checkpoint(args.checkpoint, device=args.device, fused=True)
    ia = model.inference_args
    demo = gr.Interface(
        fn=make_tts(model),
        inputs=[gr.Textbox(label="Text"),
                gr.Slider(0.5, 2.0, value=ia.d_factor, label="Duration factor"),
                gr.Slider(0.5, 2.0, value=ia.p_factor, label="Pitch factor"),
                gr.Slider(0.5, 2.0, value=ia.e_factor, label="Energy factor")],
        outputs=[gr.Audio(label="Audio"), gr.Textbox(label="Stats")],
        title="OptiSpeech")
    demo.launch(server_port=args.port, share=args.share)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
