"""Synthesis CLI over an exported artifact (port of
`optispeech_tpu/cli/speak.py`, the role of the reference's standalone
`ospeech` runtime): speak text from an artifact without the model's code.

Usage:
    python -m optispeech_tpu_torch.cli.speak ARTIFACT_DIR "Text to speak" OUTPUT_DIR \
        [--d-factor 1.0 --p-factor 1.0 --e-factor 1.0] \
        [--speaker NAME_OR_ID --language LANG] [--no-split] [--device cpu]

Writes `gen-{i}.wav` per sentence and logs the latency and the RTF.
`--device` defaults to the card and raises without one. `main(argv)`
returns the `InferenceOutputs`.
"""

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="Synthesise speech from an exported artifact")
    p.add_argument("artifact", help="exported artifact directory (cli.export output)")
    p.add_argument("text", help="text to speak")
    p.add_argument("output_dir", help="directory to write generated audio to")
    p.add_argument("--d-factor", type=float, default=None, help="speech-rate scale")
    p.add_argument("--p-factor", type=float, default=None, help="pitch scale")
    p.add_argument("--e-factor", type=float, default=None, help="energy scale")
    p.add_argument("--speaker", default=None, help="speaker name or id (multi-speaker models)")
    p.add_argument("--language", default=None, help="language (multi-language models)")
    p.add_argument("--no-split", action="store_true", help="don't split text into sentences")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; `cpu` when asked)")
    args = p.parse_args(argv)

    from ..export.exporter import ExportedOptiSpeech
    from ..utils.pylogger import get_pylogger
    from ..utils.wavio import save_wav

    log = get_pylogger("optispeech_tpu_torch.speak")
    model = ExportedOptiSpeech(args.artifact, device=args.device)
    speaker = args.speaker
    if speaker is not None and speaker.isdigit():
        speaker = int(speaker)
    inputs = model.prepare_input(
        args.text, lang=args.language, speaker=speaker,
        split_sentences=not args.no_split,
        d_factor=args.d_factor, p_factor=args.p_factor, e_factor=args.e_factor,
    )
    log.info(f"Normalized text: {inputs.clean_text}")
    outputs = model.synthesise(inputs)

    os.makedirs(args.output_dir, exist_ok=True)
    for i, wav in enumerate(outputs.unbatched_wavs()):
        out_wav = os.path.join(args.output_dir, f"gen-{i + 1}.wav")
        save_wav(out_wav, wav.squeeze(), model.sample_rate)
        log.info(f"Wrote wav to: `{out_wav}`")
    log.info(f"OptiSpeech latency: {round(outputs.latency)} ms")
    log.info(f"OptiSpeech RTF: {outputs.rtf:.4f}")
    return outputs


if __name__ == "__main__":
    main()
