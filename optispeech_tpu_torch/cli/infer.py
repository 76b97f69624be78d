"""Inference CLI (port of `optispeech_tpu/cli/infer.py`).

Usage:
    python -m optispeech_tpu_torch.cli.infer CKPT_DIR "Some text" OUT_DIR \
        [--d-factor F] [--p-factor F] [--e-factor F] [--language L] [--speaker S] \
        [--no-split] [--fused] [--bf16] [--device cpu]

CKPT_DIR is the port's inference checkpoint (`config.json` + `generator.pt`:
`OptiSpeech.save_checkpoint`, the trainer's `inference_ckpt/`, or
`scripts/jax_ckpt_to_torch.py` applied to a JAX package checkpoint).
`--bf16` computes in bfloat16 as JAX's `--bf16` does (the weights stay
float32); with `--fused` the fused blocks then take bf16 activations. Writes
`gen-<i>.wav` per sentence and logs the RTF and the latency. `--device`
defaults to the card and raises without one. `main(argv)` returns the
`InferenceOutputs`.
"""

import argparse
from pathlib import Path

from ..utils.pylogger import get_pylogger

log = get_pylogger("optispeech_tpu_torch.infer")


def main(argv=None):
    p = argparse.ArgumentParser(description="Synthesise speech from a checkpoint")
    p.add_argument("checkpoint", help="inference checkpoint directory")
    p.add_argument("text")
    p.add_argument("output_dir")
    p.add_argument("--d-factor", type=float, default=None, help="speech rate scale")
    p.add_argument("--p-factor", type=float, default=None, help="pitch scale")
    p.add_argument("--e-factor", type=float, default=None, help="energy scale")
    p.add_argument("--language", default=None)
    p.add_argument("--speaker", default=None)
    p.add_argument("--no-split", action="store_true", help="do not split sentences")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 activations (the weights stay float32)")
    p.add_argument("--fused", action="store_true",
                   help="fused ConvNeXt blocks in the decoder and the vocoder trunk "
                        "(the CUDA kernel on the card, its twin on the CPU)")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; `cpu` when asked)")
    args = p.parse_args(argv)

    import torch

    from ..models.optispeech import OptiSpeech
    from ..utils.wavio import save_wav

    model = OptiSpeech.load_from_checkpoint(
        args.checkpoint, device=args.device, fused=args.fused,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32)
    speaker = args.speaker
    if speaker is not None and speaker.isdigit():
        speaker = int(speaker)
    inputs = model.prepare_input(
        args.text,
        language=args.language,
        speaker=speaker,
        d_factor=args.d_factor,
        p_factor=args.p_factor,
        e_factor=args.e_factor,
        split_sentences=not args.no_split,
    )
    outputs = model.synthesise(inputs)
    log.info(f"RTF: {outputs.rtf:.6f} (am {outputs.am_rtf:.6f} + voc {outputs.v_rtf:.6f})")
    log.info(f"Latency: {outputs.latency:.1f} ms")
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, wav in enumerate(outputs):
        path = out_dir / f"gen-{i + 1}.wav"
        save_wav(str(path), wav, model.sample_rate)
        log.info(f"Wrote {path}")
    return outputs


if __name__ == "__main__":
    main()
