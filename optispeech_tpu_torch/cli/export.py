"""Export CLI (port of `optispeech_tpu/cli/export.py`).

Usage:
    python -m optispeech_tpu_torch.cli.export CKPT_DIR OUT_DIR [--text-buckets 32,64,128]
        [--frames-per-token 12] [--batch-sizes 1,2,4,8] [--stream-chunk-frames 256]

The checkpoint is loaded on the CPU with its decoder and vocoder trunk on
the fused block, as `cli/serve.py` serves a live checkpoint, and traced
there. B1 is one registered op in the graphs, so the artifact stays
portable: it replays B1's twin on the CPU and B1's kernel on the card
(JAX's CLI exports unfused, since its Pallas kernel does not run on the
CPU). `main(argv)` returns the artifact's directory.
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="Export an inference artifact (torch.export graphs "
                                            "+ parameters + metadata)")
    p.add_argument("checkpoint", help="inference checkpoint directory")
    p.add_argument("output_dir")
    p.add_argument("--text-buckets", default="32,64,128")
    p.add_argument("--frames-per-token", type=int, default=12)
    p.add_argument("--batch-sizes", default="1,2,4,8",
                   help="power-of-two batch rung ladder for serving coalescing")
    p.add_argument("--stream-chunk-frames", type=int, default=256,
                   help="frames per /stream window (0 skips stream graphs)")
    args = p.parse_args(argv)

    from ..export.exporter import export_model
    from ..models.optispeech import OptiSpeech

    model = OptiSpeech.load_from_checkpoint(args.checkpoint, device="cpu", fused=True)
    return export_model(
        model, args.output_dir,
        text_buckets=[int(b) for b in args.text_buckets.split(",")],
        frames_per_token=args.frames_per_token,
        batch_sizes=[int(b) for b in args.batch_sizes.split(",")],
        stream_chunk_frames=args.stream_chunk_frames or None,
    )


if __name__ == "__main__":
    main()
