"""Dataset preprocessing CLI (port of `optispeech_tpu/cli/preprocess.py`).

Usage:
    python -m optispeech_tpu_torch.cli.preprocess --config default DATASET_DIR OUTPUT_DIR \
        [--tokenizer en-g2p|char|ipa|raw-ipa] [--workers N] [--val-fraction F] [key=value ...]

Writes the datafiles, filelists and id maps of `data/preprocess.py`; the
work runs on the host (numpy), in `--workers` spawned processes.
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="Preprocess a TTS dataset")
    p.add_argument("dataset_dir", help="directory with metadata.csv and wavs/")
    p.add_argument("output_dir")
    p.add_argument("--config", default="default")
    p.add_argument("--tokenizer", default=None,
                   help="override tokenizer (en-g2p = self-contained English G2P; "
                        "char for espeak-free graphemes)")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--val-fraction", type=float, default=0.02)
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)

    from ..config import merge_overrides
    from ..data.preprocess import FeatureExtractor, preprocess_dataset
    from ..text import TextProcessor
    from ..utils.yamlcfg import load_experiment

    cfg = load_experiment(args.config, args.overrides)
    if args.tokenizer:
        cfg = merge_overrides(cfg, {"data.text_processor.tokenizer": args.tokenizer})
    text_processor = TextProcessor.from_config(cfg.data.text_processor)
    pp = cfg.data.preprocess
    feature_extractor = FeatureExtractor(
        features=cfg.generator.features,
        preemphasis_filter_coef=pp.preemphasis_filter_coef,
        lowpass_freq=pp.lowpass_freq,
        highpass_freq=pp.highpass_freq,
        loudness_norm_target_db=pp.loudness_norm_target_db,
        trim_silence=pp.trim_silence,
        trim_silence_args=dict(
            method=pp.trim_method,
            threshold=pp.trim_silence_threshold,
            threshold_db=pp.trim_silence_threshold_db,
            chunk=pp.trim_silence_chunk,
            keep_chunks_before=pp.trim_keep_chunks_before,
            keep_chunks_after=pp.trim_keep_chunks_after,
        ),
        pitch_extractor=pp.pitch_extractor,
    )
    return preprocess_dataset(
        args.dataset_dir, args.output_dir, text_processor, feature_extractor,
        val_fraction=args.val_fraction, num_workers=args.workers,
    )


if __name__ == "__main__":
    main()
