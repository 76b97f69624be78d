"""Data statistics CLI (port of `optispeech_tpu/cli/stats.py`).

Usage:
    python -m optispeech_tpu_torch.cli.stats --config default [-o stats.json] [key=value ...]

Reads the config's train filelist with raw (un-normalised) features and
writes the `data.statistics` block as JSON.
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="Compute dataset normalization statistics")
    p.add_argument("--config", default="default")
    p.add_argument("-o", "--output-file", default="stats.json")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)

    from ..data.datamodule import BucketedCollate, DataLoader, TextWavDataset
    from ..data.statistics import calculate_data_statistics, write_stats
    from ..utils.yamlcfg import load_experiment

    cfg = load_experiment(args.config, args.overrides)
    ds = TextWavDataset(cfg.data.train_filelist_path, f_min=cfg.generator.features.f_min)
    collate = BucketedCollate(
        n_feats=cfg.generator.features.n_feats,
        statistics=cfg.data.statistics,
        hop_length=cfg.generator.features.hop_length,
        do_normalize=False,  # statistics come from raw features
    )
    loader = DataLoader(ds, args.batch_size, collate, shuffle=False, drop_last=False)
    stats = calculate_data_statistics(loader)
    write_stats(stats, args.output_file)
    return stats


if __name__ == "__main__":
    main()
