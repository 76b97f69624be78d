"""Pack preprocessed datafiles into the arena format of the packed data
path (port of `optispeech_tpu/cli/pack.py`).

Usage:
    python -m optispeech_tpu_torch.cli.pack FILELIST OUTPUT.pak [--config default] \
        [key=value ...]

The config gives `n_feats` and `hop_length`; nothing runs on a device.
"""

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Pack datafiles into the mmap arena format")
    p.add_argument("filelist")
    p.add_argument("output")
    p.add_argument("--config", default="default")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)

    from ..data.packed import pack_dataset
    from ..utils.yamlcfg import load_experiment

    cfg = load_experiment(args.config, args.overrides)
    pack_dataset(args.filelist, args.output, n_feats=cfg.generator.features.n_feats,
                 hop_length=cfg.generator.features.hop_length)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
