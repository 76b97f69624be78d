"""Training CLI (port of `optispeech_tpu/cli/train.py`).

Usage:
    python -m optispeech_tpu_torch.cli.train --config default --out-dir runs/lj \
        [data.batch_size=64 ...] [--synthetic] [--device cpu] [--fast-dev-run] [--overfit N]

`main` parses the flags and loads the YAML config; `run(cfg, args)` builds
the loaders and the `Trainer`, fits, and exports the inference checkpoint to
`<out-dir>/inference_ckpt`, so a caller holding a config built in code needs
no YAML. `--device` defaults to the card. The debug harnesses are JAX's:
--fast-dev-run, --overfit N, --limit FRAC, --debug-nans (autograd anomaly
detection).
"""

import argparse
import json
import sys
from pathlib import Path

from ..utils.pylogger import get_pylogger

log = get_pylogger("optispeech_tpu_torch.train")

# flags of the JAX CLI whose paths the port does not have yet
_PACKED = ("--packed-train/--packed-val (the native packed loader) is not ported yet "
           "(ROADMAP.md, queue A item 9)")
NOT_PORTED = {
    "packed_train": _PACKED,
    "packed_val": _PACKED,
    "device_cache": "--device-cache (device-resident features) is not ported yet "
                    "(ROADMAP.md, queue A item 8)",
    "distributed": "--distributed (training over several processes) is not ported yet "
                   "(ROADMAP.md, queue A item 7)",
}


def build_loaders(cfg, synthetic: bool, overfit: int = 0, limit: float = 1.0):
    """(train loader, val loader) over the config's filelists, or over
    synthetic utterances."""
    from ..data.datamodule import BucketedCollate, DataLoader, SyntheticDataset, TextWavDataset

    feats = cfg.generator.features
    collate = BucketedCollate(
        n_feats=feats.n_feats, statistics=cfg.data.statistics, hop_length=feats.hop_length,
        text_bucket=cfg.data.text_bucket_size, mel_bucket=cfg.data.mel_bucket_size,
        max_text_len=cfg.data.max_text_len, max_mel_len=cfg.data.max_mel_len)
    if synthetic:
        train_ds = SyntheticDataset(n_items=max(cfg.data.batch_size * 4, 64),
                                    n_feats=feats.n_feats, hop_length=feats.hop_length)
        val_ds = SyntheticDataset(n_items=cfg.data.batch_size, n_feats=feats.n_feats,
                                  hop_length=feats.hop_length, seed=1)
    else:
        train_ds = TextWavDataset(cfg.data.train_filelist_path, f_min=feats.f_min,
                                  seed=cfg.data.seed)
        val_ds = TextWavDataset(cfg.data.valid_filelist_path, f_min=feats.f_min)
    if overfit:
        if hasattr(train_ds, "file_paths"):
            train_ds.file_paths = train_ds.file_paths[: overfit * cfg.data.batch_size]
        if hasattr(train_ds, "items"):
            train_ds.items = train_ds.items[: overfit * cfg.data.batch_size]
    if limit < 1.0 and hasattr(train_ds, "file_paths"):
        n = max(int(len(train_ds.file_paths) * limit), cfg.data.batch_size)
        train_ds.file_paths = train_ds.file_paths[:n]
    train = DataLoader(train_ds, cfg.data.batch_size, collate, shuffle=True, seed=cfg.data.seed)
    val = DataLoader(val_ds, cfg.data.batch_size, collate, shuffle=False, drop_last=False)
    return train, val


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train OptiSpeech (PyTorch port)")
    p.add_argument("--config", default="default")
    p.add_argument("--out-dir", default=None)
    p.add_argument("--device", default=None,
                   help="torch device to train on (default: the CUDA card; `cpu` when asked)")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--synthetic", action="store_true", help="use synthetic data (smoke)")
    p.add_argument("--packed-train", default=None, help="not ported yet")
    p.add_argument("--packed-val", default=None, help="not ported yet")
    p.add_argument("--device-cache", action="store_true", help="not ported yet")
    p.add_argument("--fast-dev-run", action="store_true")
    p.add_argument("--overfit", type=int, default=0, help="overfit N batches")
    p.add_argument("--limit", type=float, default=1.0, help="fraction of train data")
    p.add_argument("--debug-nans", action="store_true")
    p.add_argument("--forced-resume", default=None,
                   help="load weights from a train checkpoint directory (G and D) or an "
                        "inference checkpoint (G), with fresh optimizers")
    p.add_argument("--profile-steps", default=None, help="START,STOP torch.profiler capture")
    p.add_argument("--distributed", action="store_true", help="not ported yet")
    p.add_argument("--no-print-config", action="store_true",
                   help="skip the effective config at startup")
    p.add_argument("overrides", nargs="*", help="dotted config overrides key=value")
    return p.parse_args(argv)


def _check_ported(args: argparse.Namespace):
    for flag, message in NOT_PORTED.items():
        if getattr(args, flag, None):
            raise NotImplementedError(message)


def run(cfg, args: argparse.Namespace, train_loader=None, val_loader=None):
    """Train `cfg` as `args` ask: the loaders of `build_loaders` unless
    given, `Trainer.init_or_restore_state`, `fit`, then the inference
    checkpoint. Returns (trainer, final state)."""
    from ..config import to_dict
    from ..training.trainer import Trainer

    _check_ported(args)
    out_dir = args.out_dir or f"runs/{cfg.run_name}"
    if not args.no_print_config:
        log.info("Effective config:\n" + json.dumps(to_dict(cfg), indent=2))
    trainer = Trainer(cfg, out_dir=out_dir, device=args.device, debug_nans=args.debug_nans)
    if train_loader is None:
        train_loader, val_loader = build_loaders(cfg, args.synthetic, args.overfit, args.limit)
    log.info(f"Training `{cfg.run_name}` -> {out_dir} on {trainer.device}")
    state = trainer.init_or_restore_state(forced_resume_from=args.forced_resume)
    profile_steps = (tuple(int(s) for s in args.profile_steps.split(","))
                     if args.profile_steps else None)
    state = trainer.fit(train_loader, val_loader, max_steps=args.max_steps, state=state,
                        fast_dev_run=args.fast_dev_run, profile_steps=profile_steps)
    trainer.export_inference_checkpoint(state, f"{out_dir}/inference_ckpt")
    log.info("Done.")
    return trainer, state


def main(argv=None) -> int:
    args = parse_args(argv)
    _check_ported(args)
    from ..config import finalize, merge_overrides
    from ..utils.yamlcfg import load_experiment

    cfg = load_experiment(args.config, args.overrides)
    # the speaker count from the preprocessing outputs
    sid_map = Path(cfg.data.train_filelist_path).parent / "speaker_ids.json"
    if not args.synthetic and sid_map.exists() and cfg.data.num_speakers == 1:
        n = len(json.loads(sid_map.read_text()))
        if n > 1:
            cfg = finalize(merge_overrides(cfg, {"data.num_speakers": n}))
            log.info(f"Detected {n} speakers from {sid_map}")
    run(cfg, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
