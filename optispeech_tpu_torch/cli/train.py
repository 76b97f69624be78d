"""Training CLI (port of `optispeech_tpu/cli/train.py`).

Usage:
    python -m optispeech_tpu_torch.cli.train --config default --out-dir runs/lj \
        [data.batch_size=64 ...] [--synthetic] [--device cpu] [--fast-dev-run] [--overfit N]
    python -m optispeech_tpu_torch.cli.train --packed-train train.pak --packed-val val.pak \
        [--device-cache [--cache-mel-dtype bfloat16] [--cache-wav-dtype int16]] ...
    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m optispeech_tpu_torch.cli.train --distributed [--device cpu] ...

`main` parses the flags and loads the YAML config; `run(cfg, args)` builds
the loaders and the `Trainer`, fits, and exports the inference checkpoint to
`<out-dir>/inference_ckpt`, so a caller holding a config built in code needs
no YAML. `--packed-train`/`--packed-val` read arena files of `cli/pack.py`
through the host collator (`data/packed.py`); `--device-cache` uploads the
packed train split to the device once and gathers each batch there
(`data/device_cache.py`); validation stays on the host loader. `--device` defaults to the card. The debug harnesses are JAX's:
--fast-dev-run, --overfit N, --limit FRAC, --debug-nans (autograd anomaly
detection).

`--distributed` trains data parallel, one process per device, in the
process group that `python -m torch.distributed.run` describes
(`parallel.init_distributed`: NCCL on `cuda:{LOCAL_RANK}`, gloo with
`--device cpu`; without that environment it raises). Every loader then
yields this rank's shard of each global batch of `data.batch_size`
(`shard_id=rank, num_shards=world`), a device cache lies whole on every
rank's device, and rank 0 alone writes metrics and checkpoints.
"""

import argparse
import json
import sys
from pathlib import Path

from ..utils.pylogger import get_pylogger

log = get_pylogger("optispeech_tpu_torch.train")

def build_packed_loaders(cfg, packed_train: str, packed_val: str = None,
                         device_cache: bool = False, device=None,
                         cache_mel_dtype: str = "float32", cache_wav_dtype: str = "float32",
                         shard_id: int = 0, num_shards: int = 1):
    """(train loader, val loader or None) over packed arena files: the host
    collator's `PackedLoader`s, or with `device_cache` a `DeviceCacheLoader`
    over the train split uploaded to `device` (validation keeps the host
    loader: it needs the whole ground-truth waveforms). Each yields shard
    `shard_id` of `num_shards` of every global batch."""
    from ..data.packed import PackedDataset, PackedLoader

    d, f_min = cfg.data, cfg.generator.features.f_min
    caps = dict(max_text_len=d.max_text_len, max_mel_len=d.max_mel_len)
    shard = dict(shard_id=shard_id, num_shards=num_shards)

    def host(path, shuffle):
        # val keeps partial batches: a val split smaller than the batch
        # size must still give val metrics
        return PackedLoader(PackedDataset(path, d.statistics, f_min=f_min), d.batch_size,
                            d.text_bucket_size, d.mel_bucket_size, shuffle=shuffle,
                            seed=d.seed, drop_last=shuffle, **caps, **shard)

    val = host(packed_val, False) if packed_val else None
    if not device_cache:
        return host(packed_train, True), val
    from ..data.device_cache import DeviceCacheLoader, DeviceFeatureCache

    cache = DeviceFeatureCache(packed_train, d.statistics, f_min=f_min, device=device,
                               text_bucket=d.text_bucket_size, mel_bucket=d.mel_bucket_size,
                               mel_dtype=cache_mel_dtype, wav_dtype=cache_wav_dtype, **caps)
    train = DeviceCacheLoader(cache, d.batch_size, d.text_bucket_size, d.mel_bucket_size,
                              shuffle=True, seed=d.seed, **caps, **shard)
    return train, val


def build_loaders(cfg, synthetic: bool, overfit: int = 0, limit: float = 1.0,
                  shard_id: int = 0, num_shards: int = 1):
    """(train loader, val loader) over the config's filelists, or over
    synthetic utterances; each yields shard `shard_id` of `num_shards` of
    every global batch."""
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
    shard = dict(shard_id=shard_id, num_shards=num_shards)
    train = DataLoader(train_ds, cfg.data.batch_size, collate, shuffle=True, seed=cfg.data.seed,
                       **shard)
    val = DataLoader(val_ds, cfg.data.batch_size, collate, shuffle=False, drop_last=False,
                     **shard)
    return train, val


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train OptiSpeech (PyTorch port)")
    p.add_argument("--config", default="default")
    p.add_argument("--out-dir", default=None)
    p.add_argument("--device", default=None,
                   help="torch device to train on (default: the CUDA card; `cpu` when asked)")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--synthetic", action="store_true", help="use synthetic data (smoke)")
    p.add_argument("--packed-train", default=None,
                   help="packed .pak train file (cli/pack.py; the host collator)")
    p.add_argument("--packed-val", default=None, help="packed .pak val file")
    p.add_argument("--device-cache", action="store_true",
                   help="upload the packed train features to the device once; each step "
                        "ships only integer indices (requires --packed-train)")
    p.add_argument("--cache-mel-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="device-cache mel arena dtype (bfloat16 halves its bytes)")
    p.add_argument("--cache-wav-dtype", default="float32", choices=["float32", "int16"],
                   help="device-cache wav arena dtype (int16 halves the largest arena)")
    p.add_argument("--fast-dev-run", action="store_true")
    p.add_argument("--overfit", type=int, default=0, help="overfit N batches")
    p.add_argument("--limit", type=float, default=1.0, help="fraction of train data")
    p.add_argument("--debug-nans", action="store_true")
    p.add_argument("--forced-resume", default=None,
                   help="load weights from a train checkpoint directory (G and D) or an "
                        "inference checkpoint (G), with fresh optimizers")
    p.add_argument("--profile-steps", default=None, help="START,STOP torch.profiler capture")
    p.add_argument("--distributed", action="store_true",
                   help="data parallel, one process per device, in the process group of "
                        "`python -m torch.distributed.run` (NCCL; gloo with --device cpu)")
    p.add_argument("--dist-timeout", type=float, default=300,
                   help="seconds a collective of --distributed may wait before it raises")
    p.add_argument("--no-print-config", action="store_true",
                   help="skip the effective config at startup")
    p.add_argument("overrides", nargs="*", help="dotted config overrides key=value")
    args = p.parse_args(argv)
    if args.device_cache and not args.packed_train:
        p.error("--device-cache requires --packed-train")
    return args


def run(cfg, args: argparse.Namespace, train_loader=None, val_loader=None):
    """Train `cfg` as `args` ask: the given loaders, else those of
    `build_packed_loaders` (with --packed-train) or `build_loaders`, then
    `Trainer.init_or_restore_state`, `fit` and the inference checkpoint.
    With --distributed the process group is joined first and left at the
    end. Returns (trainer, final state)."""
    if not args.distributed:
        return _run(cfg, args, train_loader, val_loader)
    import torch.distributed as dist

    from ..parallel import init_distributed, make_mesh

    device = init_distributed(args.device, timeout_s=args.dist_timeout)
    log.info(f"process group: backend {dist.get_backend()}, rank {dist.get_rank()} of "
             f"{dist.get_world_size()}, device {device}")
    try:
        return _run(cfg, args, train_loader, val_loader, device=device,
                    mesh=make_mesh(cfg.num_devices))
    finally:
        dist.destroy_process_group()


def _run(cfg, args, train_loader, val_loader, device=None, mesh=None):
    from ..config import to_dict
    from ..parallel import data_rank, data_size
    from ..training.trainer import Trainer

    out_dir = args.out_dir or f"runs/{cfg.run_name}"
    shard = dict(shard_id=data_rank(mesh), num_shards=data_size(mesh))
    if not args.no_print_config and shard["shard_id"] == 0:
        log.info("Effective config:\n" + json.dumps(to_dict(cfg), indent=2))
    trainer = Trainer(cfg, out_dir=out_dir, device=device or args.device,
                      debug_nans=args.debug_nans, mesh=mesh)
    if train_loader is None and args.packed_train:
        train_loader, val_loader = build_packed_loaders(
            cfg, args.packed_train, args.packed_val, device_cache=args.device_cache,
            device=trainer.device, cache_mel_dtype=args.cache_mel_dtype,
            cache_wav_dtype=args.cache_wav_dtype, **shard)
    elif train_loader is None:
        train_loader, val_loader = build_loaders(cfg, args.synthetic, args.overfit, args.limit,
                                                 **shard)
    log.info(f"Training `{cfg.run_name}` -> {out_dir} on {trainer.device}"
             + (f" (rank {trainer.rank} of {trainer.world})" if mesh is not None else ""))
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
