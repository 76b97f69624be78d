"""Checkpoint-averaging CLI (port of `optispeech_tpu/cli/average.py`).

    python -m optispeech_tpu_torch.cli.average RUN_DIR [-o OUT] [--last 5 | --steps ...]
        [--packed-val VAL.pak [--compare]] [--device cpu]

Averages the generator weights over the last N retained training
checkpoints of RUN_DIR (a `cli.train --out-dir`) and writes an inference
checkpoint that `OptiSpeech.load_from_checkpoint` and `cli/infer.py` load
(training/average.py says why tail averaging helps a GAN generator). With
`--packed-val` it runs the trainer's validation pass (losses, and the
perceptual metrics the run's config asks for, on real synthesis) on the
averaged generator with the newest step's discriminator; `--compare` runs
the newest checkpoint first, so its `val/synth_wav_delta` measures the
average's drift from it, and both land in RUN_DIR/avg_eval/compare.json.
The averaging runs on the host; the validation on the card unless
`--device` says otherwise.
"""

import argparse
import json
import os


def _eval_params(trainer, loader, g_state: dict, d_state: dict, step: int) -> dict:
    """`Trainer.validate` on a state holding these weights (fresh optimisers)."""
    from ..training.state import init_train_state

    state = init_train_state(trainer.cfg, trainer.device)
    state.generator.load_state_dict(g_state)
    state.discriminator.load_state_dict(d_state)
    state.step = step
    return trainer.validate(state, loader, step)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("run_dir", help="cli.train --out-dir (contains checkpoints/)")
    p.add_argument("-o", "--out", default=None,
                   help="output inference checkpoint (default RUN_DIR/avg_ckpt)")
    p.add_argument("--last", type=int, default=5,
                   help="average the newest N retained checkpoints")
    p.add_argument("--steps", type=int, nargs="+", default=None,
                   help="explicit checkpoint steps to average (overrides --last)")
    p.add_argument("--packed-val", default=None,
                   help="packed .pak val file: run the validation pass on the average")
    p.add_argument("--compare", action="store_true",
                   help="with --packed-val: also validate the newest checkpoint")
    p.add_argument("--device", default=None,
                   help="device of the validation (default: the CUDA card; `cpu` when asked)")
    args = p.parse_args(argv)

    from ..training.average import average_generator_params, load_run_config
    from ..training.checkpoint import save_inference_checkpoint

    run = os.path.abspath(os.path.expanduser(args.run_dir))
    ckpt_dir = os.path.join(run, "checkpoints")
    if not os.path.isdir(ckpt_dir):
        raise SystemExit(f"no checkpoints/ under {run}")
    cfg = load_run_config(ckpt_dir)
    avg, steps, last_raw = average_generator_params(ckpt_dir, steps=args.steps,
                                                    last_n=args.last)
    out = args.out or os.path.join(run, "avg_ckpt")
    save_inference_checkpoint(out, cfg, avg)
    print(json.dumps({"averaged_steps": steps, "out": out}), flush=True)

    if args.packed_val:
        from ..data.packed import PackedDataset, PackedLoader
        from ..training.trainer import Trainer

        trainer = Trainer(cfg, out_dir=os.path.join(run, "avg_eval"), device=args.device)
        d = cfg.data
        loader = PackedLoader(
            PackedDataset(args.packed_val, d.statistics, f_min=cfg.generator.features.f_min),
            d.batch_size, d.text_bucket_size, d.mel_bucket_size, shuffle=False, seed=d.seed,
            drop_last=False, max_text_len=d.max_text_len, max_mel_len=d.max_mel_len)
        last_step = int(last_raw["step"])
        results = {}
        if args.compare:
            results["last"] = _eval_params(trainer, loader, last_raw["generator"],
                                           last_raw["discriminator"], last_step)
        results["averaged"] = _eval_params(trainer, loader, avg, last_raw["discriminator"],
                                           last_step + 1)
        trainer.metrics.close()
        cmp_path = os.path.join(run, "avg_eval", "compare.json")
        with open(cmp_path, "w") as f:
            json.dump({"averaged_steps": steps, **results}, f, indent=2)
        print(json.dumps({"compare": cmp_path, **{
            k: {m: round(v, 4) for m, v in r.items() if m.startswith(("val/", "total_loss/"))}
            for k, r in results.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
