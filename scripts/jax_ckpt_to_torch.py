#!/usr/bin/env python3
"""Convert an `optispeech_tpu` (JAX) inference checkpoint into the PyTorch
port's format.

    python scripts/jax_ckpt_to_torch.py JAX_CKPT OUT_DIR

JAX_CKPT holds orbax `params/` beside `config.json`
(`optispeech_tpu.training.checkpoint.save_inference_checkpoint`: the
trainer's `inference_ckpt/`, `OptiSpeech.save_checkpoint`). OUT_DIR receives
the port's `config.json` (the config and the speaker list) and
`generator.pt`, which `optispeech_tpu_torch`'s `OptiSpeech.load_from_checkpoint`
and `cli/infer.py` read. The params go through
`optispeech_tpu_torch.compat.from_jax.state_dict_from_jax_params` as numpy.

It reads the checkpoint with the JAX package, so it needs JAX and orbax, and
lives outside the port's package, which imports neither.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def convert(jax_ckpt: str, out_dir: str):
    """Write the port's inference checkpoint for `jax_ckpt` into `out_dir`;
    returns the port's config."""
    from optispeech_tpu.training.checkpoint import load_inference_checkpoint
    from optispeech_tpu_torch.compat.from_jax import state_dict_from_jax_params
    from optispeech_tpu_torch.config import ExperimentConfig, from_dict
    from optispeech_tpu_torch.training.checkpoint import save_inference_checkpoint

    _, params, meta = load_inference_checkpoint(jax_ckpt)
    cfg = from_dict(ExperimentConfig, meta["config"])
    state_dict = state_dict_from_jax_params(params, cfg.generator)
    save_inference_checkpoint(out_dir, cfg, state_dict, speakers=meta.get("speakers") or [])
    return cfg


def main(argv=None):
    p = argparse.ArgumentParser(description="Convert a JAX inference checkpoint to the port's")
    p.add_argument("jax_ckpt", help="the JAX package's inference checkpoint directory")
    p.add_argument("out_dir", help="where to write config.json and generator.pt")
    args = p.parse_args(argv)
    convert(args.jax_ckpt, args.out_dir)
    print(f"wrote {args.out_dir}")


if __name__ == "__main__":
    main()
