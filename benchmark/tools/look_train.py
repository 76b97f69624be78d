#!/usr/bin/env python3
"""Why the training cell's first gradients differ leaf by leaf: the plain
reference's first step in float32 against the same step with TF32 on (the
precision of the program's convolutions), from the same weights, batch and
step RNG. Prints, per seed, the widest leaves' gradient gaps and how many
tokens the two alignments give other durations (and how many of those move
between 0 and at least 1 frame: a token at 0 frames has the target
log(1e-8) in the duration loss).

    python3 benchmark/tools/look_train.py --seeds N1 N2 ...

Needs a card.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from harness import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="convnext.train")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    common.checkout_env()
    import torch

    from harness.weights import init_critics, seeded_state_dict
    from reference.training import Optimizer, generator_forward, train_step

    w = common.workload(args.workload)
    cfg = common.config(w["config"])
    traffic = common.load_module("traffic", w["traffic"])
    for seed in args.seeds:
        ctx = common.Context(cell=args.workload, workload=w, config=cfg, seed=seed)
        cell = traffic.Cell(ctx)
        gen, disc = cell._reference_models()
        cell.g0 = seeded_state_dict(gen, seed, "cuda")
        init_critics(disc, seed + 1, "cuda")
        cell.d0 = {k: v.detach().clone() for k, v in disc.state_dict().items()}
        cell.rng_seed = (seed + 4) % 2 ** 63
        batch = cell.make_batches("cuda")[0]
        c = cell.cfg["config"]
        out = {}
        for tf32 in (False, True):
            g, d = cell._replay_models()
            rng = torch.Generator(device="cuda").manual_seed(cell.rng_seed)
            with common.reference_mode(), torch.enable_grad():
                torch.backends.cudnn.allow_tf32 = tf32
                _, _, durations = generator_forward(g, c["generator"], batch, rng)
                rng = torch.Generator(device="cuda").manual_seed(cell.rng_seed)
                _, _, g_grads, d_grads = train_step(g, d, Optimizer(g.parameters(), c),
                                                    Optimizer(d.parameters(), c), batch, rng, c)
            out[tf32] = (durations, {k: float(t.norm()) for (k, _), t in
                                     zip(list(g.named_parameters()) + list(d.named_parameters()),
                                         list(g_grads) + list(d_grads))})
        (d32, g32), (dtf, gtf) = out[False], out[True]
        valid = torch.arange(d32.shape[1], device="cuda")[None, :] < batch["x_lengths"][:, None]
        differ = ((d32 != dtf) & valid).sum().item()
        zero_flip = (((d32 == 0) != (dtf == 0)) & valid).sum().item()
        gaps = traffic._leaf_gaps(gtf, g32, sorted(g32))
        worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:6]
        print(json.dumps({"seed": seed, "tokens": int(valid.sum().item()), "durations_differ": differ,
                          "zero_flips": zero_flip, "zero_tokens": int(((d32 == 0) & valid).sum()),
                          "widest": worst,
                          "median_gap": float(sorted(gaps.values())[len(gaps) // 2])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
