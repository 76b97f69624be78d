#!/usr/bin/env python3
"""The compared numbers of a cell over many seeds, in one process: the
readings that the comparison's limits are set from.

    python3 benchmark/tools/readings.py --workload CELL --seconds S \\
        [--control] --seeds N1 N2 ...

Each seed builds the cell (weights, traffic, warm-up), runs a window of S
seconds and compares its outputs with the reference, as a run does; with
`--control` the program runs its bfloat16 path in place of the precision
the configuration states; with `--fault NAME` a fault of `faults.py` is
planted in the program. One JSON line per seed: the seed, the numbers and
whether each is within the cell's current limit. Needs a card.
"""

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from faults import FAULTS, planted  # noqa: E402
from harness import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(FAULTS), help="a fault planted in the program")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    common.checkout_env()
    import torch

    w = common.workload(args.workload)
    cfg = common.config(w["config"])
    why = common.require_cards(w["chips"])
    if why:
        print(f"readings.py: {why}", file=sys.stderr)
        return 2
    common.apply_precision(cfg)
    traffic = common.load_module("traffic", w["traffic"])
    for seed in args.seeds:
        t0 = time.time()
        logs = []
        ctx = common.Context(cell=args.workload, workload=w, config=cfg, seed=seed,
                             seconds=args.seconds, control=args.control, log=logs.append)
        cell = traffic.Cell(ctx)
        with planted(args.fault) if args.fault else contextlib.nullcontext():
            cell.setup()
            e2e = cell.window(args.seconds)
        attempted, failed = cell.counts()
        cell.free()
        gc.collect()
        torch.cuda.empty_cache()
        numbers, checks = cell.check()
        print(json.dumps({"workload": args.workload, "control": args.control,
                          "fault": args.fault, "seed": seed,
                          "numbers": numbers, "ok": {c.name: c.ok for c in checks},
                          "e2e": e2e, "attempted": attempted, "failed": failed, "logs": logs,
                          "seconds": time.time() - t0}), flush=True)
        del cell, ctx
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
