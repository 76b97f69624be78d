#!/usr/bin/env python3
"""Find the serving cell's knee: the highest offered rate at which, over a
window, the batcher keeps up (at least 98% of the requests answered, none
refused at the Batcher's default backlog limit). Builds the cell once and
runs a window at each rate, lowest first.

    python3 benchmark/tools/knee.py --workload CELL --seed N --seconds S \\
        --rates R1 R2 ...

One JSON line per rate. Needs a card.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from harness import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--max-pending", type=int, default=256,
                    help="the Batcher's backlog limit (its default): past it, requests are refused")
    args = ap.parse_args(argv)
    common.checkout_env()
    w = common.workload(args.workload)
    w["params"]["max_pending"] = args.max_pending
    cfg = common.config(w["config"])
    why = common.require_cards(w["chips"])
    if why:
        print(f"knee.py: {why}", file=sys.stderr)
        return 2
    common.apply_precision(cfg)
    logs = []
    ctx = common.Context(cell=args.workload, workload=w, config=cfg, seed=args.seed,
                         seconds=args.seconds, log=logs.append)
    cell = common.load_module("traffic", w["traffic"]).Cell(ctx)
    cell.setup()
    print(json.dumps({"setup": logs}), flush=True)
    for rate in sorted(args.rates):
        logs.clear()
        e2e = cell.window(args.seconds, rate)
        c = cell.counters
        e2e.update(rate=rate, rows_per_batch=c["rows"] / max(c["batches"], 1),
                   synth_ms=1e3 * c["synthesise_s"] / max(c["batches"], 1), logs=list(logs),
                   keeps_up=e2e["completed_share"] >= 0.98 and e2e["rejected"] == 0)
        print(json.dumps(e2e), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
