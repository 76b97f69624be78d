#!/usr/bin/env python3
"""Run one cell of the benchmark of optispeech_tpu_torch once, on the card.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

From the root of a checkout. The cell's files are found by name
(`benchmark/workloads/CELL.json`, its configuration and traffic kind); the
metrics it reports are those `BENCHMARK.json` gives it: with `--trace 0`
the end-to-end ones over a window of S seconds, with `--trace 1` the
per-layer ones over a traced window. Either way the outputs of the window
are compared with the plain reference afterwards, and the last stdout line
is one JSON object: correct, attempted, failed, metrics, device
(+ breakdown when traced), then the compared numbers beside their limits,
which also end stderr. Without the cards the cell needs, the run fails and
prints no result.
"""

import argparse
import gc
import subprocess
import sys
import time

from harness import common


def card_line(chips: int) -> str:
    import torch

    line = f"device: {torch.cuda.get_device_name(0)} x{chips}"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        line += f", power limit {out.strip().splitlines()[0]}"
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return line


def measure(ctx, trace: bool, chips: int, started: float) -> str:
    """Set the cell up, run its window (traced or not), read its metrics,
    free the program's state and compare its outputs with the reference.
    Returns the result line; the compared numbers end stderr."""
    import torch

    sync = torch.cuda.synchronize if ctx.device != "cpu" else (lambda: None)
    e2e_defs, layer_defs = common.cell_metrics(ctx.cell)
    cell = common.load_module("traffic", ctx.workload["traffic"]).Cell(ctx)
    cell.setup()
    sync()
    # what set-up made stays alive through the window: keep the collector's
    # full passes from walking it again and again inside the window
    gc.collect()
    gc.freeze()
    setup_s = time.time() - started
    ctx.log(f"set-up done; window of {ctx.seconds} s, trace {int(trace)}")
    if trace:
        data = cell.traced(ctx.seconds)
    else:
        values = cell.window(ctx.seconds)
    sync()
    device = common.device_record(chips, ctx.device)
    attempted, failed = cell.counts()
    ctx.log("window closed")

    metrics = {}
    if trace:
        device["busy_s"], device["window_s"] = data.busy_s, data.window_s
        for m in layer_defs:
            value = common.load_module("metrics", m["name"]).read(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values["setup_s"] = setup_s
        for m in e2e_defs:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    cell.free()
    gc.collect()
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    numbers, checks = cell.check()
    ctx.log(f"compared: {numbers}")
    correct = bool(checks) and all(c.ok for c in checks)
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    return common.result_line(correct, attempted, failed, metrics, device, checks,
                              data.breakdown() if trace else None)


def main(argv=None) -> int:
    started = common.process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    common.checkout_env()
    w = common.workload(args.workload)
    cfg = common.config(w["config"])
    import torch  # after checkout_env: the cache directories and threads

    torch.set_num_threads(1)

    why = common.require_cards(w["chips"])
    if why:
        print(f"run.py: {why}; no result", file=sys.stderr)
        return 2
    common.apply_precision(cfg)
    print(card_line(w["chips"]), flush=True)

    log = lambda msg: print(f"[{time.time() - started:7.2f} s] {msg}", file=sys.stderr,  # noqa: E731
                            flush=True)
    seconds = min(args.seconds, w.get("trace_seconds", 3.0)) if args.trace else args.seconds
    ctx = common.Context(cell=args.workload, workload=w, config=cfg, seed=args.seed,
                         seconds=seconds, log=log)
    line = measure(ctx, bool(args.trace), w["chips"], started)
    loaded = common.forbidden_loaded()
    if loaded:
        print(f"run.py: forbidden modules loaded: {loaded}; no result", file=sys.stderr)
        return 3
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
