#!/usr/bin/env python3
"""Where the PyTorch port's training step spends time and memory on the card.

    python3 scripts/port_train_profile.py [--bf16]

Runs the GAN train step of the flagship config (random weights, seed 0,
pretraining_steps=0 so that D trains) on chip_smoke.py's phase-7 batch
(128 items, 192 tokens, 768 frames, host-sampled segments): the median wall
time of 3 steps after a warm-up, the peak memory of the generator turn and
of the discriminator turn, then one step under torch.profiler with device
time per kernel and the device-busy share of the wall.

Then the loop around the step: `Trainer.fit` over chip_smoke.py phase 10's
synthetic corpus for 4 steps with the 4th traced (`profile_steps`; the
first three each meet a new batch shape or an epoch's first batch): the
host spans `trainer/segment` and `trainer/to_device`, the traced window's
wall and the device's busy share of it, and the collation of one batch,
which the loader runs on its prefetch thread. `--bf16` runs both with the
generator in bf16 (`train_args.compute_dtype: bfloat16`). Needs a card.
"""

import argparse
import dataclasses
import json
import shutil
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    MAS_SHAPE,
    card_line,
    trainer_loaders,
    training_batch,
    training_config,
)

STEPS = 3
TRACED = (3, 3)  # 0-based steps of `fit` under the profiler


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bf16", action="store_true", help="the generator in bf16")
    dtype = "bfloat16" if p.parse_args(argv).bf16 else "float32"
    if not torch.cuda.is_available():
        print("port_train_profile: no CUDA device is available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from optispeech_tpu_torch.training.state import init_train_state
    from optispeech_tpu_torch.training.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), f"; G in {dtype}")
    cfg = training_config(compute_dtype=dtype)
    state = init_train_state(cfg, "cuda", seed=0)
    b, t_feats, t_text = cfg.data.batch_size, MAS_SHAPE[1], MAS_SHAPE[2]
    batch = training_batch(cfg, b, t_text, t_feats, "cuda")
    step = make_train_step(cfg)

    # peak memory per turn: the G turn ends where its optimiser update starts
    peaks = {}
    g_update = state.g_opt.update

    def mark_g_turn(grads):
        torch.cuda.synchronize()
        peaks["generator turn"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return g_update(grads)

    state.g_opt.update = mark_g_turn
    step(state, batch)  # warm-up
    walls = []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        peaks["optimiser + discriminator turn"] = torch.cuda.max_memory_allocated()
    state.g_opt.update = g_update
    print(f"\nbatch {b}, {t_text} tokens, {t_feats} frames: step wall median {statistics.median(walls):.1f} ms "
          f"over {STEPS} ({', '.join(f'{w:.1f}' for w in walls)})")
    for name, peak in peaks.items():
        print(f"  peak memory, {name}: {peak / 2 ** 30:.2f} GiB")
    print(f"  weights: G + D {sum(p.numel() for m in (state.generator, state.discriminator) for p in m.parameters()) * 4 / 2 ** 20:.1f} MiB")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        print("the profiler recorded no device time: device shares not measured")
        return 1
    device_ms = sum(e.device_time_total for e in events) / 1e3
    print(f"\none profiled step: wall {window_ms:.1f} ms, device kernels {device_ms:.1f} ms "
          f"({device_ms / window_ms:.1%} busy), {sum(e.count for e in events)} kernel launches")
    print(f"{'kernel':80s} {'calls':>6s} {'ms':>9s} {'share':>7s}")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:20]:
        ms = e.device_time_total / 1e3
        print(f"{e.key[:80]:80s} {e.count:6d} {ms:9.3f} {ms / device_ms:7.1%}")
    del state, batch
    torch.cuda.empty_cache()
    return trainer_loop(dtype)


def busy_ms(intervals):
    """The length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def trainer_loop(dtype) -> int:
    from optispeech_tpu_torch.training.trainer import Trainer

    cfg = training_config(compute_dtype=dtype)
    cfg = dataclasses.replace(cfg, log_every_n_steps=1, val_every_n_steps=10 ** 9,
                              ckpt_every_n_steps=10 ** 9)
    train, _ = trainer_loaders(cfg)
    items = [train.dataset[i] for i in range(cfg.data.batch_size)]
    t0 = time.perf_counter()
    train.collate(items)
    collate_ms = (time.perf_counter() - t0) * 1e3
    out_dir = ROOT / "runs" / "port_train_profile"
    shutil.rmtree(out_dir, ignore_errors=True)
    trainer = Trainer(cfg, out_dir=str(out_dir), device="cuda")
    trainer.fit(train, None, max_steps=4, profile_steps=TRACED)
    events = [e for e in json.loads((out_dir / "profile" / "trace.json").read_text())["traceEvents"]
              if e.get("ph") == "X"]
    spans = {name: [e["dur"] / 1e3 for e in events if e["name"] == name
                    and e.get("cat") == "user_annotation"]
             for name in ("trainer/segment", "trainer/to_device")}
    kernels = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "kernel"]
    if not kernels or not all(spans.values()):
        print("the trace holds no kernels or no trainer spans: the loop's breakdown not measured")
        return 1
    start = min(e["ts"] for e in events if e["name"] == "trainer/segment")
    end = max(e["ts"] + e["dur"] for e in events)
    window_ms = (end - start) / 1e3
    device_ms = busy_ms(kernels) / 1e3
    rows = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
    fit_ms = [1e3 / r["perf/steps_per_sec"] for r in rows if "perf/steps_per_sec" in r]
    n = TRACED[1] - TRACED[0] + 1
    print(f"\nTrainer.fit, batch {cfg.data.batch_size} over chip_smoke.py phase 10's corpus, "
          f"step(s) {TRACED[0] + 1}-{TRACED[1] + 1} of 4 traced")
    print(f"  fit step (perf/steps_per_sec), steps 1-4: {', '.join(f'{x:.1f}' for x in fit_ms)} ms "
          f"(step {TRACED[0] + 1}-{TRACED[1] + 1} under the profiler, with its trace's export)")
    for name, ms in spans.items():
        print(f"  {name}: {', '.join(f'{x:.2f}' for x in ms)} ms per step")
    print(f"  traced window: wall {window_ms:.1f} ms for {n} steps, device kernels {device_ms:.1f} ms "
          f"({device_ms / window_ms:.1%} busy, {1 - device_ms / window_ms:.1%} idle)")
    print(f"  collate of one batch of {cfg.data.batch_size} (the loader's thread): "
          f"{collate_ms:.1f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
