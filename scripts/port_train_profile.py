#!/usr/bin/env python3
"""Where the PyTorch port's training step spends time and memory on the card.

    python3 scripts/port_train_profile.py

Runs the GAN train step of the flagship config (random weights, seed 0,
pretraining_steps=0 so that D trains) on chip_smoke.py's phase-7 batch
(128 items, 192 tokens, 768 frames, host-sampled segments): the median wall
time of 3 steps after a warm-up, the peak memory of the generator turn and
of the discriminator turn, then one step under torch.profiler with device
time per kernel and the device-busy share of the wall. Needs a card.
"""

import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import MAS_SHAPE, card_line, training_batch, training_config  # noqa: E402

STEPS = 3


def main() -> int:
    if not torch.cuda.is_available():
        print("port_train_profile: no CUDA device is available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from optispeech_tpu_torch.training.state import init_train_state
    from optispeech_tpu_torch.training.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    cfg = training_config()
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
