#!/usr/bin/env python3
"""What holds the training step's peak memory on the card, in a fresh process.

    python3 scripts/port_step_memory.py [--config ljspeech-48k] [--cudnn-benchmark]

Runs the GAN train step of configs/<config>.yaml at the flagship's widths
(chip_smoke.py phase 21's `named_config`: random weights, seed 0, D trained
from the first step, TF32 off) on chip_smoke.py's phase-7 batch (128 items,
192 tokens, 768 frames). For each of 4 steps it prints the wall ms and the peak
memory of the generator turn (forward and backward, up to G's update) and
of the discriminator turn. For the first step and the third it records the
allocator's trace and prints what is live at the G turn's peak: the bytes
by the first frames of the port and of torch.nn that allocated them, and
the largest blocks with their C++ frames that name cuDNN or a convolution
(a block with no Python frame was allocated on the autograd engine's
thread, in a backward). `--cudnn-benchmark` lets cuDNN time its algorithms
and pick the fastest (PyTorch's default picks by heuristics). Needs a card.
"""

import argparse
import collections
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import MAS_SHAPE, card_line, named_config, training_batch  # noqa: E402

STEPS = 4
TRACED = (0, 2)  # 0-based steps whose allocations are recorded
GIB = 2 ** 30
FRAME_DIRS = ("/optispeech_tpu_torch/", "torch/nn/", "torch/autograd/")
CPP_WORDS = ("cudnn", "conv", "Conv", "fft")


def where(frames):
    return " <- ".join(f"{f['filename'].split('/')[-1]}:{f['line']}:{f['name']}" for f in frames)


def live_at_peak(snapshot, base):
    """The blocks live when the traced allocations peaked, and that peak."""
    events = snapshot["device_traces"][0]
    live, total, peak, peak_i = {}, base, base, -1
    for i, e in enumerate(events):
        if e["action"] == "alloc":
            live[e["addr"]] = e
            total += e["size"]
        elif e["action"] == "free_requested" and e["addr"] in live:
            total -= live.pop(e["addr"])["size"]
        if total > peak:
            peak, peak_i = total, i
    live = {}
    for e in events[:peak_i + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] == "free_requested":
            live.pop(e["addr"], None)
    return list(live.values()), peak


def report(snapshot, base, label):
    blocks, peak = live_at_peak(snapshot, base)
    print(f"  step {label}: {base / GIB:.2f} GiB live before it, the traced peak "
          f"{peak / GIB:.2f} GiB; live then, by where it was allocated:")
    groups = collections.Counter()
    for b in blocks:
        ours = [f for f in b["frames"] if any(d in f["filename"] for d in FRAME_DIRS)]
        groups[where(ours[:3]) or "(no Python frame)"] += b["size"]
    for key, size in groups.most_common(8):
        print(f"    {size / GIB:7.2f} GiB  {key}")
    for b in sorted(blocks, key=lambda b: -b["size"])[:3]:
        py = [f for f in b["frames"] if f["filename"].endswith(".py")]
        cpp = [f for f in b["frames"] if any(w in f["name"] for w in CPP_WORDS)]
        print(f"    block {b['size'] / GIB:.2f} GiB: "
              f"{where(py[:3]) or '(no Python frame)'}; C++: "
              f"{' <- '.join(f['name'][:90] for f in cpp[:4]) or '(none named)'}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="ljspeech-48k")
    p.add_argument("--cudnn-benchmark", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_step_memory: no CUDA device is available", file=sys.stderr)
        return 2
    from optispeech_tpu_torch.training.state import init_train_state
    from optispeech_tpu_torch.training.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    print(f"{card_line()}; torch {torch.__version__}, cuDNN {torch.backends.cudnn.version()}; "
          f"{args.config}, cudnn.benchmark {args.cudnn_benchmark}", flush=True)
    cfg = named_config(args.config)
    state = init_train_state(cfg, "cuda", seed=0)
    batch = training_batch(cfg, cfg.data.batch_size, MAS_SHAPE[2], MAS_SHAPE[1], "cuda")
    step = make_train_step(cfg)
    turns = {}
    for turn, opt in (("G", state.g_opt), ("D", state.d_opt)):
        def peak_then_update(grads, update=opt.update, turn=turn):
            turns[turn] = torch.cuda.max_memory_allocated() / GIB
            torch.cuda.reset_peak_memory_stats()
            return update(grads)

        opt.update = peak_then_update
    for i in range(STEPS):
        torch.cuda.reset_peak_memory_stats()
        traced = i in TRACED
        if traced:
            base = torch.cuda.memory_allocated()
            torch.cuda.memory._record_memory_history(max_entries=1_000_000, stacks="all")
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if traced:
            snapshot = torch.cuda.memory._snapshot()
            torch.cuda.memory._record_memory_history(enabled=None)
        print(f"step {i}: {wall:.1f} ms{' (allocations recorded)' if traced else ''}; peak G turn "
              f"{turns['G']:.2f} GiB, D turn {turns['D']:.2f} GiB", flush=True)
        if traced:
            report(snapshot, base, i)
            del snapshot
    return 0


if __name__ == "__main__":
    sys.exit(main())
