#!/usr/bin/env python3
"""Where the PyTorch port's synthesis time goes on the card.

    python3 scripts/port_profile.py [--bf16]

Builds the flagship model as chip_smoke.py does (random weights, seed 0,
fused decoder and trunk), runs `synthesise_on_device` at bench.py's shape
under torch.profiler, and prints device time per kernel, the share of the
fused ConvNeXt kernel, the device-busy share of the wall time, and the same
call timed with the fused blocks off (cuBLAS/cuDNN unfused blocks) for
comparison. `--bf16` runs the model with bf16 activations
(`compute_dtype=torch.bfloat16`). Needs a card.
"""

import argparse
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import BENCH, bench_inputs, card_line, flagship_config  # noqa: E402

CALLS = 3  # calls per timed or profiled window


def wall_ms(api, inputs):
    """Median synchronised wall time of CALLS calls, after one warm-up."""
    api.synthesise_on_device(inputs, BENCH["n_frames"])
    torch.cuda.synchronize()
    walls = []
    for _ in range(CALLS):
        t0 = time.perf_counter()
        api.synthesise_on_device(inputs, BENCH["n_frames"])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bf16", action="store_true", help="bf16 activations")
    dtype = torch.bfloat16 if p.parse_args(argv).bf16 else torch.float32
    if not torch.cuda.is_available():
        print("port_profile: no CUDA device is available", file=sys.stderr)
        return 2
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from optispeech_tpu_torch.models.optispeech import OptiSpeech

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), f"; activations {dtype}")
    cfg = flagship_config()
    api = OptiSpeech(cfg, seed=0, device="cuda", compute_dtype=dtype)
    inputs = bench_inputs()
    n = BENCH["n_frames"]
    fused_ms = wall_ms(api, inputs)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(CALLS):
            api.synthesise_on_device(inputs, n)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        print("the profiler recorded no device time: device shares not measured")
        return 1
    device_ms = sum(e.device_time_total for e in events) / 1e3
    print(f"\nbatch {BENCH['batch']}, {n} frames, {CALLS} calls profiled: "
          f"wall {window_ms:.2f} ms, device kernels {device_ms:.2f} ms "
          f"({device_ms / window_ms:.1%} busy)")
    print(f"{'kernel':70s} {'calls':>6s} {'ms/call':>9s} {'share':>7s}")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:15]:
        ms = e.device_time_total / 1e3
        print(f"{e.key[:70]:70s} {e.count // CALLS:6d} {ms / CALLS:9.3f} "
              f"{ms / device_ms:7.1%}")

    g = cfg.generator
    unfused_cfg = dataclasses.replace(cfg, generator=dataclasses.replace(
        g, decoder=dataclasses.replace(g.decoder, fused_pallas=False),
        vocoder=dataclasses.replace(g.vocoder, fused_pallas=False)))
    # the blocks through cuDNN and cuBLAS (TF32 off), same weights
    unfused = OptiSpeech(unfused_cfg, device="cuda", state_dict=api.generator.state_dict(),
                         compute_dtype=dtype)
    unfused_ms = wall_ms(unfused, inputs)
    again_ms = wall_ms(api, inputs)
    print(f"\nsynthesise_on_device wall, median of {CALLS}: fused {fused_ms:.2f} ms, "
          f"unfused {unfused_ms:.2f} ms, fused again {again_ms:.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
