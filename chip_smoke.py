#!/usr/bin/env python3
"""Drive the PyTorch port (optispeech_tpu_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py          # from the repo root, on a machine with a card

Phases, each of which fails the run on any error:
  1. card: name and power limit, torch and CUDA versions, TF32 off;
  2. build: nvcc builds the kernels from csrc/ into build/;
  3. kernel check: the fused ConvNeXt-block kernel against its plain twin at
     both model widths, T = 1792 / 1000 (ragged) / 5 (shorter than the halo),
     x in float32 and bfloat16; then its time beside its bound, the twin's
     time and the unfused PyTorch block's (`library_ms`, a yardstick only);
  4. main path at full width: the flagship ConvNeXt + WaveNeXt model (random
     weights, seed 0, en-g2p text front end, fused decoder and trunk) runs
     prepare_input -> synthesise on an English sentence, then
     synthesise_on_device at bench.py's shape (batch 32, 120 tokens,
     d_factor 8, 1792 frames); the kernel must launch 12 times per decode;
  5. cross-device: the same weights on the card and on the CPU (where the
     block runs its twin), batch 2 at 256 frames: equal durations, close wav.
Prints the kernels' JSON line and the card line, and as its last line
{"ok": true, "device": {...}}. Without a card, or without the repo beside
it, it exits non-zero and prints no result.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM, dense (NVIDIA data sheet): bf16 tensor-core peak and HBM rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

ATOL = 3e-3  # bf16 operands, f32 accumulation, other summation order
BF16_RTOL = 2 * 2.0 ** -7  # plus two roundings of a bf16 output
WAV_ATOL = 2e-3  # card (kernel) against CPU (twin), see phase 5
SENTENCE = ("The birch canoe slid on the smooth planks. "
            "Glue the sheet to the dark blue background.")
WIDTHS = {"decoder": (256, 1024), "trunk": (384, 1152)}
BENCH = dict(batch=32, n_tokens=120, d_factor=8.0, n_frames=1792)


def phase(name):
    print(f"\n== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters, repeats=5):
    """Median over `repeats` of the mean per-call device time of `iters`
    back-to-back calls, from CUDA events, after one warm-up call."""
    fn()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def block_inputs(gen, b, t, c, inter, dtype, device):
    mk = lambda *s, sc=0.1: (torch.randn(*s, generator=gen) * sc).to(device)  # noqa: E731
    x = mk(b, t, c, sc=0.5).to(dtype)
    params = [mk(7, c), mk(c), 1.0 + mk(c), mk(c), mk(c, inter, sc=0.05).bfloat16(),
              mk(inter, sc=0.02), mk(inter, c, sc=0.05).bfloat16(), mk(c, sc=0.02),
              torch.full((c,), 0.25, device=device)]
    return x, params


def library_block(x, dw_conv, lnw, lnb, w1_t, b1, w2_t, b2, gamma):
    """The unfused block as PyTorch's own operators compute it (cuDNN
    depthwise conv, layer_norm, two cuBLAS bf16 products, gelu)."""
    f = torch.nn.functional
    h = f.conv1d(x.transpose(1, 2), dw_conv[0], dw_conv[1], padding=3,
                 groups=x.shape[-1]).transpose(1, 2)
    h = f.layer_norm(h, (x.shape[-1],), lnw, lnb, eps=1e-6)
    h = f.gelu(f.linear(h.bfloat16(), w1_t, b1.bfloat16()), approximate="none")
    h = f.linear(h, w2_t, b2.bfloat16())
    return x + gamma * h.float()


def check_kernel(fc, device):
    gen = torch.Generator().manual_seed(0)
    worst = 0.0
    for width, (c, inter) in WIDTHS.items():
        for t in (1792, 1000, 5):
            for dtype in (torch.float32, torch.bfloat16):
                x, p = block_inputs(gen, 32, t, c, inter, dtype, device)
                got = fc.convnext_block_fused(x, *p)
                torch.cuda.synchronize()
                ref = fc.convnext_block_reference(x, *p)
                diff = (got.float() - ref.float()).abs()
                max_diff = float(diff.max())
                rel = max_diff / float(ref.float().abs().max())
                rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
                ok = bool((diff <= ATOL + rtol * ref.float().abs()).all())
                print(f"  {width:8s} C={c} I={inter} B=32 T={t:5d} {str(dtype):15s} "
                      f"max|diff| {max_diff:.3e}  max|diff|/max|ref| {rel:.3e}  "
                      f"(atol {ATOL}, rtol {rtol:.4f}) {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise AssertionError(f"kernel disagrees with its twin at {width} T={t} {dtype}")
                worst = max(worst, max_diff)
    return worst


def time_kernel(fc, device):
    """Kernel, twin and unfused-library times at the main path's shapes."""
    gen = torch.Generator().manual_seed(1)
    b, t = 32, BENCH["n_frames"]
    rows = {}
    for width, (c, inter) in WIDTHS.items():
        x, p = block_inputs(gen, b, t, c, inter, torch.float32, device)
        dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma = p
        lib_args = (x, (dw.t().contiguous()[:, None, :], dwb), lnw, lnb, w1.t().contiguous(),
                    b1, w2.t().contiguous(), b2, gamma)
        ms = time_ms(lambda: fc.convnext_block_fused(x, *p), iters=20)
        plain_ms = time_ms(lambda: fc.convnext_block_reference(x, *p), iters=3)
        library_ms = time_ms(lambda: library_block(*lib_args), iters=10)
        flops = 4 * b * t * c * inter
        nbytes = (2 * b * t * c * x.element_size()  # x read once, out written once
                  + sum(q.numel() * q.element_size() for q in p))
        bound_ops, bound_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
        rows[width] = {
            "shape": f"B={b} T={t} C={c} I={inter} float32",
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
            "flop": flops, "bytes": nbytes,
        }
        r = rows[width]
        print(f"  {width:8s} {r['shape']}: kernel {ms:.4f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; {flops:.3e} FLOP, {nbytes / 1e6:.1f} MB)  twin {plain_ms:.4f} ms  "
              f"library {library_ms:.4f} ms  -> {r['bound_ms'] / ms:.1%} of bound", flush=True)
    return rows


def flagship_config():
    import dataclasses

    from optispeech_tpu_torch.config import ExperimentConfig
    from optispeech_tpu_torch.models.optispeech import with_fused_blocks

    cfg = ExperimentConfig()
    tp = dataclasses.replace(cfg.data.text_processor, tokenizer="en-g2p")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, text_processor=tp))
    return with_fused_blocks(cfg)


def bench_inputs():
    from optispeech_tpu_torch.values import InferenceInputs

    rng = np.random.default_rng(0)
    n, b = BENCH["n_tokens"], BENCH["batch"]
    ids = [rng.integers(3, 150, n).astype(np.int64).tolist() for _ in range(b)]
    return InferenceInputs.from_ids_and_lengths(ids=ids, lengths=[n] * b, clean_text="bench",
                                                d_factor=BENCH["d_factor"], p_factor=1.0,
                                                e_factor=1.0)


def main_path(fc, api):
    """Returns the kernel's launch count over the main path's runs."""
    fc.convnext_block_fused.launches = 0
    inputs = api.prepare_input(SENTENCE)
    out = api.synthesise(inputs)
    decodes = 1
    launches = fc.convnext_block_fused.launches
    y_lengths = out.durations.sum(axis=1)
    print(f"  synthesise: {inputs.x.shape[0]} sentences, {int(inputs.x_lengths.sum())} tokens -> "
          f"wav {out.wav.shape}, {int(out.wav_lengths.sum()) / api.sample_rate:.3f} s of audio; "
          f"latency {out.latency:.2f} ms, rtf {out.rtf:.5f}; kernel launches {launches}", flush=True)
    assert np.isfinite(out.wav).all(), "synthesise produced non-finite samples"
    assert np.array_equal(out.wav_lengths, y_lengths * api.hop_length), "wav_lengths != y*hop"
    assert out.wav.shape[1] % api.hop_length == 0 and out.wav.shape[1] >= out.wav_lengths.max()
    assert launches == 12, f"expected 12 kernel launches per decode, got {launches}"

    inputs = bench_inputs()
    n_frames = BENCH["n_frames"]
    o = api.synthesise_on_device(inputs, n_frames, pcm16=True)  # warm-up
    torch.cuda.synchronize()
    decodes += 1
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        o = api.synthesise_on_device(inputs, n_frames, pcm16=True)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        decodes += 1
    launches = fc.convnext_block_fused.launches
    assert launches == 12 * decodes, f"expected {12 * decodes} launches, got {launches}"
    wav = o["wav"]
    assert wav.shape == (BENCH["batch"], n_frames * api.hop_length)
    assert bool(torch.isfinite(wav).all()) and o["wav_pcm16"].dtype == torch.int16
    audio_s = float(o["wav_lengths"].sum()) / api.sample_rate
    ms = statistics.median(walls)
    print(f"  synthesise_on_device at bench shape (batch {BENCH['batch']}, {BENCH['n_tokens']} "
          f"tokens, d_factor {BENCH['d_factor']}, {n_frames} frames): median {ms:.2f} ms over "
          f"{len(walls)} calls (min {min(walls):.2f}), {audio_s:.2f} s of audio, "
          f"{int(o['y_lengths'].sum())} frames -> {audio_s / (ms / 1e3):.1f}x real time "
          f"(observation, not a claim)", flush=True)
    return launches


def cross_device(api):
    from optispeech_tpu_torch.models.optispeech import OptiSpeech

    cpu_api = OptiSpeech(api.cfg, device="cpu",
                         state_dict={k: v.cpu() for k, v in api.generator.state_dict().items()})
    inputs = api.prepare_input(SENTENCE)
    assert inputs.x.shape[0] == 2
    gpu = api.synthesise_on_device(inputs, 256)
    cpu = cpu_api.synthesise_on_device(inputs, 256)
    dur_equal = torch.equal(gpu["durations"].cpu(), cpu["durations"])
    wav_diff = float((gpu["wav"].cpu() - cpu["wav"]).abs().max())
    print(f"  batch 2, 256 frames: durations equal {dur_equal}; wav max|card - cpu| "
          f"{wav_diff:.3e} (atol {WAV_ATOL}); |wav| max {float(cpu['wav'].abs().max()):.3f}",
          flush=True)
    assert dur_equal, "durations differ between card and CPU"
    assert wav_diff <= WAV_ATOL, f"wav differs between card and CPU by {wav_diff}"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from optispeech_tpu_torch.models.optispeech import OptiSpeech
    from optispeech_tpu_torch.ops import fused_convnext as fc

    t_start = time.perf_counter()
    device = torch.device("cuda")

    phase("1. card")
    card = card_line()
    print(f"  {card}")
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    # cuDNN would run f32 convolutions in TF32 by default; the port's numbers
    # are f32 outside the kernel's bf16 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("  torch.backends.cuda.matmul.allow_tf32 = False; torch.backends.cudnn.allow_tf32 = False")

    phase("2. build")
    info = fc.build_kernels()
    print(f"  {info['path']}: built in {info['seconds']:.1f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"    {line.strip()}")

    phase("3. kernel check (kernel against twin on the card)")
    max_abs_err = check_kernel(fc, device)
    rows = time_kernel(fc, device)

    phase("4. main path at full width")
    api = OptiSpeech(flagship_config(), seed=0, device="cuda")
    n_params = sum(p.numel() for p in api.generator.parameters())
    print(f"  OptiSpeech(ExperimentConfig(), en-g2p, fused decoder + trunk), seed 0: "
          f"{n_params} parameters", flush=True)
    launches = main_path(fc, api)

    phase("5. cross-device (card kernel against CPU twin)")
    cross_device(api)

    trunk = rows["trunk"]
    kernel = {
        "name": "convnext_block_fused", "route": "cuda",
        "source": "optispeech_tpu_torch/csrc/convnext_block.cu",
        "replaces": "optispeech_tpu/ops/pallas_convnext.py:224",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": trunk["ms"], "plain_ms": trunk["plain_ms"], "bound_ms": trunk["bound_ms"],
        "bound_by": trunk["bound_by"], "library_ms": trunk["library_ms"],
        "shape": trunk["shape"],
        "other_shapes": [rows["decoder"]],
    }
    print(f"\n  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [kernel]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
