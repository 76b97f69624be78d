#!/usr/bin/env python3
"""Drive the PyTorch port (optispeech_tpu_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py          # from the repo root, on a machine with a card

Phases, each of which fails the run on any error:
  1. card: name and power limit, torch and CUDA versions, TF32 off;
  2. build: nvcc builds the kernels from csrc/ (and the MAS chain probe,
     scripts/mas_chain.cu) into build/, each build's own seconds; for each
     instantiation of the two fused ConvNeXt-block kernels (B1 and B2), its
     registers, spills, shared memory, weight slots and whether ptxas
     serialized its wgmma (ptxas's log and the kernel's own layout), the
     same for each kernel of B1's wide path, and ptxas's registers and
     spills for the other kernels;
  3. kernel check: the fused ConvNeXt-block kernel against its plain twin at
     both model widths and at C = 128 / I = 512, B = 32, T = 1792 / 1000
     (ragged) / 65 (one frame past a tile) / 5 (shorter than the halo) / 1, x
     in float32 and bfloat16, and at the other widths it takes (C = 64, 192,
     320, 448, 512, C = 512 with I = 3072, and C = 96, 97 and 500, which it
     pads to a multiple of 64) at T = 1792 / 65 / 1, and B1's wide path
     (C > 512) at C = 576 / I = 1152 and 768 / 3072 (T = 1792 / 65 / 1) and
     at the widest block JAX's rule tiles at T = 64, I = 64 (C = 12272);
     then its time (on weights packed once, and through the wrapper that
     packs them on every call) beside its bound, the twin's time and the
     unfused PyTorch block's (`library_ms`, a yardstick only), x in float32
     at both widths and in bfloat16 at the trunk, x in float32 and bfloat16
     at C = 448 and 512, and x in float32 at the three wide-path widths,
     there with each of its kernels' device time (torch.profiler); and the
     wide path launched at the model widths and at C = 448 and 512 (x
     float32), timed beside the narrow kernel on the same inputs (recorded
     only: the wrapper takes it above C = 512 alone);
  4. main path at full width: the flagship ConvNeXt + WaveNeXt model (random
     weights, seed 0, en-g2p text front end, fused decoder and trunk) runs
     prepare_input -> synthesise on an English sentence, then
     synthesise_on_device at bench.py's shape (batch 32, 120 tokens,
     d_factor 8, 1792 frames); the kernel must launch 12 times per decode.
     Then the same model at `generator.dim: 192` (decoder 192/1024) runs
     synthesise_on_device on the card and on the CPU (the twin), batch 2 at
     256 frames: equal durations, wav within WAV_ATOL, and how many of its
     blocks took the kernel by the shape rule (`kernel_takes`); then the
     same at `generator.dim: 576` (2 blocks a stack, decoder 576/1024),
     which must fuse every block, its decoder's on the wide path;
  5. cross-device: the same weights on the card and on the CPU (where the
     block runs its twin), batch 2 at 256 frames: equal durations, close wav;
  6. MAS kernel check: the wavefront MAS kernel against its plain twin at
     B=128, T_feats=768, T_text=192 (lengths from a seed), (2, 43, 23) and a
     one-token item: durations exactly equal, bin loss and its gradient
     close; then its time (launched on inputs made once; through the
     wrapper with its bin loss; at (2, 43, 23)) beside its bound, its chain
     floor (the longest item's frames x the cycles of the forward's and the
     backtrace's dependent steps, timed by scripts/mas_chain.cu, at the
     card's maximum SM clock) and the twin's;
  7. training at full width: the flagship config's GAN train step (random
     weights, seed 0, D from the start) on a batch of 128 at 192 tokens and
     768 frames with host-sampled segments; 1 warm-up and 3 timed steps; the
     MAS kernel must launch once per step and the fused block never;
  8. training cross-device: one step with no dropout on the card and on the
     CPU (the MAS twin), batch 4 at 32 tokens and 128 frames: equal
     durations, every log close;
  9. extraction MAS kernel check: the validation step's MAS kernel against
     its plain twin at phase 6's timing shape and lengths, (2, 43, 12),
     (3, 40, 10) and a one-token item: durations exactly equal and equal to
     the wavefront kernel's, the per-token bin-loss sums and the bin loss
     close; then its time (as phase 6's, at (2, 43, 12)) beside its bound,
     its chain floor and the twin's;
 10. the trainer at full width: `cli/train.py::run` on the flagship config
     (pretraining_steps=0, batch 128, periodicity metrics) over synthetic
     utterances of 96-192 tokens and 384-768 frames, 4 steps with one
     validation and one checkpoint, then a fresh trainer that restores step
     4 and takes one more step, in a temporary directory outside the
     checkout that is deleted after; the MAS kernels must launch once per
     step and once per val batch. The times come from the run's own log
     (`perf/steps_per_sec`, `perf/val_*`) and from saving and restoring the
     trained state once more through the checkpoint manager;
 11. validation cross-device: the validation step with no dropout on the
     card and on the CPU (the twins), batch 4: equal durations, every log
     close;
 12. int8 kernel check: the int8 fused ConvNeXt-block kernel against its
     plain twin at both model widths, B = 32, T = 1792 / 1000 / 5, and B = 1,
     T = 1 / 63 / 65 / 129, x in float32 and bfloat16: bit-equal in every
     case (and so within the frame criterion: at least 99% of frames within
     atol = rtol = 1e-5, plus 2 * 2**-7 relative for a bfloat16 output, every
     element within 1e-2 of max|twin|); then its time (x bfloat16, the A/B's
     type; on a pack made once, through the wrapper on that pack, and
     through the wrapper packing per call) beside its bound (int8
     operations), the twin's time, the unfused int8 block with
     `torch._int_mm` products (`library_ms`, a yardstick only) and the time
     of B2's previous (mma.sync) design as PERF.md records it (printed
     only: it is not measured here, so the kernels line leaves it out);
 13. the int8 A/B at its default shape: `cli/int8_ab.py::main` at batch 32,
     T 1792, every arm (8-block trunks at 384/1152); the int8 kernel must
     launch 8 times per int8 trunk call and the bf16 kernel 8 times per
     fused-bf16 call, and each fused arm packs its weights once. With x in
     bfloat16 every arm's error against the f32
     oracle is set by the bfloat16 residual stream (the updates a block adds
     below half a bfloat16 step are lost), so the int8 trunk is also run
     with x in float32 and held under 0.02 of max|oracle| there;
 14. the user's workflow without JAX, in a temporary directory outside the
     checkout that is deleted after: the port's synthcorpus writes 48
     utterances (seed 0, en-g2p), `cli/preprocess.py` turns them into
     datafiles at the flagship config (en-g2p, ensemble pitch, 4 spawned
     workers, val fraction 0.125) and `cli/stats.py` computes the
     statistics, each step's seconds printed; `cli/train.py::main` trains 2
     steps on them on the card (flagship widths, batch 8, the statistics as
     `data.statistics.*` overrides, the speaker count from
     `speaker_ids.json`), the MAS kernel launching once per step and the
     extraction kernel once per val batch; `cli/infer.py --fused` runs the
     trained `inference_ckpt/` on the card for SENTENCE (B1 launching 12
     times per synthesise; each wav read back finite and frames x hop
     samples long); then phase 4's weights, saved with
     `OptiSpeech.save_checkpoint`, go through `cli/infer.py --fused` on the
     card and with `--device cpu` (B1's twin): equal durations, wav files
     within WAV_ATOL;
 15. the bf16 compute path, on phase 4's weights (seed 0): (a) the flagship
     fused in bf16 runs prepare_input -> synthesise on SENTENCE (B1
     launching 12 times per decode, each time on bf16 x) and
     synthesise_on_device at bench shape (median of 5 beside phase 4's
     f32 figure), B1 held against its twin on the bf16 x that the model
     gives its first decoder and first trunk block there, and its wav and
     the unfused bf16 model's against the f32 model's (max|d|/max|ref| and
     correlation, each decoding the f32 model's encoder outputs); (b) the
     bf16 model on the card against the CPU, batch 2 at 256 frames:
     durations equal, or one frame apart where one bf16 step moves the
     ceiling (each such token printed with its value), the wav within
     BF16_WAV_RTOL; (c) phase 7's training with G in bf16 (1 warm-up and 3
     timed steps, peak memory, B3 once per step), a bf16 step card against
     CPU at phase 8's size and a bf16 validation at phase 11's (B4 once),
     every log within BF16_STEP_LOG_RTOL; (d) `cli/infer.py --fused` and
     `--bf16 --fused` once each in a fresh process (build/ populated): wall
     time, latency, B1 launches, and the bf16 wav files against
     `--device cpu`; (e) phase 7's f32 step from the same state with TF32
     on and off, set by this script only: the logs' gaps and the time (an
     observation: the port keeps TF32 off).
The kernels build in parallel (one nvcc per source, five sources and the probe).
Prints the kernels' JSON line and the card line, and as its last line
{"ok": true, "device": {...}}. Without a card, or without the repo beside
it, it exits non-zero and prints no result.
"""

import gc
import json
import re
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
PEAK_F32_FLOPS = 67e12  # non-tensor float32 (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12  # int8 tensor-core dense (NVIDIA data sheet)
# int8 kernel against its twin: tests/test_pallas_convnext.py:69's 1e-5 on
# at least 99% of frames; a frame whose int8 code falls on the other side of
# a rounding boundary moves as a whole, by far less than 1e-2 of max|twin|
INT8_TOL, INT8_FRAME_SHARE, INT8_ELEM_REL = 1e-5, 0.99, 1e-2
INT8_AB_ERR = 0.02  # int8 block against the f32 block, tests/test_pallas_convnext.py:74
MAS_SHAPE = (128, 768, 192)  # (B, T_feats, T_text): the phase-7 training batch
MAS_BIN_RTOL, MAS_GRAD_ATOL = 1e-5, 1e-6  # tests/test_pallas_mas.py:49-54
STEP_LOG_RTOL = 1e-3  # card against CPU, float32 with TF32 off, see phase 8
# phase 10: the synthetic corpus, cut to give phase 7's 192-token, 768-frame buckets
TRAIN_ITEMS, VAL_ITEMS = 256, 128
TEXT_RANGE, MEL_RANGE = (96, 193), (384, 769)
SENTENCE = ("The birch canoe slid on the smooth planks. "
            "Glue the sheet to the dark blue background.")
WIDTHS = {"decoder": (256, 1024), "trunk": (384, 1152)}
CHECK_WIDTHS = {**WIDTHS, "narrow": (128, 512)}  # phase 3 also checks C = 128
# phase 3: the other widths B1 takes (C = 192 with the decoder's I, as in
# phase 4's model; else I = 4C), at T = 1792 / 65 / 1; then widths that are
# no multiple of 64, which B1 pads to the next (C' = 128, 128, 512): C = 96,
# C = 97 with an odd I (rows that are not 16-byte aligned) and C = 500
NEW_WIDTHS = {"c64": (64, 256), "c192": (192, 1024), "c320": (320, 1280), "c448": (448, 1792),
              "c512": (512, 2048), "c96": (96, 384), "c97": (97, 291), "c500": (500, 1000),
              "c512_i3072": (512, 3072)}  # the longest second product the rule fuses at C = 512
# phase 3: widths above 512, which B1's wide path (csrc/convnext_block_wide.cu)
# takes, at T = 1792 / 65 / 1, and the small-I extreme, the widest block that
# JAX's rule tiles at T = 64 with I = 64 (C = 12272), at T = 64
WIDE_WIDTHS = {"c576": (576, 1152), "c768": (768, 3072)}
WIDEST_I64 = (12272, 64)
# phase 3 times these beside the model widths: the two widest of the narrow
# kernel, whose prologue takes two frames at a time, and the wide path's;
# at the model widths and these two it also times the wide path launched
# on the same inputs (recorded only: above MAX_CHANNELS alone it runs)
TIMED_WIDTHS = {"c448": NEW_WIDTHS["c448"], "c512": NEW_WIDTHS["c512"]}
DIM_WIDE = 576  # phase 4: a model at this generator.dim, its decoder at 576/1024
# B2's times in its previous (mma.sync) design, same card type (PERF.md, kernel
# table): printed beside this run's times, and kept out of the kernels line
PREVIOUS_INT8_MS = {"trunk": 1.5017, "decoder": 1.1428}
BENCH = dict(batch=32, n_tokens=120, d_factor=8.0, n_frames=1792)
# phase 14: the user's workflow on a synthcorpus sample, at the flagship config
# (`configs/default.yaml`) with the en-g2p front end and its ensemble pitch
WORKFLOW_UTTERANCES, WORKFLOW_VAL_FRACTION = 48, 0.125
WORKFLOW_BATCH, WORKFLOW_STEPS = 8, 2
WORKFLOW_CONFIG = ["data.text_processor.tokenizer=en-g2p"]
# phase 15: the bf16 compute path. Card against CPU: the wav within this share
# of max|wav| (tests/test_torch_bf16.py's WAV_RTOL, port against JAX on the
# CPU), on the items whose durations are equal; a duration may differ only
# where one bf16 step moves its ceiling. Every log of a bf16 step within
# BF16_STEP_LOG_RTOL (tests/test_torch_bf16_train.py: at most 1.2e-2).
BF16_WAV_RTOL = 3e-2
BF16_STEP_LOG_RTOL = 2e-2


T0 = [0.0]  # the script's start on the host clock, set by main


def phase(name):
    print(f"\n== {name}  (at {time.perf_counter() - T0[0]:.1f} s)", flush=True)


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


def kernel_split_ms(fn, calls=10) -> dict:
    """Device ms per call of each kernel that `fn` launches, by the kernel's
    name and template arguments (its parameters dropped), from
    torch.profiler over `calls` calls after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.device_time_total <= 0:
            continue
        name = e.key.removeprefix("void ").replace("(anonymous namespace)::", "").split("(")[0]
        split[name] = split.get(name, 0.0) + e.device_time_total / calls / 1e3
    if not split:
        raise AssertionError("the profiler recorded no device time")
    return split


def block_inputs(gen, b, t, c, inter, dtype, device, weight_dtype=torch.bfloat16):
    """x and the block's parameters, drawn from `gen` on its own device."""
    mk = lambda *s, sc=0.1: (  # noqa: E731
        torch.randn(*s, generator=gen, device=gen.device) * sc).to(device)
    x = mk(b, t, c, sc=0.5).to(dtype)
    params = [mk(7, c), mk(c), 1.0 + mk(c), mk(c), mk(c, inter, sc=0.05).to(weight_dtype),
              mk(inter, sc=0.02), mk(inter, c, sc=0.05).to(weight_dtype), mk(c, sc=0.02),
              torch.full((c,), 0.25, device=device)]
    return x, params


def library_block(x, dw_conv, lnw, lnb, w1_t, b1, w2_t, b2, gamma):
    """The unfused block as PyTorch's own operators compute it (cuDNN
    depthwise conv in x's dtype, layer_norm in float32, two cuBLAS bf16
    products, gelu), the residual in x's dtype."""
    f = torch.nn.functional
    h = f.conv1d(x.transpose(1, 2), dw_conv[0].to(x.dtype), dw_conv[1].to(x.dtype), padding=3,
                 groups=x.shape[-1]).transpose(1, 2)
    h = f.layer_norm(h.float(), (x.shape[-1],), lnw, lnb, eps=1e-6)
    h = f.gelu(f.linear(h.bfloat16(), w1_t, b1.bfloat16()), approximate="none")
    h = f.linear(h, w2_t, b2.bfloat16())
    return (x.float() + gamma * h.float()).to(x.dtype)


def check_kernel(fc, device):
    assert fc.kernel_takes(64, *WIDEST_I64) and not fc.kernel_takes(64, WIDEST_I64[0] + 1, 64)
    gen = torch.Generator().manual_seed(0)
    worst = {"narrow": 0.0, "wide": 0.0}  # largest |kernel - twin| by path
    cases = [(w, ci, (1792, 1000, 65, 5, 1)) for w, ci in CHECK_WIDTHS.items()]
    cases += [(w, ci, (1792, 65, 1)) for w, ci in {**NEW_WIDTHS, **WIDE_WIDTHS}.items()]
    cases.append(("c12272", WIDEST_I64, (64,)))
    for width, (c, inter), ts in cases:
        for t in ts:
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
                path = "wide" if c > fc.MAX_CHANNELS else "narrow"
                worst[path] = max(worst[path], max_diff)
    return worst


def time_kernel(fc, device):
    """Kernel, wrapper, twin and unfused-library times at the main path's
    shapes: x float32 at both widths, and the trunk with x bfloat16 (the
    A/B's fused_bf16 arm); then the narrow kernel's two widest and the wide
    path's three widths (B = 32, T = 1792, or T = 64 at C = 12272)."""
    gen = torch.Generator().manual_seed(1)
    b = 32
    rows = {}
    cases = [(w, ci, torch.float32) for w, ci in WIDTHS.items()]
    cases.append(("trunk_bf16", WIDTHS["trunk"], torch.bfloat16))
    cases += [(f"{w}{suffix}", ci, dtype) for w, ci in TIMED_WIDTHS.items()
              for suffix, dtype in (("", torch.float32), ("_bf16", torch.bfloat16))]
    cases += [(w, ci, torch.float32) for w, ci in WIDE_WIDTHS.items()]
    cases.append(("c12272", WIDEST_I64, torch.float32))
    for width, (c, inter), dtype in cases:
        t = 64 if width == "c12272" else BENCH["n_frames"]
        x, p = block_inputs(gen, b, t, c, inter, dtype, device)
        dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma = p
        packed = fc.kernel_weights(w1, w2)
        lib_args = (x, (dw.t().contiguous()[:, None, :], dwb), lnw, lnb, w1.t().contiguous(),
                    b1, w2.t().contiguous(), b2, gamma)
        launch = lambda: fc.convnext_block_launch(x, dw, dwb, lnw, lnb, packed, b1, b2, gamma)  # noqa: E731
        ms = time_ms(launch, iters=20)
        wrapper_ms = time_ms(lambda: fc.convnext_block_fused(x, *p), iters=20)
        plain_ms = time_ms(lambda: fc.convnext_block_reference(x, *p), iters=3)
        library_ms = time_ms(lambda: library_block(*lib_args), iters=10)
        flops = 4 * b * t * c * inter
        nbytes = (2 * b * t * c * x.element_size()  # x read once, out written once
                  + sum(q.numel() * q.element_size() for q in p))
        bound_ops, bound_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
        rows[width] = {
            "shape": f"B={b} T={t} C={c} I={inter} {str(dtype).removeprefix('torch.')}",
            "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
            "flop": flops, "bytes": nbytes,
        }
        r = rows[width]
        r["path"] = "wide" if c > fc.MAX_CHANNELS else "narrow"
        print(f"  {width:10s} {r['shape']} ({r['path']}): kernel {ms:.4f} ms (wrapper, weights packed on each "
              f"call, {wrapper_ms:.4f} ms)  bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
              f"{flops:.3e} FLOP, {nbytes / 1e6:.1f} MB)  twin {plain_ms:.4f} ms  library "
              f"{library_ms:.4f} ms  -> {r['bound_ms'] / ms:.1%} of bound", flush=True)
        if r["path"] == "narrow" and dtype == torch.float32:  # the wide path at this width
            wide = lambda: fc.convnext_block_wide_launch(x, dw, dwb, lnw, lnb, packed, b1, b2, gamma)  # noqa: E731
            got, ref = wide(), launch()
            r["wide_max_abs_diff_to_narrow"] = float((got - ref).abs().max())
            r["wide_ms"] = time_ms(wide, iters=20)
            r["wide_kernels_ms"] = wide_split(kernel_split_ms(wide))
            print(f"  {'':10s} the wide path at this width: {r['wide_ms']:.4f} ms "
                  f"({split_text(r['wide_kernels_ms'])}), max|wide - narrow| "
                  f"{r['wide_max_abs_diff_to_narrow']:.3e}", flush=True)
        elif r["path"] == "wide":
            r["kernels_ms"] = wide_split(kernel_split_ms(launch))
            print(f"  {'':10s} by kernel: {split_text(r['kernels_ms'])}", flush=True)
    return rows


# B1's wide path: its kernels (csrc/convnext_block_wide.cu) by what they compute
WIDE_KERNELS = {"wide_layernorm_kernel": "layernorm", "wide_gemm_kernel<0,": "product1",
                "wide_gemm_kernel<1,": "product1_split", "wide_split_gelu_kernel": "split_sum_gelu",
                "wide_gemm_kernel<2,": "product2"}


def wide_split(split: dict) -> dict:
    """`kernel_split_ms` of the wide path, keyed by WIDE_KERNELS' names."""
    return {next((v for k, v in WIDE_KERNELS.items() if name.startswith(k)), name): ms
            for name, ms in split.items()}


def split_text(split: dict) -> str:
    return ", ".join(f"{name} {ms:.4f} ms" for name, ms in split.items())


def ptxas_summary(log: str) -> list:
    """Registers, spill bytes and static shared memory of each kernel that
    ptxas's log (`-Xptxas -v`) names, in the log's order."""
    found, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            found.append({"function": name})
        elif name and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            found[-1]["spill_store_bytes"], found[-1]["spill_load_bytes"] = nums[1], nums[2]
        elif name and "Used" in line and "registers" in line:
            words = line.replace(",", " ").split()
            found[-1]["registers"] = int(words[words.index("registers") - 1])
            found[-1]["static_smem_bytes"] = (int(words[words.index("smem") - 2])
                                              if "smem" in words else 0)
    for entry in found:  # ptxas warns (C7514) where it had to serialize wgmma
        entry["wgmma_serialized"] = any("C7514" in line and entry["function"] in line
                                        for line in log.splitlines())
    return found


def fused_ptxas(info, label, channels, layout):
    """Print and return ptxas's report (`ptxas_summary`) for each
    instantiation of a fused-block kernel, with the kernel's own layout;
    fail if a kernel that was built has no report."""
    layouts = {c: layout(c) for c in channels}
    found = ptxas_summary(info["log"])
    for entry in found:  # <kernel>ILi<C>E[Lb<padded>E]<T>E, mangled
        fn = entry["function"]
        c = next(c for c in layouts if f"ILi{c}E" in fn)
        dtype = "float32" if re.search(rf"ILi{c}E(Lb[01]E)?fE", fn) else "bfloat16"
        entry.update(channels=c, x_dtype=dtype, **layouts[c])
        if "Lb1E" in fn or "Lb0E" in fn:  # B1: C below C' read element by element
            entry["padded"] = "Lb1E" in fn
        tag = " (C < C', padded)" if entry.get("padded") else ""
        print(f"    {label} C={c}{tag} x {dtype}: {entry['registers']} registers, spills "
              f"{entry['spill_store_bytes']} B stored / {entry['spill_load_bytes']} B loaded, "
              f"shared memory {entry['smem_bytes']} B dynamic + {entry['static_smem_bytes']} B "
              f"static, {entry['stages']} weight slots; wgmma serialized by ptxas "
              f"{entry['wgmma_serialized']}", flush=True)
    if not found and info["seconds"] > 0:
        raise AssertionError(f"no ptxas report for {label}")
    return found


def wide_ptxas(info, fc) -> list:
    """Print and return ptxas's report for each kernel of B1's wide path, with
    its dynamic shared memory at C = 768 (the LayerNorm's depends on C);
    fail if the library was built and has no report."""
    found = ptxas_summary(info["log"])
    lib = fc._library("convnext_block_wide")
    for entry in found:
        kernel = 0 if "layernorm" in entry["function"] else 1
        entry["smem_bytes_at_c768"] = (lib.convnext_block_wide_smem_bytes(kernel, 768)
                                       if "split" not in entry["function"] else 0)
        fn = entry["function"]
        name = next(k for k in ("layernorm", "gemm", "split_gelu") if k in fn)
        if name == "gemm":
            name += {"ILi0E": " product 1 -> u", "ILi1E": " product 1, split",
                     "ILi2E": " product 2"}[re.search(r"ILi[0-2]E", fn).group()]
        name += ", x bfloat16" if "bfloat16" in fn else ""
        print(f"    B1 wide {name}: {entry['registers']} registers, spills "
              f"{entry['spill_store_bytes']} B stored / {entry['spill_load_bytes']} B loaded, shared "
              f"memory {entry['smem_bytes_at_c768']} B dynamic at C = 768; wgmma serialized by "
              f"ptxas {entry['wgmma_serialized']}", flush=True)
    if not found and info["seconds"] > 0:
        raise AssertionError("no ptxas report for the wide path")
    return found


def flagship_config(fused=True):
    import dataclasses

    from optispeech_tpu_torch.config import ExperimentConfig
    from optispeech_tpu_torch.models.optispeech import with_fused_blocks

    cfg = ExperimentConfig()
    tp = dataclasses.replace(cfg.data.text_processor, tokenizer="en-g2p")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, text_processor=tp))
    return with_fused_blocks(cfg) if fused else cfg


def bench_inputs():
    from optispeech_tpu_torch.values import InferenceInputs

    rng = np.random.default_rng(0)
    n, b = BENCH["n_tokens"], BENCH["batch"]
    ids = [rng.integers(3, 150, n).astype(np.int64).tolist() for _ in range(b)]
    return InferenceInputs.from_ids_and_lengths(ids=ids, lengths=[n] * b, clean_text="bench",
                                                d_factor=BENCH["d_factor"], p_factor=1.0,
                                                e_factor=1.0)


def main_path(fc, mas, api):
    """Returns the fused block's launch count over the main path's runs and
    the median wall ms of synthesise_on_device at bench shape."""
    fc.convnext_block_fused.launches = 0
    fc.convnext_block_fused_int8.launches = 0
    mas.viterbi_decode.launches = 0
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
    assert mas.viterbi_decode.launches == 0, "synthesis launched the MAS kernel"
    assert fc.convnext_block_fused_int8.launches == 0, "synthesis launched the int8 block"
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
    return launches, ms


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


def dim_model(fc, dim, layers=None):
    """The flagship model at `generator.dim: dim` (each stack cut to `layers`
    blocks if given), fused, on the card against the CPU (its twin): batch 2
    at 256 frames. Returns the launches of the card's call (all, and those of
    the wide path) and how many of its blocks the shape rule gave the kernel."""
    import dataclasses

    from optispeech_tpu_torch.models.optispeech import OptiSpeech

    cfg = flagship_config()
    g = dataclasses.replace(cfg.generator, dim=dim)
    if layers:
        g = dataclasses.replace(
            g, encoder=dataclasses.replace(g.encoder, num_layers=layers),
            decoder=dataclasses.replace(g.decoder, num_layers=layers),
            vocoder=dataclasses.replace(g.vocoder, num_layers=layers))
    cfg = dataclasses.replace(cfg, generator=g)
    api = OptiSpeech(cfg, seed=0, device="cuda")
    cpu_api = OptiSpeech(cfg, device="cpu",
                         state_dict={k: v.cpu() for k, v in api.generator.state_dict().items()})
    gen = api.generator
    blocks = [*(gen.decoder.convnext if gen.decoder.fused_pallas else []),
              *(gen.vocoder.backbone.convnext if gen.vocoder.fused_pallas else [])]
    taken = sum(fc.kernel_takes(256, b.pwconv1.in_features, b.pwconv1.out_features)
                for b in blocks)
    widths = sorted({(b.pwconv1.in_features, b.pwconv1.out_features) for b in blocks})
    inputs = api.prepare_input(SENTENCE)
    fc.convnext_block_fused.launches = fc.convnext_block_fused.wide_launches = 0
    gpu = api.synthesise_on_device(inputs, 256)
    torch.cuda.synchronize()
    launches, wide = fc.convnext_block_fused.launches, fc.convnext_block_fused.wide_launches
    cpu = cpu_api.synthesise_on_device(inputs, 256)
    dur_equal = torch.equal(gpu["durations"].cpu(), cpu["durations"])
    wav_diff = float((gpu["wav"].cpu() - cpu["wav"]).abs().max())
    print(f"  generator.dim {dim}{f', {layers} blocks a stack' if layers else ''}: fused blocks at "
          f"(C, I) {widths}: {taken} of {len(blocks)} take the kernel by the shape rule, "
          f"{len(blocks) - taken} run unfused; kernel launches in one decode {launches}, "
          f"{wide} of them on the wide path", flush=True)
    print(f"  batch 2, 256 frames: durations equal {dur_equal}; wav max|card - cpu| {wav_diff:.3e} "
          f"(atol {WAV_ATOL}); |wav| max {float(cpu['wav'].abs().max()):.3f}", flush=True)
    assert dur_equal, f"dim {dim}: durations differ between card and CPU"
    assert wav_diff <= WAV_ATOL, f"dim {dim}: wav differs between card and CPU by {wav_diff}"
    assert launches == taken, f"expected {taken} kernel launches in one decode, got {launches}"
    n_wide = sum(b.pwconv1.in_features > fc.MAX_CHANNELS for b in blocks)
    assert wide == n_wide, f"expected {n_wide} wide-path launches in one decode, got {wide}"
    assert bool(torch.isfinite(gpu["wav"]).all())
    return launches, wide, taken, len(blocks)


def mas_lengths(rng, b, t_feats, t_text):
    """Text lengths in [T/2, T] and frame lengths in [F/2, F]."""
    tl = rng.integers(t_text // 2, t_text + 1, b)
    fl = rng.integers(t_feats // 2, t_feats + 1, b)
    return tl, fl


def check_mas(mas, device):
    rng = np.random.default_rng(0)
    cases = {"training batch": (*MAS_SHAPE, None), "odd": (2, 43, 23, None),
             "one token": (3, 20, 9, ([1, 9, 4], [3, 20, 1]))}
    worst = {"durations": 0.0, "bin_loss_rel": 0.0, "grad": 0.0}
    for name, (b, t_feats, t_text, lengths) in cases.items():
        lp = np.log(rng.dirichlet(np.ones(t_text), size=(b, t_feats)) + 1e-8).astype(np.float32)
        tl, fl = lengths if lengths else mas_lengths(rng, b, t_feats, t_text)
        lp, tl, fl = (torch.as_tensor(np.asarray(a), device=device) for a in (lp, tl, fl))
        x, y = lp.clone().requires_grad_(True), lp.clone().requires_grad_(True)
        ds, bl = mas.viterbi_decode(x, tl, fl)
        (grad,) = torch.autograd.grad(bl, x)
        torch.cuda.synchronize()
        ds_ref, bl_ref = mas.viterbi_decode_reference(y, tl, fl)
        (grad_ref,) = torch.autograd.grad(bl_ref, y)
        d_ds = float((ds - ds_ref).abs().max())
        d_bl = abs(float(bl) - float(bl_ref)) / abs(float(bl_ref))
        d_grad = float((grad - grad_ref).abs().max())
        ok = d_ds == 0.0 and d_bl <= MAS_BIN_RTOL and d_grad <= MAS_GRAD_ATOL
        print(f"  {name:15s} B={b} T_feats={t_feats} T_text={t_text}: durations max|diff| "
              f"{d_ds:.1f}, bin loss rel diff {d_bl:.2e} (rtol {MAS_BIN_RTOL}), grad max|diff| "
              f"{d_grad:.2e} (atol {MAS_GRAD_ATOL}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"MAS kernel disagrees with its twin on `{name}`")
        worst = {k: max(worst[k], v) for k, v in
                 zip(worst, (d_ds, d_bl, d_grad))}
    return worst


def chain_cycles(lib_path):
    """Cycles per dependent step of the MAS kernels' two chains (forward,
    backtrace) from scripts/mas_chain.cu, and the card's maximum SM clock in
    MHz from nvidia-smi: the chain floor is frames x (forward + backtrace)
    cycles at that clock."""
    import ctypes

    lib = ctypes.CDLL(lib_path)
    lib.mas_chain_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    lib.mas_chain_launch.restype = ctypes.c_int
    rng = np.random.default_rng(5)
    inp = torch.as_tensor(rng.normal(size=96).astype(np.float32), device="cuda")
    out = torch.empty(32, device="cuda")
    cycles = torch.zeros(2, dtype=torch.int64, device="cuda")
    n = 4096
    best = None
    for _ in range(3):  # the first call loads the module
        err = lib.mas_chain_launch(inp.data_ptr(), out.data_ptr(), cycles.data_ptr(), n,
                                   torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"mas_chain: launch failed with cudaError {err}"
        torch.cuda.synchronize()
        per_step = [float(c) / (8 * n) for c in cycles.cpu()]
        best = per_step if best is None else [min(a, b) for a, b in zip(best, per_step)]
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    return {"forward_cycles": best[0], "backtrace_cycles": best[1], "sm_clock_mhz": mhz}


def chain_floor_ms(chain, frames):
    """frames x (forward + backtrace cycles a frame) at the maximum SM clock."""
    return frames * (chain["forward_cycles"] + chain["backtrace_cycles"]) / (chain["sm_clock_mhz"] * 1e3)


def mas_kernel(mas, fn, n_outputs, lp, tl, fl):
    """A launch of the MAS kernel's C function `fn` (`mas_wavefront_launch`,
    1 output, or `mas_extract_launch`, 2) on inputs converted and outputs
    allocated once, as the wrapper makes them, and the outputs: what a
    kernel's time is taken of (the wrapper adds host work that a short
    kernel would wait behind)."""
    lp, tl32, fl32, per_lane, dec = mas._kernel_inputs(lp, tl, fl)
    b, t_feats, t_text = lp.shape
    outs = [torch.zeros(b, t_text, device=lp.device) for _ in range(n_outputs)]
    args = [t.data_ptr() for t in (lp, tl32, fl32, *outs, dec)]
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = fn(*args, b, t_feats, t_text, per_lane, stream)
        assert err == 0, f"MAS kernel launch failed with cudaError {err}"

    return launch, outs


def shipped_mas_kernel(mas, name, lp, tl, fl):
    """`mas_kernel`'s launch for the shipped kernel `name`."""
    fn = getattr(mas._library(name), f"{name}_launch")
    return mas_kernel(mas, fn, 2 if name == "mas_extract" else 1, lp, tl, fl)[0]


def second_shape_ms(mas, name, b, t_feats, t_text, device):
    """The kernel's time at phase 6's / 9's second case shape (lengths from a
    seed), where launch and per-item set-up, not the chain, dominate."""
    rng = np.random.default_rng(6)
    lp = np.log(rng.dirichlet(np.ones(t_text), size=(b, t_feats)) + 1e-8).astype(np.float32)
    tl, fl = mas_lengths(rng, b, t_feats, t_text)
    args = [torch.as_tensor(np.asarray(a), device=device) for a in (lp, tl, fl)]
    return time_ms(shipped_mas_kernel(mas, name, *args), iters=50)


def mas_timing_inputs(device):
    """Log-probs at the training batch's shape with lengths from a seed (the
    timing inputs of both MAS kernels), and the count of valid cells."""
    b, t_feats, t_text = MAS_SHAPE
    rng = np.random.default_rng(1)
    lp = np.log(rng.dirichlet(np.ones(t_text), size=(b, t_feats)) + 1e-8).astype(np.float32)
    tl, fl = mas_lengths(rng, b, t_feats, t_text)
    tensors = [torch.as_tensor(np.asarray(a), device=device) for a in (lp, tl, fl)]
    return tensors, int((tl * fl).sum()), int(fl.max())


def time_mas(mas, device, chain_probe):
    """Kernel and twin times at the training batch's shape; the bound counts
    the valid region each item's lengths leave (the kernel reads no more),
    the chain floor the longest item's frames."""
    b, t_feats, t_text = MAS_SHAPE
    (lp_d, tl_d, fl_d), cells, chain = mas_timing_inputs(device)
    ms = time_ms(shipped_mas_kernel(mas, "mas_wavefront", lp_d, tl_d, fl_d), iters=50)
    wrapper_ms = time_ms(lambda: mas.viterbi_decode(lp_d, tl_d, fl_d)[0], iters=50)
    small_ms = second_shape_ms(mas, "mas_wavefront", 2, 43, 23, device)
    plain_ms = time_ms(lambda: mas.viterbi_decode_reference(lp_d, tl_d, fl_d), iters=2, repeats=3)
    nbytes = 4 * cells + 4 * b * t_text + 8 * b  # valid log-probs in, durations out, lengths
    bound_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ops = 2 * cells / PEAK_F32_FLOPS * 1e3  # one max and one add a cell
    row = {"shape": f"B={b} T_feats={t_feats} T_text={t_text} float32, tl in "
                    f"[{t_text // 2}, {t_text}], fl in [{t_feats // 2}, {t_feats}]",
           "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bound_bytes, bound_ops),
           "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
           "bytes": nbytes, "full_tensor_bytes": 4 * b * t_feats * t_text,
           "decision_bytes": mas.decision_bytes(b, t_feats, mas.tokens_per_lane(t_text)),
           "tokens_per_lane": mas.tokens_per_lane(t_text), "chain_frames": chain,
           "chain_floor_ms": chain_floor_ms(chain_probe, chain), "chain_probe": chain_probe,
           "wrapper_ms": wrapper_ms, "ms_2x43x23": small_ms}
    print(f"  {row['shape']}: kernel {ms:.4f} ms (the wrapper with its bin loss {wrapper_ms:.4f}; "
          f"at (2, 43, 23) {small_ms:.4f})  bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
          f"{nbytes / 1e6:.1f} MB of valid cells; the whole tensor is "
          f"{row['full_tensor_bytes'] / 1e6:.1f} MB; the kernel also writes and reads "
          f"{row['decision_bytes'] / 1e3:.1f} KB of decision bits, {row['tokens_per_lane']} tokens a "
          f"lane)  chain floor {row['chain_floor_ms']:.4f} ms ({chain} frames x "
          f"({chain_probe['forward_cycles']:.1f} + {chain_probe['backtrace_cycles']:.1f}) cycles at "
          f"{chain_probe['sm_clock_mhz']:.0f} MHz)  twin {plain_ms:.4f} ms  library: none (no "
          f"single PyTorch call computes MAS)  -> {row['bound_ms'] / ms:.1%} of bound, "
          f"{row['chain_floor_ms'] / ms:.1%} of the chain floor", flush=True)
    return row


def training_config(pretraining_steps=0, dropout=True, compute_dtype="float32"):
    """The flagship ExperimentConfig with the discriminator trained from the
    first step, G computing in `compute_dtype`; `dropout=False` sets every
    dropout and drop-path rate to 0."""
    import dataclasses

    from optispeech_tpu_torch.config import ExperimentConfig

    cfg = ExperimentConfig()
    cfg = dataclasses.replace(cfg, train_args=dataclasses.replace(
        cfg.train_args, pretraining_steps=pretraining_steps, compute_dtype=compute_dtype))
    if dropout:
        return cfg
    g = cfg.generator
    zero = lambda v: dataclasses.replace(v, dropout=0.0, embed_dropout=0.0)  # noqa: E731
    g = dataclasses.replace(
        g, text_embedding=dataclasses.replace(g.text_embedding, dropout=0.0),
        encoder=dataclasses.replace(g.encoder, drop_path=0.0),
        decoder=dataclasses.replace(g.decoder, drop_path=0.0),
        vocoder=dataclasses.replace(g.vocoder, drop_path=0.0),
        duration_predictor=zero(g.duration_predictor), pitch_predictor=zero(g.pitch_predictor),
        energy_predictor=zero(g.energy_predictor))
    return dataclasses.replace(cfg, generator=g)


def training_batch(cfg, b, t_text, t_mel, device, seed=0):
    """Random ids, mel, pitch and energy from numpy `seed`, lengths as in
    phase 6, segment starts sampled on the host with the matching
    ground-truth crop (`wav_seg`), as the JAX trainer ships them."""
    from optispeech_tpu_torch.ops.segments import (
        host_sample_segment_starts,
        host_slice_wav_segments,
    )

    rng = np.random.default_rng(seed)
    feats = cfg.generator.features
    x_lengths, mel_lengths = mas_lengths(rng, b, t_mel, t_text)
    x = rng.integers(3, 150, (b, t_text))
    x[np.arange(t_text)[None, :] >= x_lengths[:, None]] = 0
    wav = (rng.normal(size=(b, t_mel * feats.hop_length)) * 0.1).astype(np.float32)
    seg = min(cfg.generator.segment_size, t_mel)
    starts = host_sample_segment_starts(rng, mel_lengths, seg)
    batch = dict(
        x=x, x_lengths=x_lengths.astype(np.int32), mel_lengths=mel_lengths.astype(np.int32),
        mel=rng.normal(size=(b, feats.n_feats, t_mel)).astype(np.float32),
        pitches=rng.normal(size=(b, t_mel)).astype(np.float32),
        energies=rng.normal(size=(b, t_mel)).astype(np.float32),
        start_idx=starts, wav_seg=host_slice_wav_segments(wav, starts, seg, feats.hop_length))
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def train_full_width(fc, mas, compute_dtype="float32"):
    """Returns the MAS kernel's launch count over the 4 steps and their
    synchronised wall times in ms."""
    from optispeech_tpu_torch.training.state import init_train_state
    from optispeech_tpu_torch.training.step import make_train_step

    cfg = training_config(compute_dtype=compute_dtype)
    state = init_train_state(cfg, "cuda", seed=0)
    n_g = sum(p.numel() for p in state.generator.parameters())
    n_d = sum(p.numel() for p in state.discriminator.parameters())
    g0 = [p.detach().clone() for p in state.generator.parameters()]
    d0 = [p.detach().clone() for p in state.discriminator.parameters()]
    b, (t_text, t_mel) = cfg.data.batch_size, (MAS_SHAPE[2], MAS_SHAPE[1])
    batch = training_batch(cfg, b, t_text, t_mel, "cuda")
    step = make_train_step(cfg)
    print(f"  ExperimentConfig() (pretraining_steps=0, G in {compute_dtype}), seed 0: "
          f"G {n_g} / D {n_d} parameters; "
          f"batch {b}, {t_text} tokens, {t_mel} frames, segment {cfg.generator.segment_size}",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    fc.convnext_block_fused.launches = 0
    fc.convnext_block_fused_int8.launches = 0
    mas.viterbi_decode.launches = 0
    walls, logs = [], None
    for i in range(4):
        t0 = time.perf_counter()
        logs = step(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        bad = [k for k, v in logs.items() if not bool(torch.isfinite(v))]
        assert not bad, f"step {i}: non-finite logs {bad}"
    mas_launches, block_launches = mas.viterbi_decode.launches, fc.convnext_block_fused.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    g_moved = any(not torch.equal(a, p) for a, p in zip(g0, state.generator.parameters()))
    d_moved = any(not torch.equal(a, p) for a, p in zip(d0, state.discriminator.parameters()))
    print(f"  4 steps: wall {', '.join(f'{w:.1f}' for w in walls)} ms; median of the 3 after "
          f"warm-up {statistics.median(walls[1:]):.1f} ms per step (observation, not a claim); "
          f"peak memory {peak:.2f} GiB; MAS kernel launches {mas_launches}, fused-block "
          f"launches {block_launches}; G changed {g_moved}, D changed {d_moved}", flush=True)
    print("  last step: " + ", ".join(f"{k} {float(v):.4f}" for k, v in logs.items()), flush=True)
    assert mas_launches == 4, f"expected one MAS launch per step, got {mas_launches} in 4"
    assert block_launches == 0, f"the fused block launched {block_launches} times in training"
    assert fc.convnext_block_fused_int8.launches == 0, "training launched the int8 block"
    assert g_moved and d_moved, "a training step left G or D unchanged"
    return mas_launches, walls


def train_cross_device(compute_dtype="float32", rtol=STEP_LOG_RTOL):
    from optispeech_tpu_torch.training.state import init_train_state
    from optispeech_tpu_torch.training.step import make_train_step

    cfg = training_config(dropout=False, compute_dtype=compute_dtype)
    states = {dev: init_train_state(cfg, dev, seed=0) for dev in ("cuda", "cpu")}
    for part in ("generator", "discriminator"):
        sd = getattr(states["cuda"], part).state_dict()
        getattr(states["cpu"], part).load_state_dict({k: v.cpu() for k, v in sd.items()})
    batches = {dev: training_batch(cfg, 4, 32, 128, dev, seed=1) for dev in states}
    durations = {}
    for dev, state in states.items():
        args = [batches[dev][k] for k in ("x", "x_lengths", "mel", "mel_lengths", "pitches",
                                          "energies")]
        state.generator.train()
        with torch.no_grad():
            durations[dev] = state.generator(*args, start_idx=batches[dev]["start_idx"])[
                "durations"].cpu()
    step = make_train_step(cfg)
    logs = {dev: step(state, batches[dev]) for dev, state in states.items()}
    dur_equal = torch.equal(durations["cuda"], durations["cpu"])
    gaps = {k: abs(float(logs["cuda"][k]) - float(logs["cpu"][k])) / max(abs(float(logs["cpu"][k])),
                                                                        1e-12)
            for k in logs["cpu"]}
    worst = max(gaps, key=gaps.get)
    print(f"  batch 4, 32 tokens, 128 frames, no dropout, G in {compute_dtype}: durations equal "
          f"{dur_equal}; largest relative log gap {gaps[worst]:.2e} ({worst}; rtol {rtol})",
          flush=True)
    assert dur_equal, "MAS durations differ between card and CPU"
    assert gaps[worst] <= rtol, f"{worst} differs between card and CPU by {gaps[worst]}"


def check_extract(mas, device):
    """The extraction kernel against its twin and against the wavefront
    kernel on the same tensors; returns the worst gaps."""
    rng = np.random.default_rng(2)
    (lp_t, tl_t, fl_t), _, _ = mas_timing_inputs(device)
    cases = {"training batch": (lp_t, tl_t, fl_t)}
    for name, (b, t_feats, t_text, lengths) in {
            "frames43": (2, 43, 12, ([12, 7], [43, 29])),
            "pallas": (3, 40, 10, ([10, 6, 8], [40, 22, 31])),
            "one token": (3, 20, 9, ([1, 9, 4], [3, 20, 1]))}.items():
        lp = np.log(rng.dirichlet(np.ones(t_text), size=(b, t_feats)) + 1e-8).astype(np.float32)
        cases[name] = [torch.as_tensor(np.asarray(a), device=device) for a in (lp, *lengths)]
    worst = {"durations": 0.0, "binsum_rel": 0.0, "bin_loss_rel": 0.0}
    for name, (lp, tl, fl) in cases.items():
        ds, binsum = mas.mas_extract(lp, tl, fl)
        bl = mas.viterbi_decode_extract(lp, tl, fl)[1]
        wavefront = mas.mas_durations(lp, tl, fl)
        torch.cuda.synchronize()
        ds_ref, binsum_ref = mas.extract_reference(lp, tl, fl)
        bl_ref = mas.bin_loss_from_binsum(binsum_ref, fl, lp.shape[1])
        d_ds = float((ds - ds_ref).abs().max())
        d_bs = float(((binsum - binsum_ref).abs() / binsum_ref.abs().clamp(min=1e-30)).max())
        d_bl = abs(float(bl) - float(bl_ref)) / abs(float(bl_ref))
        same_as_b3 = torch.equal(ds, wavefront)
        ok = d_ds == 0.0 and d_bs <= MAS_BIN_RTOL and d_bl <= MAS_BIN_RTOL and same_as_b3
        print(f"  {name:15s} {tuple(lp.shape)}: durations max|diff| {d_ds:.1f}, equal to the "
              f"wavefront kernel's {same_as_b3}; binsum max rel diff {d_bs:.2e}, bin loss rel "
              f"diff {d_bl:.2e} (rtol {MAS_BIN_RTOL}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"extraction kernel disagrees on `{name}`")
        worst = {k: max(worst[k], v) for k, v in zip(worst, (d_ds, d_bs, d_bl))}
    return worst


def time_extract(mas, device, chain_probe):
    """The extraction kernel's time at the training batch's shape and
    phase 6's lengths; the bound counts the valid cells read once and the
    two (B, T_text) outputs written once."""
    b, t_feats, t_text = MAS_SHAPE
    (lp_d, tl_d, fl_d), cells, chain = mas_timing_inputs(device)
    ms = time_ms(shipped_mas_kernel(mas, "mas_extract", lp_d, tl_d, fl_d), iters=50)
    wrapper_ms = time_ms(lambda: mas.viterbi_decode_extract(lp_d, tl_d, fl_d)[0], iters=50)
    small_ms = second_shape_ms(mas, "mas_extract", 2, 43, 12, device)
    plain_ms = time_ms(lambda: mas.extract_reference(lp_d, tl_d, fl_d), iters=2, repeats=3)
    nbytes = 4 * cells + 2 * 4 * b * t_text + 8 * b
    bound_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ops = 2 * cells / PEAK_F32_FLOPS * 1e3
    row = {"shape": f"B={b} T_feats={t_feats} T_text={t_text} float32, phase 6's lengths",
           "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bound_bytes, bound_ops),
           "bound_by": "bytes" if bound_bytes >= bound_ops else "operations", "bytes": nbytes,
           "chain_frames": chain, "chain_floor_ms": chain_floor_ms(chain_probe, chain),
           "wrapper_ms": wrapper_ms, "ms_2x43x12": small_ms}
    print(f"  {row['shape']}: kernel {ms:.4f} ms (the wrapper with its bin loss {wrapper_ms:.4f}; "
          f"at (2, 43, 12) {small_ms:.4f})  bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {nbytes / 1e6:.1f} MB)  chain floor "
          f"{row['chain_floor_ms']:.4f} ms ({chain} frames)  twin {plain_ms:.4f} ms  library: none "
          f"(no single PyTorch call computes MAS)  -> {row['bound_ms'] / ms:.1%} of bound, "
          f"{row['chain_floor_ms'] / ms:.1%} of the chain floor", flush=True)
    return row


def trainer_loaders(cfg):
    from optispeech_tpu_torch.data.datamodule import BucketedCollate, DataLoader, SyntheticDataset

    feats = cfg.generator.features
    collate = BucketedCollate(
        n_feats=feats.n_feats, statistics=cfg.data.statistics, hop_length=feats.hop_length,
        text_bucket=cfg.data.text_bucket_size, mel_bucket=cfg.data.mel_bucket_size,
        max_text_len=cfg.data.max_text_len, max_mel_len=cfg.data.max_mel_len)
    data = lambda n, seed: SyntheticDataset(  # noqa: E731
        n_items=n, n_feats=feats.n_feats, hop_length=feats.hop_length, seed=seed,
        text_range=TEXT_RANGE, mel_range=MEL_RANGE)
    train = DataLoader(data(TRAIN_ITEMS, 0), cfg.data.batch_size, collate, shuffle=True,
                       seed=cfg.data.seed)
    val = DataLoader(data(VAL_ITEMS, 1), cfg.data.batch_size, collate, shuffle=False,
                     drop_last=False)
    return train, val


def train_entry_point(fc, mas, bare_ms):
    """cli/train.py::run at full width, then a fresh Trainer that restores
    step 4 and takes a 5th step; returns the kernels' launch counts over
    both. `bare_ms` are phase 7's synchronised step times."""
    import dataclasses
    import shutil
    import tempfile

    cfg = training_config()
    cfg = dataclasses.replace(
        cfg, log_every_n_steps=1, val_every_n_steps=4, ckpt_every_n_steps=4,
        train_args=dataclasses.replace(cfg.train_args, evaluate_periodicity=True))
    # the run (a 666 MiB checkpoint) goes outside the checkout and is deleted after
    out_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_trainer_"))
    try:
        return _train_entry_point(fc, mas, bare_ms, cfg, out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _train_entry_point(fc, mas, bare_ms, cfg, out_dir):
    from optispeech_tpu_torch.cli import train as cli
    from optispeech_tpu_torch.training.checkpoint import TrainCheckpointManager
    from optispeech_tpu_torch.training.state import init_train_state
    from optispeech_tpu_torch.training.trainer import Trainer

    t_data = time.perf_counter()
    train, val = trainer_loaders(cfg)
    print(f"  synthetic corpus: {TRAIN_ITEMS} train / {VAL_ITEMS} val utterances, tokens "
          f"{TEXT_RANGE[0]}-{TEXT_RANGE[1] - 1}, frames {MEL_RANGE[0]}-{MEL_RANGE[1] - 1}, made in "
          f"{time.perf_counter() - t_data:.1f} s; batch {cfg.data.batch_size}", flush=True)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for counted in (fc.convnext_block_fused, fc.convnext_block_fused_int8, mas.viterbi_decode,
                    mas.viterbi_decode_extract):
        counted.launches = 0
    t0 = time.perf_counter()
    args = cli.parse_args(["--device", "cuda", "--out-dir", str(out_dir), "--max-steps", "4",
                           "--no-print-config"])
    _, state = cli.run(cfg, args, train_loader=train, val_loader=val)
    run_s = time.perf_counter() - t0
    assert state.step == 4, f"the run ended at step {state.step}, not 4"
    # a fresh trainer restores step 4 and takes one more step
    resumed = Trainer(cfg, out_dir=str(out_dir), device="cuda")
    state = resumed.init_or_restore_state()
    restored = state.step
    assert restored == 4, f"the fresh trainer restored step {restored}, not 4"
    state = resumed.fit(trainer_loaders(cfg)[0], val, max_steps=5, state=state)
    launches = {"viterbi_decode": mas.viterbi_decode.launches,
                "viterbi_decode_extract": mas.viterbi_decode_extract.launches,
                "convnext_block_fused": fc.convnext_block_fused.launches,
                "convnext_block_fused_int8": fc.convnext_block_fused_int8.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # the checkpoint layer on its own: the trained state saved and restored
    ckpt_mb = sum(f.stat().st_size for f in (out_dir / cfg.ckpt_dir / "4").rglob("*")
                  if f.is_file()) / 2 ** 20
    manager = TrainCheckpointManager(str(out_dir / "timed_ckpt"), keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    manager.save(state.step, state, cfg)
    t1 = time.perf_counter()
    manager.wait()
    t2 = time.perf_counter()
    fresh = init_train_state(cfg, "cuda", seed=1)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    manager.restore(fresh)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    assert all(torch.equal(a, b) for a, b in zip(fresh.generator.parameters(),
                                                 state.generator.parameters()))
    del fresh

    rows = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
    bad = [(r["step"], k) for r in rows for k, v in r.items() if not np.isfinite(v)]
    val_rows = [r for r in rows if "total_loss/val_total" in r]
    fit_ms = {r["step"]: 1e3 / r["perf/steps_per_sec"] for r in rows if "perf/steps_per_sec" in r}
    fmt = lambda xs: ", ".join(f"{x:.1f}" for x in xs)  # noqa: E731
    print(f"  run(): 4 steps + validation + checkpoints + export in {run_s:.1f} s; a fresh "
          f"trainer restored step {restored} and took step 5", flush=True)
    print(f"  fit step (metrics.jsonl perf/steps_per_sec, one log to the next), steps "
          f"{', '.join(str(k) for k in fit_ms)}: {fmt(fit_ms.values())} ms; median of steps 2-4 "
          f"{statistics.median([fit_ms[k] for k in (2, 3, 4)]):.1f} ms against phase 7's bare "
          f"step median {statistics.median(bare_ms[1:]):.1f} ms (observation, not a claim)",
          flush=True)
    v = val_rows[0] if val_rows else {}
    print(f"  validation pass (perf/val_*): {1e3 * v.get('perf/val_seconds', 0):.1f} ms, of which "
          f"synthesis {1e3 * v.get('perf/val_synth_seconds', 0):.1f} ms and perceptual metrics "
          f"{1e3 * v.get('perf/val_metrics_seconds', 0):.1f} ms; {len(val_rows)} val row(s): "
          + ", ".join(f"{k} {v[k]:.4f}" for k in ("total_loss/val_total",
                                                    "gen_subloss/val_align_loss",
                                                    "val/f1_score") if k in v), flush=True)
    print(f"  checkpoint at step 4: {ckpt_mb:.1f} MiB; the trained state saved again: save "
          f"(host copy, blocking) {(t1 - t0) * 1e3:.1f} ms, durable after {(t2 - t0) * 1e3:.1f} ms; "
          f"restore into a fresh state {(t4 - t3) * 1e3:.1f} ms", flush=True)
    print(f"  launches over both runs: {launches}; peak memory {peak:.2f} GiB", flush=True)
    assert not bad, f"non-finite logged values at {bad}"
    assert state.step == 5, f"the resumed run ended at step {state.step}, not 5"
    assert len(val_rows) == 1, f"expected one validation, got {len(val_rows)}"
    assert launches["viterbi_decode"] == 5, "expected one wavefront MAS launch per step"
    assert launches["convnext_block_fused_int8"] == 0, "the trainer launched the int8 block"
    n_val_batches = -(-VAL_ITEMS // cfg.data.batch_size)
    assert launches["viterbi_decode_extract"] == n_val_batches, (
        f"expected {n_val_batches} extraction launches (one per val batch)")
    return launches


def val_cross_device(mas, compute_dtype="float32", rtol=STEP_LOG_RTOL):
    """Returns the extraction kernel's launches in the card's step."""
    from optispeech_tpu_torch.training.state import init_train_state
    from optispeech_tpu_torch.training.step import make_val_step

    cfg = training_config(dropout=False, compute_dtype=compute_dtype)
    states = {dev: init_train_state(cfg, dev, seed=0) for dev in ("cuda", "cpu")}
    for part in ("generator", "discriminator"):
        sd = getattr(states["cuda"], part).state_dict()
        getattr(states["cpu"], part).load_state_dict({k: v.cpu() for k, v in sd.items()})
    batches = {dev: training_batch(cfg, 4, 32, 128, dev, seed=2) for dev in states}
    step = make_val_step(cfg)
    logs, durations = {}, {}
    for dev, state in states.items():
        b = batches[dev]
        mas.viterbi_decode_extract.launches = 0
        logs[dev] = step(state, b)[0]
        if dev == "cuda":
            launches = mas.viterbi_decode_extract.launches
        with torch.no_grad():
            durations[dev] = state.generator(
                *[b[k] for k in ("x", "x_lengths", "mel", "mel_lengths", "pitches", "energies")],
                start_idx=b["start_idx"], extract_durations=True)["durations"].cpu()
    dur_equal = torch.equal(durations["cuda"], durations["cpu"])
    gaps = {k: abs(float(logs["cuda"][k]) - float(logs["cpu"][k])) / max(abs(float(logs["cpu"][k])),
                                                                        1e-12)
            for k in logs["cpu"]}
    worst = max(gaps, key=gaps.get)
    print(f"  batch 4, 32 tokens, 128 frames, no dropout, G in {compute_dtype}: durations equal "
          f"{dur_equal}; largest relative log gap {gaps[worst]:.2e} ({worst}; rtol {rtol}); "
          f"extraction kernel launches on the card {launches}", flush=True)
    assert dur_equal, "extraction durations differ between card and CPU"
    assert gaps[worst] <= rtol, f"{worst} differs between card and CPU by {gaps[worst]}"
    assert launches == 1, f"expected one extraction launch per val batch, got {launches}"
    return launches


def int8_agreement(got, ref, rtol):
    """(frames with an element outside INT8_TOL + rtol * |ref|, frames,
    max|diff|, max|diff| / max|ref|)"""
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    close = diff <= INT8_TOL + rtol * r.abs()
    outside = int((~close.all(dim=-1)).sum())
    max_diff = float(diff.max())
    return outside, close.shape[0] * close.shape[1], max_diff, max_diff / float(r.abs().max())


def check_int8_kernel(fc, device):
    """Returns the largest |kernel - twin| and the frames outside the
    tolerance over all cases; fails unless every case is bit-equal."""
    gen = torch.Generator(device).manual_seed(3)  # drawn on the card: 22 M values a case
    worst, frames_outside = 0.0, 0
    cases = [(32, t) for t in (1792, 1000, 5)] + [(1, t) for t in (1, 63, 65, 129)]
    for width, (c, inter) in WIDTHS.items():
        for b, t in cases:
            for dtype in (torch.float32, torch.bfloat16):
                x, p = block_inputs(gen, b, t, c, inter, dtype, device, weight_dtype=torch.float32)
                got = fc.convnext_block_fused_int8(x, *p)
                torch.cuda.synchronize()
                ref = fc.convnext_block_int8_reference(x, *p)
                rtol = INT8_TOL + (BF16_RTOL if dtype == torch.bfloat16 else 0.0)
                outside, frames, max_diff, rel = int8_agreement(got, ref, rtol)
                equal = torch.equal(got, ref)
                ok = equal and outside <= (1 - INT8_FRAME_SHARE) * frames and rel <= INT8_ELEM_REL
                print(f"  {width:8s} C={c} I={inter} B={b:2d} T={t:5d} {str(dtype):15s} frames outside "
                      f"{outside} of {frames}; bit-equal {equal}; max|diff| "
                      f"{max_diff:.3e}, /max|ref| {rel:.3e} (atol {INT8_TOL}, rtol {rtol:.4g}) "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise AssertionError(
                        f"int8 kernel disagrees with its twin at {width} B={b} T={t} {dtype}")
                worst = max(worst, max_diff)
                frames_outside += outside
    return worst, frames_outside


def library_block_int8(x, dw_conv, lnw, lnb, w1q, s1, b1, w2q, s2, b2, gamma):
    """The unfused int8 block as PyTorch's own operators compute it: cuDNN
    depthwise conv, layer_norm, per-frame quantizers as elementwise ops, two
    `torch._int_mm` products (cuBLASLt int8), gelu."""
    f = torch.nn.functional
    b, t, c = x.shape
    h = f.conv1d(x.float().transpose(1, 2), dw_conv[0], dw_conv[1], padding=3,
                 groups=c).transpose(1, 2)
    h = f.layer_norm(h, (c,), lnw, lnb, eps=1e-6).reshape(b * t, c)
    amax = h.abs().amax(-1, keepdim=True).clamp_min(1e-12)
    u = torch._int_mm(torch.round(h * (127.0 / amax)).to(torch.int8), w1q).float()
    u = f.gelu(u * (amax / 127.0) * s1 + b1, approximate="none")
    amax = u.abs().amax(-1, keepdim=True).clamp_min(1e-12)
    h2 = torch._int_mm(torch.round(u * (127.0 / amax)).to(torch.int8), w2q).float()
    h2 = h2 * (amax / 127.0) * s2 + b2
    return (x.float() + gamma * h2.reshape(b, t, c)).to(x.dtype)


def time_int8_kernel(fc, device):
    """Kernel (on a pack made once), wrapper (on that pack, and packing per
    call), twin and unfused-library times at the A/B's shape, x in bfloat16
    as the A/B runs it."""
    gen = torch.Generator(device).manual_seed(4)
    b, t = 32, BENCH["n_frames"]
    rows = {}
    for width, (c, inter) in WIDTHS.items():
        x, p = block_inputs(gen, b, t, c, inter, torch.bfloat16, device, weight_dtype=torch.float32)
        dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma = p
        packed = fc.kernel_weights_int8(w1, w2)
        (w1q, s1), (w2q, s2) = fc.quantize_weight_int8(w1), fc.quantize_weight_int8(w2)
        # torch._int_mm takes its second operand column-major
        lib_args = (x, (dw.t().contiguous()[:, None, :], dwb), lnw, lnb, w1q.t().contiguous().t(),
                    s1, b1, w2q.t().contiguous().t(), s2, b2, gamma)
        ms = time_ms(lambda: fc.convnext_block_int8_launch(x, dw, dwb, lnw, lnb, packed, b1, b2,
                                                           gamma), iters=20)
        cached_ms = time_ms(lambda: fc.convnext_block_fused_int8(x, *p, packed=packed), iters=20)
        wrapper_ms = time_ms(lambda: fc.convnext_block_fused_int8(x, *p), iters=20)
        plain_ms = time_ms(lambda: fc.convnext_block_int8_reference(x, *p), iters=3)
        library_ms = time_ms(lambda: library_block_int8(*lib_args), iters=10)
        ops = 4 * b * t * c * inter
        nbytes = (2 * b * t * c * x.element_size()  # x read once, out written once
                  + sum(q.numel() * q.element_size() for q in (dw, dwb, lnw, lnb, b1, b2, gamma))
                  + sum(q.numel() * q.element_size() for q in packed))
        bound_ops, bound_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
        rows[width] = {
            "shape": f"B={b} T={t} C={c} I={inter} bfloat16",
            "ms": ms, "wrapper_cached_ms": cached_ms, "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
            "ops": ops, "bytes": nbytes,
        }
        r = rows[width]
        print(f"  {width:8s} {r['shape']}: kernel {ms:.4f} ms (previous design "
              f"{PREVIOUS_INT8_MS[width]:.4f}, from PERF.md; wrapper on "
              f"the cached pack {cached_ms:.4f}, packing on each call {wrapper_ms:.4f})  bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}; {ops:.3e} int8 ops, {nbytes / 1e6:.1f} MB)  "
              f"twin {plain_ms:.4f} ms  library {library_ms:.4f} ms  -> {r['bound_ms'] / ms:.1%} "
              f"of bound", flush=True)
    return rows


def int8_entry_point(fc):
    """cli/int8_ab.py::main at its default shape; returns the kernels'
    launch counts over it and the int8 trunk's error with x in float32."""
    from optispeech_tpu_torch.cli import int8_ab

    packs = {"kernel_weights": 0, "kernel_weights_int8": 0}
    originals = {name: getattr(fc, name) for name in packs}

    def counted(name):
        def pack(*args):
            packs[name] += 1
            return originals[name](*args)
        return pack

    fc.convnext_block_fused.launches = 0
    fc.convnext_block_fused_int8.launches = 0
    try:  # count the A/B's packs: one per fused arm
        for name in packs:
            setattr(fc, name, counted(name))
        res = int8_ab.main(["--batch", "32", "--t", "1792"])
    finally:
        for name, fn in originals.items():
            setattr(fc, name, fn)
    launches = {"convnext_block_fused_int8": fc.convnext_block_fused_int8.launches,
                "convnext_block_fused": fc.convnext_block_fused.launches}
    calls = {arm: res[arm]["calls"] for arm in ("fused_int8", "fused_bf16")}
    print(f"  launches {launches} over {calls} trunk calls; packs {packs}; int8 over fused_bf16 "
          f"{res['speedup']:.3f}x (device time)", flush=True)
    assert packs == {"kernel_weights": 1, "kernel_weights_int8": 1}, (
        f"expected one pack per fused arm, got {packs}")
    assert launches["convnext_block_fused_int8"] == int8_ab.N_BLOCKS * calls["fused_int8"], (
        "expected 8 int8 kernel launches per int8 trunk call")
    assert launches["convnext_block_fused"] == int8_ab.N_BLOCKS * calls["fused_bf16"], (
        "expected 8 bf16 kernel launches per fused-bf16 trunk call")
    for arm in ("xla_bf16", "fused_bf16", "fused_int8"):
        assert res[arm]["corr"] > 0.999, f"{arm}: correlation {res[arm]['corr']} with the oracle"

    # the int8 trunk on a float32 residual stream, against the same oracle
    p = int8_ab.make_params(torch.Generator().manual_seed(0), "cuda")
    x = (torch.randn(32, 1792, int8_ab.C, generator=torch.Generator().manual_seed(1)) * 0.5).cuda()
    fns = int8_ab.arms(p)
    with torch.no_grad():
        ref = fns["oracle_f32"](x).float()
        got = fns["fused_int8"](x).float()
    err = float((got - ref).abs().max() / ref.abs().max())
    print(f"  x in bfloat16 (the A/B): rel-err xla_bf16 {res['xla_bf16']['rel_err']:.4g}, "
          f"fused_bf16 {res['fused_bf16']['rel_err']:.4g}, fused_int8 "
          f"{res['fused_int8']['rel_err']:.4g}; x in float32: int8 trunk rel-err {err:.4g} "
          f"(limit {INT8_AB_ERR})", flush=True)
    assert err < INT8_AB_ERR, f"the int8 trunk is {err} of max|oracle| off the f32 oracle"
    return launches, res, err


def workflow_data(root):
    """Phase 14 (a): corpus -> datafiles -> statistics through the port's
    entry points; returns (the datafiles' directory, the statistics)."""
    from optispeech_tpu_torch.cli import preprocess, stats
    from optispeech_tpu_torch.data.synthcorpus import generate_corpus
    from optispeech_tpu_torch.utils.wavio import load_wav

    corpus, data = root / "corpus", root / "data"
    t0 = time.perf_counter()
    manifest = generate_corpus(str(corpus), n_utterances=WORKFLOW_UTTERANCES, seed=0,
                               frontend="en-g2p")
    t1 = time.perf_counter()
    train, val = preprocess.main([str(corpus), str(data), *WORKFLOW_CONFIG, "--val-fraction",
                                  str(WORKFLOW_VAL_FRACTION)])
    t2 = time.perf_counter()
    statistics_ = stats.main(["-o", str(data / "stats.json"), *WORKFLOW_CONFIG,
                              f"data.train_filelist_path={data / 'train.txt'}"])
    t3 = time.perf_counter()
    n, sr = manifest["n_utterances"], manifest["sample_rate"]
    audio_s = sum(len(load_wav(str(p))[0]) for p in (corpus / "wavs").iterdir()) / sr
    print(f"  corpus (synthcorpus, en-g2p, seed 0): {n} utterances, {audio_s:.1f} s of audio at "
          f"{sr} Hz, in {t1 - t0:.2f} s ({1e3 * (t1 - t0) / n:.1f} ms per "
          f"utterance)", flush=True)
    print(f"  preprocess (cli/preprocess.py, en-g2p, ensemble pitch, 4 spawned workers): "
          f"{len(train)} train / {len(val)} val in {t2 - t1:.2f} s ({1e3 * (t2 - t1) / n:.1f} ms "
          f"per utterance)", flush=True)
    print(f"  stats (cli/stats.py): {len(train)} utterances in {t3 - t2:.2f} s "
          f"({1e3 * (t3 - t2) / len(train):.1f} ms per utterance): "
          + ", ".join(f"{k} {v}" for k, v in statistics_.items()), flush=True)
    assert len(train) + len(val) == n and len(val) == int(n * WORKFLOW_VAL_FRACTION)
    assert all(np.isfinite(v) for v in statistics_.values()), statistics_
    assert statistics_["pitch_max"] > statistics_["pitch_min"] >= 0
    return data, statistics_


def workflow_train(data, statistics_, run_dir):
    """Phase 14 (b): cli/train.py::main on the datafiles, on the card;
    returns the run's metrics rows and its wall seconds."""
    from optispeech_tpu_torch.cli import train

    overrides = [*WORKFLOW_CONFIG, f"data.batch_size={WORKFLOW_BATCH}",
                 f"data.train_filelist_path={data / 'train.txt'}",
                 f"data.valid_filelist_path={data / 'val.txt'}",
                 f"val_every_n_steps={WORKFLOW_STEPS}", "log_every_n_steps=1",
                 *(f"data.statistics.{k}={v}" for k, v in statistics_.items())]
    t0 = time.perf_counter()
    train.main(["--device", "cuda", "--out-dir", str(run_dir), "--max-steps",
                str(WORKFLOW_STEPS), "--no-print-config", *overrides])
    seconds = time.perf_counter() - t0
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    return rows, seconds


def workflow_infer(ckpt, out_dir, *flags):
    """`cli/infer.py --fused` on `ckpt` for SENTENCE; returns the outputs and
    the wavs it wrote, read back with the port's load_wav."""
    from optispeech_tpu_torch.cli import infer
    from optispeech_tpu_torch.utils.wavio import load_wav

    out = infer.main([str(ckpt), SENTENCE, str(out_dir), "--fused", *flags])
    wavs = [load_wav(str(out_dir / f"gen-{i + 1}.wav"))[0] for i in range(len(out.wav_lengths))]
    assert sorted(p.name for p in out_dir.iterdir()) == [f"gen-{i + 1}.wav"
                                                        for i in range(len(wavs))]
    return out, wavs


def check_wavs(out, wavs, hop, label):
    frames = out.durations.sum(axis=1)
    assert len(wavs) == 2, f"{label}: {len(wavs)} wavs for two sentences"
    for i, wav in enumerate(wavs):
        assert np.isfinite(wav).all(), f"{label}: gen-{i + 1}.wav is not finite"
        assert len(wav) == frames[i] * hop, (
            f"{label}: gen-{i + 1}.wav holds {len(wav)} samples, not {frames[i]} x {hop}")
        assert len(wav) > 0, f"{label}: gen-{i + 1}.wav is empty"


def user_workflow(fc, mas):
    """Phase 14 in a temporary directory outside the checkout, deleted
    after; returns B1's launches over the phase."""
    import shutil
    import tempfile

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_workflow_"))
    try:
        return _user_workflow(fc, mas, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _user_workflow(fc, mas, root):
    from optispeech_tpu_torch.models.optispeech import OptiSpeech

    data, statistics_ = workflow_data(root)

    for counted in (fc.convnext_block_fused, fc.convnext_block_fused_int8, mas.viterbi_decode,
                    mas.viterbi_decode_extract):
        counted.launches = 0
    run_dir = root / "run"
    rows, train_s = workflow_train(data, statistics_, run_dir)
    n_val = len((data / "val.txt").read_text().splitlines())
    val_batches = -(-n_val // WORKFLOW_BATCH)
    ckpt = run_dir / "inference_ckpt"
    speakers = json.loads((ckpt / "config.json").read_text())["config"]["generator"]["num_speakers"]
    step_ms = [1e3 / r["perf/steps_per_sec"] for r in rows if "perf/steps_per_sec" in r]
    val_rows = [r for r in rows if "total_loss/val_total" in r]
    bad = [(r["step"], k) for r in rows for k, v in r.items() if not np.isfinite(v)]
    mas_launches = (mas.viterbi_decode.launches, mas.viterbi_decode_extract.launches)
    print(f"  train (cli/train.py::main, flagship widths, batch {WORKFLOW_BATCH}, "
          f"{WORKFLOW_STEPS} steps, {speakers} speakers from speaker_ids.json): {train_s:.1f} s in "
          f"all (set-up, steps, validation, checkpoint, export); steps (metrics.jsonl "
          f"perf/steps_per_sec) {', '.join(f'{ms:.1f}' for ms in step_ms)} ms; MAS launches "
          f"{mas_launches[0]}, extraction launches {mas_launches[1]} over {len(val_rows)} "
          f"validation(s) of {val_batches} batch(es)", flush=True)
    assert not bad, f"non-finite logged values at {bad}"
    assert speakers == 4, f"the run trained {speakers} speakers, not the corpus's 4"
    assert len(step_ms) == WORKFLOW_STEPS and len(val_rows) == 1
    assert mas_launches[0] == WORKFLOW_STEPS, "expected one wavefront MAS launch per step"
    assert mas_launches[1] == val_batches, "expected one extraction launch per val batch"
    assert fc.convnext_block_fused.launches == fc.convnext_block_fused_int8.launches == 0

    feats = flagship_config().generator.features
    hop, sr = feats.hop_length, feats.sample_rate
    fc.convnext_block_fused.launches = 0
    out, wavs = workflow_infer(ckpt, root / "infer_trained")
    trained_launches = fc.convnext_block_fused.launches
    print(f"  infer (cli/infer.py --fused, the trained checkpoint): {len(wavs)} wavs, "
          f"{int(out.wav_lengths.sum()) / sr:.3f} s of audio; latency {out.latency:.2f} ms, "
          f"rtf {out.rtf:.5f}; B1 launches {trained_launches}", flush=True)
    check_wavs(out, wavs, hop, "trained")
    assert trained_launches == 12, f"expected 12 B1 launches per synthesise, got {trained_launches}"

    OptiSpeech(flagship_config(), seed=0, device="cpu").save_checkpoint(str(root / "flagship"))
    fc.convnext_block_fused.launches = 0
    card, card_wavs = workflow_infer(root / "flagship", root / "infer_card")
    card_launches = fc.convnext_block_fused.launches
    cpu, cpu_wavs = workflow_infer(root / "flagship", root / "infer_cpu", "--device", "cpu")
    assert fc.convnext_block_fused.launches == card_launches, "the CPU run launched B1"
    check_wavs(card, card_wavs, hop, "card")
    check_wavs(cpu, cpu_wavs, hop, "cpu")
    dur_equal = np.array_equal(card.durations, cpu.durations)
    wav_diff = max(float(np.abs(a - b).max()) for a, b in zip(card_wavs, cpu_wavs))
    print(f"  infer (cli/infer.py --fused, phase 4's flagship weights through "
          f"OptiSpeech.save_checkpoint): card latency {card.latency:.2f} ms, rtf {card.rtf:.5f}, B1 launches {card_launches}; "
          f"card against --device cpu: durations equal {dur_equal}, wav files max|card - cpu| "
          f"{wav_diff:.3e} (atol {WAV_ATOL})", flush=True)
    assert card_launches == 12, f"expected 12 B1 launches per synthesise, got {card_launches}"
    assert dur_equal, "durations differ between card and CPU through cli/infer.py"
    assert wav_diff <= WAV_ATOL, f"wav files differ between card and CPU by {wav_diff}"
    return trained_launches + card_launches


def one_step_from_a_ceiling(d, factor):
    """Whether moving each bf16 value of `d` by one bf16 step moves
    ceil(d * factor): where two correct bf16 computations may give two
    durations."""
    d = d.float()
    step = torch.exp2(torch.floor(torch.log2(d.abs().clamp(min=1e-30))) - 7)
    ceil = torch.ceil(d * factor)
    return (torch.ceil((d - step) * factor) != ceil) | (torch.ceil((d + step) * factor) != ceil)


def bf16_durations_before_ceiling(api, inputs):
    """exp(log-duration) - clip in bf16, (B, T_text): the durations before
    the factor and the ceiling, as `api` computes them."""
    from optispeech_tpu_torch.ops import sequence_mask

    gen = api.generator
    x, x_lengths, sids, lids = api._tensors(inputs)[:4]
    pad = ~sequence_mask(x_lengths, x.shape[1])
    with torch.inference_mode():
        h = gen._encode_text(x, pad, sids, lids)
        return (torch.exp(gen.duration_predictor(h, pad)) - gen.duration_predictor.clip_val).cpu()


def durations_under_the_rule(got, ref, before_ceiling, factor, label):
    """Card against CPU durations: equal, or a token one frame apart where
    one bf16 step moves its ceiling. Returns the items whose durations are
    equal, after printing each token that differs."""
    got, ref = np.asarray(got), np.asarray(ref)
    moved = got != ref
    near = one_step_from_a_ceiling(before_ceiling, factor).numpy()
    for i, j in np.argwhere(moved):
        print(f"    {label}: token ({i}, {j}) {got[i, j]} on the card, {ref[i, j]} on the CPU; "
              f"bf16 duration before the ceiling {float(before_ceiling[i, j])!r} x {factor} "
              f"= {float(before_ceiling[i, j]) * factor!r}; one bf16 step from a ceiling "
              f"{bool(near[i, j])}", flush=True)
    assert np.all(np.abs(got - ref) <= 1) and near[moved].all(), (
        f"{label}: durations differ beyond the rule")
    return ~moved.any(axis=1)


def wav_error(wav, ref):
    """max|wav - ref| / max|ref| and the correlation, over every sample."""
    wav, ref = wav.float().cpu().numpy().ravel(), ref.float().cpu().numpy().ravel()
    return (float(np.abs(wav - ref).max() / np.abs(ref).max()),
            float(np.corrcoef(wav, ref)[0, 1]))


def bf16_synthesis(fc, f32_bench_ms):
    """(a) The flagship, fused, in bf16 on phase 4's weights (seed 0):
    prepare_input -> synthesise, with B1 launching 12 times per decode on
    bf16 x; synthesise_on_device at bench shape, where B1 is held against
    its twin on the bf16 x that the first decoder and the first trunk block
    receive; its wav and the unfused bf16 model's against the f32 model's,
    each decoding the f32 model's encoder outputs (so that all three share
    their durations). Returns B1's launches per decode, the median ms, the
    wav errors and the CPU copy of the weights."""
    from optispeech_tpu_torch.models.modules import convnext
    from optispeech_tpu_torch.models.optispeech import OptiSpeech

    bf16 = torch.bfloat16
    api = OptiSpeech(flagship_config(), seed=0, device="cuda", compute_dtype=bf16)
    seen, captured, wrapper = [], {}, convnext.convnext_block_fused

    def recording(x, *args, **kw):
        seen.append(x.dtype)
        if x.shape[0] == BENCH["batch"]:
            captured.setdefault(x.shape[-1], (x.clone(), args))
        return wrapper(x, *args, **kw)

    convnext.convnext_block_fused = recording
    try:
        fc.convnext_block_fused.launches = 0
        inputs = api.prepare_input(SENTENCE)
        out = api.synthesise(inputs)
        launches = fc.convnext_block_fused.launches
        print(f"  synthesise (bf16, fused): {inputs.x.shape[0]} sentences -> wav "
              f"{out.wav.shape}, latency {out.latency:.2f} ms, rtf {out.rtf:.5f}; B1 launches "
              f"{launches}, x {sorted({str(d) for d in seen})}", flush=True)
        assert np.isfinite(out.wav).all() and out.wav.dtype == np.float32
        assert launches == 12, f"expected 12 B1 launches per bf16 decode, got {launches}"
        assert seen == [bf16] * 12, f"B1 took x in {set(seen)}, not bf16 alone"
        bench, n_frames = bench_inputs(), BENCH["n_frames"]
        fc.convnext_block_fused.launches = 0
        o = api.synthesise_on_device(bench, n_frames)  # warm-up
        torch.cuda.synchronize()
    finally:
        convnext.convnext_block_fused = wrapper
    assert sorted(captured) == [256, 384] and seen == [bf16] * 24
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        o = api.synthesise_on_device(bench, n_frames)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    bench_launches = fc.convnext_block_fused.launches
    assert bench_launches == 12 * 6, f"expected {12 * 6} B1 launches, got {bench_launches}"
    for c, (x, args) in sorted(captured.items()):
        got = fc.convnext_block_fused(x, *args)
        ref = fc.convnext_block_reference(x, *args)
        diff = (got.float() - ref.float()).abs()
        ok = bool((diff <= ATOL + BF16_RTOL * ref.float().abs()).all())
        print(f"  B1 on the model's bf16 x {tuple(x.shape)}: max|kernel - twin| "
              f"{float(diff.max()):.3e} (atol {ATOL}, rtol {BF16_RTOL:.4f}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        assert ok and got.dtype == bf16, f"B1 disagrees with its twin on the model's x at C={c}"
    assert bool(torch.isfinite(o["wav"]).all())
    ms = statistics.median(walls)
    audio_s = float(o["wav_lengths"].sum()) / api.sample_rate
    print(f"  synthesise_on_device at bench shape (bf16, fused): median {ms:.2f} ms over 5 calls "
          f"(min {min(walls):.2f}), {audio_s:.2f} s of audio; phase 4's f32 {f32_bench_ms:.2f} ms "
          f"(observation, not a claim)", flush=True)

    state_dict = {k: v.cpu() for k, v in api.generator.state_dict().items()}
    f32 = OptiSpeech(flagship_config(), device="cuda", state_dict=state_dict)
    unfused = OptiSpeech(flagship_config(fused=False), device="cuda", state_dict=state_dict,
                         compute_dtype=bf16)
    with torch.inference_mode():
        x, x_lengths, sids, lids, d, p, e = f32._tensors(bench)
        enc = f32.generator.encode(x, x_lengths, sids, lids, d, p, e)
        y_lengths = torch.clamp(enc["y_lengths"], max=n_frames)
        args = (enc["durations"], enc["x_mask"], y_lengths, n_frames)
        ref = f32.generator.decode(enc["hidden"], *args)["wav"]
        errors = {name: wav_error(m.generator.decode(enc["hidden"].to(bf16), *args)["wav"], ref)
                  for name, m in (("fused", api), ("unfused", unfused))}
        o32 = f32.synthesise_on_device(bench, n_frames)
    moved = float((o32["durations"] != o["durations"]).float().mean())
    print("  against the f32 model's wav on its encoder outputs (bench shape): "
          + "; ".join(f"{name} bf16 max|d|/max|ref| {rel:.3e}, correlation {corr:.6f}"
                      for name, (rel, corr) in errors.items())
          + f"; the bf16 encoder moves {moved:.2%} of the f32 durations at d_factor "
          f"{BENCH['d_factor']} (observation)", flush=True)
    del api, f32, unfused
    return launches, ms, errors, state_dict


def bf16_cross_device(state_dict):
    """(b) The bf16 flagship on the card and on the CPU (B1's twin), batch 2
    at 256 frames. Returns the CPU model, for phase (d)'s checkpoint."""
    from optispeech_tpu_torch.models.optispeech import OptiSpeech

    apis = {dev: OptiSpeech(flagship_config(), device=dev, state_dict=state_dict,
                            compute_dtype=torch.bfloat16) for dev in ("cuda", "cpu")}
    inputs = apis["cpu"].prepare_input(SENTENCE)
    outs = {dev: a.synthesise_on_device(inputs, 256) for dev, a in apis.items()}
    d_factor = float(inputs.d_factor)
    same = durations_under_the_rule(outs["cuda"]["durations"].cpu(), outs["cpu"]["durations"],
                                    bf16_durations_before_ceiling(apis["cpu"], inputs), d_factor,
                                    "bf16 card against CPU")
    gpu, cpu = outs["cuda"]["wav"].cpu()[same], outs["cpu"]["wav"][same]
    rel = float((gpu - cpu).abs().max() / cpu.abs().max()) if len(cpu) else float("nan")
    print(f"  batch 2, 256 frames, bf16: durations equal on {int(same.sum())} of {len(same)} "
          f"items; their wav max|card - cpu|/max|cpu| {rel:.3e} (rtol {BF16_WAV_RTOL})",
          flush=True)
    assert same.any(), "no item kept its durations between card and CPU"
    assert rel <= BF16_WAV_RTOL, f"bf16 wav differs between card and CPU by {rel}"
    return apis["cpu"]


INFER_CHILD = ("import sys, time; t0 = time.perf_counter(); "
               "from optispeech_tpu_torch.cli import infer; "
               "from optispeech_tpu_torch.ops import fused_convnext as fc; "
               "out = infer.main(sys.argv[1:]); "
               "print('cold', fc.convnext_block_fused.launches, out.latency, "
               "time.perf_counter() - t0)")


def infer_cold(ckpt, out_dir, *flags):
    """`cli/infer.py --fused` on `ckpt` in a fresh process (CUDA, cuDNN and
    the kernels' libraries loaded anew; build/ already holds them). Returns
    its wall s, B1 launches, latency ms and the wavs it wrote."""
    from optispeech_tpu_torch.utils.wavio import load_wav

    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", INFER_CHILD, str(ckpt), SENTENCE, str(out_dir),
                        "--fused", *flags], cwd=Path(__file__).resolve().parent,
                       capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if r.returncode:
        print(r.stdout[-2000:], r.stderr[-4000:], sep="\n")
        raise AssertionError(f"cli/infer.py {' '.join(flags)} failed in a fresh process")
    _, launches, latency, _ = [ln for ln in r.stdout.splitlines() if ln.startswith("cold ")][-1]\
        .split()
    wavs = [load_wav(str(p))[0] for p in sorted(Path(out_dir).glob("gen-*.wav"))]
    return wall, int(launches), float(latency), wavs


def infer_cold_runs(cpu_api):
    """(d) `--fused` and `--bf16 --fused` once each in a fresh process on the
    flagship weights, then `--bf16 --fused --device cpu` here: the bf16 wav
    files card against CPU. In a temporary directory, deleted after."""
    import shutil
    import tempfile

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_bf16_"))
    try:
        cpu_api.save_checkpoint(str(root / "ckpt"))
        runs = {}
        for label, flags in (("--fused", ()), ("--bf16 --fused", ("--bf16",))):
            runs[label] = infer_cold(root / "ckpt", root / label.replace(" ", ""), *flags)
            wall, launches, latency, wavs = runs[label]
            print(f"  cli/infer.py {label}, fresh process: {wall:.2f} s wall, latency "
                  f"{latency:.2f} ms, B1 launches {launches}, {len(wavs)} wavs", flush=True)
            assert launches == 12, f"{label}: expected 12 B1 launches, got {launches}"
        cpu, cpu_wavs = workflow_infer(root / "ckpt", root / "cpu", "--bf16", "--device", "cpu")
        card_wavs = runs["--bf16 --fused"][3]
        hop = flagship_config().generator.features.hop_length
        check_wavs(cpu, card_wavs, hop, "bf16 card")
        check_wavs(cpu, cpu_wavs, hop, "bf16 cpu")
        rel = max(float(np.abs(a - b).max() / np.abs(b).max())
                  for a, b in zip(card_wavs, cpu_wavs))
        print(f"  --bf16 --fused wav files, card against --device cpu: equal lengths, "
              f"max|card - cpu|/max|cpu| {rel:.3e} (rtol {BF16_WAV_RTOL})", flush=True)
        assert rel <= BF16_WAV_RTOL, f"bf16 wav files differ between card and CPU by {rel}"
        return {label: {"wall_s": r[0], "latency_ms": r[2]} for label, r in runs.items()}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def tf32_observation(f32_step_ms):
    """(e) The flagship f32 train step (phase 7's batch) from the same state
    with TF32 off and on (the script's flags only: every float32 conv and
    product, G's and D's), the first step's logs compared, then 3 more
    steps with TF32 on timed. TF32 is off again after."""
    from optispeech_tpu_torch.training.state import init_train_state
    from optispeech_tpu_torch.training.step import make_train_step

    cfg = training_config()
    batch = training_batch(cfg, cfg.data.batch_size, MAS_SHAPE[2], MAS_SHAPE[1], "cuda")
    step, logs, walls = make_train_step(cfg), {}, []
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
            state = init_train_state(cfg, "cuda", seed=0)
            logs[tf32] = {k: float(v) for k, v in step(state, batch).items()}
            torch.cuda.synchronize()
        for _ in range(3):
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    gaps = {k: abs(logs[True][k] - logs[False][k]) / max(abs(logs[False][k]), 1e-12)
            for k in logs[False]}
    worst = sorted(gaps, key=gaps.get, reverse=True)[:3]
    ms = statistics.median(walls)
    print(f"  f32 step with TF32 on: median {ms:.1f} ms over 3 steps (phase 7, TF32 off: "
          f"{f32_step_ms:.1f} ms); first step's logs against TF32 off, largest relative gaps: "
          + ", ".join(f"{k} {gaps[k]:.2e}" for k in worst) + " (observation; the port keeps "
          "TF32 off)", flush=True)
    assert all(np.isfinite(v) for v in logs[True].values())
    return ms, {k: gaps[k] for k in worst}


def bf16_path(fc, mas, f32_bench_ms, f32_step_ms):
    """Phase 15; returns what the kernels line and the summary keep."""
    launches, bench_ms, errors, state_dict = bf16_synthesis(fc, f32_bench_ms)
    cpu_api = bf16_cross_device(state_dict)
    gc.collect()
    torch.cuda.empty_cache()
    mas_launches, walls = train_full_width(fc, mas, compute_dtype="bfloat16")
    train_cross_device(compute_dtype="bfloat16", rtol=BF16_STEP_LOG_RTOL)
    val_launches = val_cross_device(mas, compute_dtype="bfloat16", rtol=BF16_STEP_LOG_RTOL)
    cold = infer_cold_runs(cpu_api)
    del cpu_api
    gc.collect()
    torch.cuda.empty_cache()
    tf32_ms, tf32_gaps = tf32_observation(f32_step_ms)
    return dict(b1_launches_per_decode=launches, bench_ms=bench_ms, wav_errors=errors,
                b3_launches=mas_launches, step_ms=statistics.median(walls[1:]),
                b4_launches=val_launches, cold=cold, tf32_step_ms=tf32_ms, tf32_gaps=tf32_gaps)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from optispeech_tpu_torch.models.optispeech import OptiSpeech
    from optispeech_tpu_torch.ops import _build, mas
    from optispeech_tpu_torch.ops import fused_convnext as fc

    t_start = T0[0] = time.perf_counter()
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
    t_build = time.perf_counter()
    probe = Path(__file__).resolve().parent / "scripts" / "mas_chain.cu"
    built = _build.build_kernels(sources={"mas_chain": probe})
    fused = {"convnext_block": ("B1", fc.PADDED_CHANNELS, fc.kernel_layout),
             "convnext_block_int8": ("B2", fc.INT8_CHANNELS, fc.kernel_layout_int8)}
    for name, info in built.items():
        print(f"  {name}: {info['path']} built in {info['seconds']:.1f} s")
        if name in fused or name == "convnext_block_wide":  # reported below, kernel by kernel
            continue
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")
    build_s = time.perf_counter() - t_build
    print(f"  all kernels built in {build_s:.1f} s (in parallel)")
    ptxas = {name: fused_ptxas(built[name], *spec) for name, spec in fused.items()}
    ptxas["convnext_block_wide"] = wide_ptxas(built["convnext_block_wide"], fc)

    phase("3. kernel check (kernel against twin on the card)")
    max_abs_err = check_kernel(fc, device)
    rows = time_kernel(fc, device)

    phase("4. main path at full width")
    api = OptiSpeech(flagship_config(), seed=0, device="cuda")
    n_params = sum(p.numel() for p in api.generator.parameters())
    print(f"  OptiSpeech(ExperimentConfig(), en-g2p, fused decoder + trunk), seed 0: "
          f"{n_params} parameters", flush=True)
    launches, f32_bench_ms = main_path(fc, mas, api)
    dim192_launches = dim_model(fc, 192)[0]
    dim_wide_launches, wide_launches, taken, n_blocks = dim_model(fc, DIM_WIDE, layers=2)
    assert taken == n_blocks, f"dim {DIM_WIDE}: {n_blocks - taken} blocks ran unfused"

    phase("5. cross-device (card kernel against CPU twin)")
    cross_device(api)
    del api

    phase("6. MAS kernel check (kernel against twin on the card)")
    mas_err = check_mas(mas, device)
    chain_probe = chain_cycles(built["mas_chain"]["path"])
    mas_row = time_mas(mas, device, chain_probe)

    phase("7. training at full width")
    mas_launches, bare_ms = train_full_width(fc, mas)

    phase("8. training cross-device (card kernels against CPU twins)")
    train_cross_device()

    phase("9. extraction MAS kernel check (kernel against twin on the card)")
    ext_err = check_extract(mas, device)
    ext_row = time_extract(mas, device, chain_probe)

    phase("10. the trainer at full width (cli/train.py::run, then a resume)")
    gc.collect()
    torch.cuda.empty_cache()
    trainer_launches = train_entry_point(fc, mas, bare_ms)

    phase("11. validation cross-device (card kernels against CPU twins)")
    val_cross_device(mas)

    phase("12. int8 kernel check (kernel against twin on the card)")
    gc.collect()
    torch.cuda.empty_cache()
    int8_err, int8_frames_outside = check_int8_kernel(fc, device)
    int8_rows = time_int8_kernel(fc, device)

    phase("13. the int8 A/B at its default shape (cli/int8_ab.py::main)")
    ab_launches, ab, ab_f32_err = int8_entry_point(fc)

    phase("14. the user's workflow without JAX (synthcorpus -> preprocess -> stats -> train "
          "-> infer)")
    gc.collect()
    torch.cuda.empty_cache()
    workflow_launches = user_workflow(fc, mas)

    phase("15. the bf16 compute path (synthesis, card against CPU, training, cold cli/infer.py, "
          "TF32)")
    gc.collect()
    torch.cuda.empty_cache()
    bf16 = bf16_path(fc, mas, f32_bench_ms, statistics.median(bare_ms[1:]))

    trunk = rows["trunk"]
    kernel = {
        "name": "convnext_block_fused", "route": "cuda",
        "source": "optispeech_tpu_torch/csrc/convnext_block.cu",
        "replaces": "optispeech_tpu/ops/pallas_convnext.py:224",
        "launches": launches, "launch_path": "phase 4, synthesis",
        "launches_dim192_decode": dim192_launches,
        "launches_phase_14": workflow_launches,
        "launches_bf16_decode": bf16["b1_launches_per_decode"],
        "max_abs_err": max_abs_err["narrow"],
        "ms": trunk["ms"], "plain_ms": trunk["plain_ms"], "bound_ms": trunk["bound_ms"],
        "bound_by": trunk["bound_by"], "library_ms": trunk["library_ms"],
        "wrapper_ms": trunk["wrapper_ms"], "shape": trunk["shape"],
        "other_shapes": [r for w, r in rows.items() if w != "trunk" and r["path"] == "narrow"],
        "ptxas": ptxas["convnext_block"],
    }
    wide = rows["c768"]
    wide_kernel = {
        "name": "convnext_block_fused_wide", "route": "cuda",
        "source": "optispeech_tpu_torch/csrc/convnext_block_wide.cu",
        "replaces": "optispeech_tpu/ops/pallas_convnext.py:224",
        "launches": wide_launches,
        "launch_path": f"phase 4, one decode of the generator.dim {DIM_WIDE} model (2 blocks a stack)",
        "launches_all_paths_of_that_decode": dim_wide_launches,
        "max_abs_err": max_abs_err["wide"],
        "ms": wide["ms"], "plain_ms": wide["plain_ms"], "bound_ms": wide["bound_ms"],
        "bound_by": wide["bound_by"], "library_ms": wide["library_ms"],
        "wrapper_ms": wide["wrapper_ms"], "shape": wide["shape"], "kernels_ms": wide["kernels_ms"],
        "other_shapes": [r for w, r in rows.items() if w != "c768" and r["path"] == "wide"],
        "at_narrow_widths": {w: {k: r[k] for k in ("shape", "ms", "wide_ms", "wide_kernels_ms")}
                             for w, r in rows.items() if "wide_ms" in r},
        "ptxas": ptxas["convnext_block_wide"],
    }
    mas_kernel = {
        "name": "viterbi_decode", "route": "cuda",
        "source": "optispeech_tpu_torch/csrc/mas_wavefront.cu",
        "replaces": "optispeech_tpu/ops/pallas_mas_wavefront.py:152",
        "launches": trainer_launches["viterbi_decode"],
        "launch_path": "phase 10, the trainer (5 steps)", "launches_phase_7": mas_launches,
        "launches_bf16_steps": bf16["b3_launches"],
        "max_abs_err": mas_err["durations"],
        "ms": mas_row["ms"], "plain_ms": mas_row["plain_ms"], "bound_ms": mas_row["bound_ms"],
        "bound_by": mas_row["bound_by"], "library_ms": None, "shape": mas_row["shape"],
        "bin_loss_rel_err": mas_err["bin_loss_rel"], "grad_max_abs_err": mas_err["grad"],
        "chain_floor_ms": mas_row["chain_floor_ms"], "chain_probe": mas_row["chain_probe"],
        "wrapper_ms": mas_row["wrapper_ms"], "ms_2x43x23": mas_row["ms_2x43x23"],
    }
    extract_kernel = {
        "name": "viterbi_decode_extract", "route": "cuda",
        "source": "optispeech_tpu_torch/csrc/mas_extract.cu",
        "replaces": "optispeech_tpu/ops/pallas_mas.py:128",
        "launches": trainer_launches["viterbi_decode_extract"],
        "launch_path": "phase 10, the trainer (1 validation of 1 batch)",
        "launches_bf16_val": bf16["b4_launches"],
        "max_abs_err": ext_err["durations"],
        "ms": ext_row["ms"], "plain_ms": ext_row["plain_ms"], "bound_ms": ext_row["bound_ms"],
        "bound_by": ext_row["bound_by"], "library_ms": None, "shape": ext_row["shape"],
        "binsum_rel_err": ext_err["binsum_rel"], "bin_loss_rel_err": ext_err["bin_loss_rel"],
        "chain_floor_ms": ext_row["chain_floor_ms"], "ms_2x43x12": ext_row["ms_2x43x12"],
        "wrapper_ms": ext_row["wrapper_ms"],
    }
    int8_trunk = int8_rows["trunk"]
    int8_kernel = {
        "name": "convnext_block_fused_int8", "route": "cuda",
        "source": "optispeech_tpu_torch/csrc/convnext_block_int8.cu",
        "replaces": "optispeech_tpu/ops/pallas_convnext.py:149",
        "launches": ab_launches["convnext_block_fused_int8"],
        "launch_path": "phase 13, cli/int8_ab.py::main (batch 32, T 1792)",
        "max_abs_err": int8_err, "frames_outside": int8_frames_outside,
        "ms": int8_trunk["ms"], "plain_ms": int8_trunk["plain_ms"],
        "bound_ms": int8_trunk["bound_ms"], "bound_by": int8_trunk["bound_by"],
        "library_ms": int8_trunk["library_ms"], "wrapper_ms": int8_trunk["wrapper_ms"],
        "wrapper_cached_ms": int8_trunk["wrapper_cached_ms"],
        "shape": int8_trunk["shape"], "other_shapes": [int8_rows["decoder"]],
        "ptxas": ptxas["convnext_block_int8"],
        "ab": {arm: ab[arm] for arm in ("xla_bf16", "fused_bf16", "fused_int8", "oracle_f32")},
        "ab_int8_rel_err_x_f32": ab_f32_err,
    }
    print("\n  bf16: " + json.dumps(bf16))
    print(f"\n  build {build_s:.1f} s; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [kernel, wide_kernel, mas_kernel, extract_kernel, int8_kernel]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
