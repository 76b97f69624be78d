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
     observation: the port keeps TF32 off);
 16. the serving runtime, in a temporary directory outside the checkout
     that is deleted after: (a) phase 4's weights saved with
     `OptiSpeech.save_checkpoint`, loaded by `cli/serve.py::load_model`
     (fused, on the card), `prewarm(max_batch=32)` (each key's seconds) and
     `serve(..., port=0)` on a thread; (b) /health, /info, then 32
     concurrent /synthesise requests of one or two Harvard sentences, 8 in
     each of the four formats: every answer 200 and not truncated, fewer
     batches than requests, B1 12 times per `synthesise_on_device` call
     (the calls counted by wrapping the method, cap-doubling retries
     included); latency p50 / p95, batches, rows, audio seconds per wall
     second and the batcher's wall by stage (`Batcher.stage_seconds`);
     (c) the smallest merged batch of (b) at its frame cap on the card and
     through the CPU model (B1's twin), with pcm16 and with µ-law:
     durations equal, pcm16 within WAV_ATOL plus one step, codes within one
     on fewer than 1% of samples, the packed rows equal the code rows'
     prefixes; (d) /stream of one long sentence (its d_factor set for
     about 760 frames, at least 3 windows) in pcm16 and µ-law with the
     batcher idle: B1 12 times per window, the pcm16 within 64 steps of
     /synthesise's, the µ-law above 25 dB SNR against it, time to the
     first chunk; (e) `load_model(bf16=True)` behind a second server, one
     /synthesise and one /stream of ten sentences: B1 12 times a call and
     a window, on bf16 x, and each sentence whose durations equal the f32
     model's within BF16_WAV_RTOL of the f32 server's answer;
 17. export and replay, in a temporary directory outside the checkout that
     is deleted after: (a) phase 4's weights saved with
     `OptiSpeech.save_checkpoint` go through `cli/export.py` at its default
     ladders (fused, traced on the CPU): the export's wall seconds, the
     graph count (JAX's keys) and the artifact's size; (b) `cli/speak.py`
     on the card writes finite wavs of frames x hop samples, B1 12 times in
     its decode replay; (c) `ExportedOptiSpeech` on the card (through
     `cli/serve.py::load_model`): B1 12 times per decode replay; against
     the live fused model on the card at the same rung and frames and
     against the same artifact on the CPU (B1's twin): durations equal, wav
     within WAV_ATOL; replay latency at each batch rung of the 64-token
     bucket beside the live `synthesise` (observations); (d) the server on
     the artifact: `prewarm` lists every (text bucket x batch rung) key and
     the stream, phase 16(b)'s 32 concurrent requests (B1 12 times per
     decode replay), and /stream at phase 16(d)'s d_factor (B1 12 times per
     window, within 64 steps of the artifact's /synthesise); (e) phase 4's
     bench-shape figure through B1's registered op and with B1 launched
     directly (its binding before it became an op), in turns, beside the
     figure recorded before the op (observations);
 18. the other backbone kinds at full width, for configs/light.yaml,
     transformer.yaml, conformer.yaml and the default with LeanSpeech
     stacks (en-g2p, weights from the port's seeded initialisation, fused:
     the WaveNeXt trunk alone): (a) synthesise_on_device at bench shape,
     median of 5 calls, B1 8 times per decode; the same model on the card
     and on the CPU (B1's twin) on the bench inputs' first OTHER_ROWS rows
     at its 1792 frames: durations equal, wav within WAV_ATOL; (b) phase
     7's training batch, 1 warm-up and 3 timed steps (B3 once per step),
     their median ms and the peak memory; a step and a validation with no
     dropout at phase 8's size on the card and on the CPU from one state:
     durations equal, every log within STEP_LOG_RTOL, B3 and B4 once each
     on the card; (c) for the light config, its weights saved with
     `OptiSpeech.save_checkpoint` and `cli/infer.py --fused` on the card:
     B1 8 times, a finite wav per sentence of frames x hop samples;
 19. the packed data path and the run tools, in a temporary directory
     outside the checkout that is deleted after phase 20: (a) the host collator
     (csrc/packed_dataset.cpp, built by the host compiler in phase 2 beside
     the kernels); (b) phase 10's corpus shape (256 train / 128 val
     synthetic utterances) written as datafiles, `cli/pack.py` on both
     splits (the .pak sizes), the packed loader's first 2 batches of 128
     equal to BucketedCollate's on the same indices, every array bit for
     bit, and one batch's host-collator ms beside the Python path's; (c)
     `cli/train.py::run` at phase 10's config (en-g2p), 3 steps and one
     validation each, from one seed, three ways: the host collator,
     `--device-cache`, and `--device-cache --cache-mel-dtype bfloat16
     --cache-wav-dtype int16`, then the host collator again (a run after
     the same warm-up): B3 once per step, B4 once per val batch, the
     fit step ms, the cache's bytes (`memory_allocated` around the upload),
     and step 1's logs of the float32 cache within STEP_LOG_RTOL of the host
     collator's; (d) `make_cached_scan_step` with K = 2 against two
     `make_cached_train_step` calls from states of one seed, every log
     within STEP_LOG_RTOL; (e) `cli/average.py --last 2 --packed-val
     --compare` on (c)'s float32 cache run (B4 once per val batch in each
     pass, compare.json holding both), then `cli/infer.py --fused` on the
     averaged checkpoint (B1 12 times, finite wavs of frames x hop
     samples); (f) `cli/sweep.py` with 2 trials of 2 steps at test widths on
     the card, each a fresh `cli.train` process that traces its steps with
     torch.profiler (B3 counted by name in the trace), each trial's wall
     seconds;
 20. parallelism (one process per device; the machine has one card, and
     NCCL puts no two ranks of a communicator on one card): (a) `python -m
     torch.distributed.run --standalone --nproc_per_node 1 -m
     optispeech_tpu_torch.cli.train --distributed` on phase 19's config
     and .pak files, 3 steps of batch 128 with a validation and one
     checkpoint (its rank-0 files; the backend must be NCCL), step 1's logs
     within STEP_LOG_RTOL of phase 19's run without a group, the fit step
     beside that run's; a second launch resumes to step 4 and traces it
     with its validation (`--profile-steps 3,4`): B3 once, B4 once per val
     batch, counted by kernel name; (b) one process's step over phase 7's
     128 rows without dropout, then two processes on the one card joined
     over gloo (`init_distributed(backend="gloo")`, CUDA tensors staged
     through the host), 64 rows each: each rank's logs (grad_norm/*
     included) within STEP_LOG_RTOL of the one process's, both ranks'
     parameters after the step equal bit for bit, B3 once per rank, the
     peak memory per rank, and the reducer's ms and MiB per turn (gloo, not
     NCCL);
 21. the configurations not run before, in a temporary directory outside
     the checkout that is deleted after: (a) configs/ljspeech-48k.yaml and
     ljspeech-22k.yaml at the flagship's widths with each file's features
     (en-g2p, seeded weights, fused): synthesise_on_device at bench shape
     (median of 5 calls, B1 12 times per decode), the WaveNeXt head's device
     time alone beside the flagship head's, and the same model on the card
     and on the CPU on the bench inputs' first CONFIG_ROWS rows (durations
     equal, wav within WAV_ATOL); at 48 kHz phase 7's batch (1 warm-up and 3
     timed steps, B3 once per step, the peak per turn) and a step
     and a validation at phase 8's size card against CPU (every log within
     STEP_LOG_RTOL, B3 and B4 once each); at 22.05 kHz that step alone; (b)
     `cli/preprocess.py` and `cli/stats.py` at 48 kHz on RATE_CORPUS
     utterances written at 48 kHz and at configs/kareem.yaml on Arabic rows
     over synthcorpus wavs, the seconds of each, then kareem's synthesis of
     an Arabic sentence at the flagship's widths (B1 12 times); (c)
     scripts/port_campaign.py at configs/campaign-ms.yaml on the card:
     CAMPAIGN_UTTERANCES utterances (a train split above one batch of 128),
     CAMPAIGN_STEPS steps with D from step 1 and one validation (the export at
     CAMPAIGN_LADDERS, smaller than campaign.py's), the training
     stage traced by torch.profiler (B3 once per step, B4 once per val
     batch, counted by name), the speaker check (B1 12 times per synthesise
     call, read from its output), the average, the export, and the artifact
     served to each of the 4 speakers and /stream; each stage's seconds; the
     quality verdict printed as data.
The kernels build in parallel (one nvcc per source, five sources and the
probe), and the host collator beside them.
Prints the kernels' JSON line and the card line, and as its last line
{"ok": true, "device": {...}}. Without a card, or without the repo beside
it, it exits non-zero and prints no result.
"""

import base64
import gc
import io
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
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
# phase 18: the other backbone kinds, each a config and its overrides
OTHER_BACKBONES = {
    "light": ("light", []), "transformer": ("transformer", []),
    "conformer": ("conformer", []),
    "leanspeech": ("default", ["generator.encoder.kind=leanspeech",
                               "generator.decoder.kind=leanspeech"])}
OTHER_ROWS = 4  # phase 18(a): card against CPU on the bench inputs' first rows


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


def bench_inputs(batch=BENCH["batch"]):
    """bench.py's inputs; with `batch` their first rows."""
    from optispeech_tpu_torch.values import InferenceInputs

    rng = np.random.default_rng(0)
    n, b = BENCH["n_tokens"], batch
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
    return cfg if dropout else without_dropout(cfg)


def without_dropout(cfg):
    """`cfg` with every dropout and drop-path rate at 0, the backbones' own
    (attention, positions) included."""
    import dataclasses

    g = cfg.generator
    zero = lambda v: dataclasses.replace(v, dropout=0.0, embed_dropout=0.0)  # noqa: E731
    stack = lambda b: dataclasses.replace(  # noqa: E731
        b, drop_path=0.0, dropout=0.0, attention_dropout_rate=0.0, positional_dropout_rate=0.0)
    g = dataclasses.replace(
        g, text_embedding=dataclasses.replace(g.text_embedding, dropout=0.0),
        encoder=stack(g.encoder), decoder=stack(g.decoder),
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


# -- phase 16: the serving runtime ------------------------------------------------

# (b) 32 concurrent requests, each of one or two Harvard sentences (lists 1-3),
# 8 in each format
HARVARD = [
    "The birch canoe slid on the smooth planks.", "Glue the sheet to the dark blue background.",
    "It's easy to tell the depth of a well.", "These days a chicken leg is a rare dish.",
    "Rice is often served in round bowls.", "The juice of lemons makes fine punch.",
    "The box was thrown beside the parked truck.", "The hogs were fed chopped corn and garbage.",
    "Four hours of steady work faced us.", "A large size in stockings is hard to sell.",
    "The boy was there when the sun rose.", "A rod is used to catch pink salmon.",
    "The source of the huge river is the clear spring.",
    "Kick the ball straight and follow through.",
    "Help the woman get back to her feet.", "A pot of tea helps to pass the evening.",
    "Smoky fires lack flame and heat.", "The soft cushion broke the man's fall.",
    "The salt breeze came across from the sea.", "The girl at the booth sold fifty bonds.",
    "The small pup gnawed a hole in the sock.", "The fish twisted and turned on the bent hook.",
    "Press the pants and sew a button on the vest.", "The swan dive was far short of perfect.",
    "The beauty of the view stunned the young boy.", "Two blue fish swam in the tank.",
    "Her purse was full of useless trash.", "The colt reared and threw the tall rider.",
    "It snowed, rained, and hailed the same morning.", "Read verse out loud for pleasure.",
    "Hoist the load to your left shoulder.", "Take the winding path to reach the lake.",
]
SERVE_REQUESTS = [" ".join(HARVARD[i:i + 1 + i % 2]) for i in range(32)]  # odd i: two sentences
SERVE_FORMATS = ("wav", "pcm16", "mulaw", "json")
SERVE_MAX_BATCH = 32
B1_PER_CALL = 12  # B1 launches per synthesise_on_device call or stream window: 4 decoder + 8 trunk
# (d) one long sentence, its d_factor set so that it fills STREAM_FRAMES frames
# (at least 3 windows of 256, under the server's frame cap of 1024)
STREAM_TEXT = ("A large size in stockings is hard to sell, so the girl at the booth "
               "sold fifty bonds while the small pup gnawed a hole in the sock and the "
               "salt breeze came across from the sea.")
STREAM_FRAMES, STREAM_WINDOWS, STREAM_CHUNK = 760, 3, 256  # the server's default window
STREAM_PCM16_STEPS = 64  # the stream against the batch path, tests/test_serve.py:206
MULAW_SNR_DB = 25.0  # tests/test_serve.py's served µ-law bound
MULAW_CODE_SHARE = 0.01  # codes within one, on fewer than 1% of samples (tests/test_mulaw.py:35-36)
# (e) one request of ten sentences: the bf16 encoder moves a duration of
# ~1% of the tokens against the f32 one (phase 15(a): 9.25% at d_factor 8),
# so a sentence keeps all of its f32 durations only now and then, and the
# wavs compare row by row on the sentences that do, as phase 15(b) does
SERVE_BF16_TEXT = " ".join(HARVARD[:10])


def http_post(base, payload, path="/synthesise"):
    """(status, headers, body, seconds); an HTTP error is an answer, not an exception."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            status, headers, body = resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        status, headers, body = e.code, dict(e.headers), e.read()
    return status, headers, body, time.perf_counter() - t0


def http_get(base, path):
    import urllib.request

    with urllib.request.urlopen(base + path, timeout=60) as r:
        assert r.status == 200, f"GET {path}: {r.status}"
        return json.load(r)


def http_stream(port, payload):
    """POST /stream, reading the transfer chunks one by one. Returns the
    headers, the chunks, the seconds to the first chunk and in all."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/stream", json.dumps(payload).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200, f"/stream answered {resp.status}: {resp.read()[:500]!r}"
        chunks, first = [], None
        while True:
            size = int(resp.fp.readline().strip(), 16)
            if size == 0:
                assert resp.fp.readline() == b"\r\n", "/stream: bad end of the chunked body"
                break
            chunks.append(resp.fp.read(size))
            assert len(chunks[-1]) == size and resp.fp.read(2) == b"\r\n", "/stream: bad chunk"
            first = first or time.perf_counter() - t0
        return dict(resp.headers), chunks, first, time.perf_counter() - t0
    finally:
        conn.close()


def served_audio(fmt, headers, body, sample_rate):
    """The answer's samples: int16 for wav, pcm16 and json, uint8 codes for
    µ-law. Fails on a truncated answer."""
    from scipy.io import wavfile

    if fmt == "json":
        obj = json.loads(body)
        assert obj["truncated"] is False, "a json answer was truncated"
        assert obj["sample_rate"] == sample_rate
        return np.frombuffer(base64.b64decode(obj["pcm16_b64"]), "<i2")
    assert "X-Truncated" not in headers, f"a {fmt} answer was truncated"
    if fmt == "wav":
        assert headers["Content-Type"] == "audio/wav"
        sr, data = wavfile.read(io.BytesIO(body))
        assert sr == sample_rate and data.dtype == np.int16
        return data
    assert int(headers["X-Sample-Rate"]) == sample_rate
    if fmt == "mulaw":
        assert headers["X-Encoding"] == "mulaw"
        return np.frombuffer(body, np.uint8)
    return np.frombuffer(body, "<i2")


def start_server(serve, model, **kw):
    import threading

    httpd = serve.serve(model, host="127.0.0.1", port=0, **kw)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread, f"http://127.0.0.1:{httpd.server_address[1]}"


def stop_server(httpd, thread):
    httpd.shutdown()
    httpd.server_close()
    thread.join(60)
    assert not thread.is_alive(), "the server thread did not stop"
    assert httpd.batcher._thread.is_alive(), "the batcher thread died"


def counted_calls(model):
    """Wrap `model.synthesise_on_device` (the batcher's call, cap-doubling
    retries included) to record each call's inputs, frame cap and wire;
    returns the record and the unwrapped method."""
    calls, original = [], model.synthesise_on_device

    def counted(inputs, n_frames, pcm16=False, mulaw=False):
        calls.append((inputs, n_frames, "mulaw" if mulaw else "pcm16"))
        return original(inputs, n_frames, pcm16=pcm16, mulaw=mulaw)

    model.synthesise_on_device = counted
    return calls, original


def codes_agree(got, ref):
    """(max |code difference|, share of differing codes)."""
    d = np.abs(np.asarray(got).astype(int) - np.asarray(ref).astype(int))
    return int(d.max()), float((d != 0).mean())


def snr_db(ref, got):
    return 10 * np.log10(float((ref ** 2).mean()) / max(float(((got - ref) ** 2).mean()), 1e-12))


def serving_runtime(fc):
    """Phase 16. In a temporary directory, deleted after. Returns what the
    kernels line and the summary keep."""
    import shutil
    import tempfile

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    try:
        return _serving_runtime(fc, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _serving_runtime(fc, root):
    from optispeech_tpu_torch.cli import serve
    from optispeech_tpu_torch.models.optispeech import OptiSpeech

    t_phase = time.perf_counter()
    # (a) phase 4's weights through the user's entry points
    ckpt = str(root / "flagship")
    OptiSpeech(flagship_config(), seed=0, device="cpu").save_checkpoint(ckpt)
    model = serve.load_model(ckpt)
    gen = model.generator
    assert model.device.type == "cuda" and gen.decoder.fused_pallas and gen.vocoder.fused_pallas
    t0 = time.perf_counter()
    warm = serve.prewarm(model, max_batch=SERVE_MAX_BATCH)
    print(f"  (a) load_model (fused, cuda); prewarm(max_batch={SERVE_MAX_BATCH}) in "
          f"{time.perf_counter() - t0:.2f} s: " + ", ".join(f"{k} {v}" for k, v in warm.items()),
          flush=True)
    assert list(warm) == [f"b{n}_{w}" for n in (1, 2, 4, 8, 16, 32) for w in ("pcm16", "mulaw")]
    calls, synthesise = counted_calls(model)
    httpd, thread, base = start_server(serve, model, max_batch=SERVE_MAX_BATCH)
    try:
        out = serving_batches(fc, model, httpd, base, calls)
        out["card_cpu"] = serving_card_against_cpu(ckpt, calls, synthesise)
        out["stream"] = serving_stream(fc, model, httpd, base)
        out["bf16"] = serving_bf16(fc, serve, ckpt, base, synthesise)
    finally:
        stop_server(httpd, thread)
    out["prewarm_s"] = warm
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 16 took {out['phase_s']:.1f} s", flush=True)
    return out


def serving_batches(fc, model, httpd, base, calls, unit="synthesise_on_device call"):
    """(b) /health, /info, then 32 concurrent /synthesise requests in the
    four formats: every answer 200 and whole, fewer batches than requests,
    B1 12 times per `unit` recorded in `calls` (each (inputs, its frame cap
    or batch rung, its wire))."""
    import threading

    health, info = http_get(base, "/health"), http_get(base, "/info")
    print(f"  (b) /health {health}; /info {info}", flush=True)
    assert health["status"] == "ok" and info["sample_rate"] == model.sample_rate
    assert info["max_batch"] == SERVE_MAX_BATCH
    batcher = httpd.batcher
    b0, r0, s0 = batcher.batches_run, batcher.rows_synthesised, dict(batcher.stage_seconds)
    fc.convnext_block_fused.launches = 0
    calls.clear()
    payloads = [{"text": text, "format": SERVE_FORMATS[i % 4]}
                for i, text in enumerate(SERVE_REQUESTS)]
    answers, errors = [None] * len(payloads), []
    start = threading.Barrier(len(payloads) + 1)

    def client(i):
        try:
            start.wait()
            answers[i] = http_post(base, payloads[i])
        except Exception as e:  # reported below: the run fails on it
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(payloads))]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - t0
    launches = fc.convnext_block_fused.launches
    assert not errors and not any(t.is_alive() for t in threads), errors
    bad = [(i, a[0], a[2][:200]) for i, a in enumerate(answers) if a[0] != 200]
    assert not bad, f"non-200 answers: {bad}"
    audio_s, hop = 0.0, model.hop_length
    for p, (_, headers, body, _) in zip(payloads, answers):
        samples = served_audio(p["format"], headers, body, model.sample_rate)
        assert len(samples) > 0 and len(samples) % hop == 0
        audio_s += len(samples) / model.sample_rate
    batches, rows = batcher.batches_run - b0, batcher.rows_synthesised - r0
    stages = {k: batcher.stage_seconds[k] - s0[k] for k in s0}
    busy = sum(stages.values())
    lat = sorted(a[3] * 1e3 for a in answers)
    p50, p95 = float(np.percentile(lat, 50)), float(np.percentile(lat, 95))
    wires = sorted({w for _, _, w in calls})
    t0 = time.perf_counter()  # the handlers' text front end, on one thread
    for p in payloads:
        model.prepare_input(p["text"])
    front_ms = (time.perf_counter() - t0) * 1e3
    print(f"  {len(payloads)} concurrent requests (formats {SERVE_FORMATS} x 8): all 200, none "
          f"truncated; {batches} batches, "
          f"{rows} rows, {len(calls)} {unit}s ({[n for _, n, _ in calls]}, wires {wires}), "
          f"B1 launches {launches}", flush=True)
    print(f"  latency p50 {p50:.1f} ms, p95 {p95:.1f} ms (client wall per request); "
          f"{audio_s:.2f} s of audio in {wall:.3f} s of wall: {audio_s / wall:.1f} s of audio "
          f"per wall second", flush=True)
    print("  batcher wall by stage: " + ", ".join(
        f"{k} {v * 1e3:.1f} ms ({v / busy:.1%})" for k, v in stages.items())
        + f"; the synthesise stage's share {stages['synthesise'] / busy:.1%}; the batcher "
        f"busy {busy * 1e3:.1f} ms of the {wall * 1e3:.1f} ms wall; prepare_input of the 32 "
        f"texts on one thread {front_ms:.1f} ms (the handlers run it under one GIL)", flush=True)
    assert batches < len(payloads), f"{batches} batches for {len(payloads)} requests"
    assert launches == B1_PER_CALL * len(calls), (
        f"expected {B1_PER_CALL * len(calls)} B1 launches for {len(calls)} {unit}s, got {launches}")
    return dict(requests=len(payloads), batches=batches, rows=rows, calls=len(calls),
                b1_launches=launches, latency_p50_ms=p50, latency_p95_ms=p95,
                audio_s_per_wall_s=audio_s / wall, stage_ms={k: v * 1e3 for k, v in
                                                             stages.items()},
                synthesise_share=stages["synthesise"] / busy, batcher_busy_ms=busy * 1e3,
                wall_ms=wall * 1e3, prepare_input_ms=front_ms)


def serving_card_against_cpu(ckpt, calls, synthesise):
    """(c) The smallest merged batch of (b), at its frame cap, on the card
    and through the CPU model (B1's twin), once with pcm16 and once with
    µ-law: durations equal, pcm16 within WAV_ATOL plus one step, codes
    within one on fewer than 1% of the served samples; the card's packed
    rows equal its code rows' prefixes."""
    from optispeech_tpu_torch.cli import serve

    inputs, n_frames, _ = min(calls, key=lambda c: c[0].x.shape[0] * c[1])
    cpu = serve.load_model(ckpt, device="cpu")
    card = synthesise(inputs, n_frames, pcm16=True, mulaw=True)
    card = {k: v.cpu() for k, v in card.items()}
    ref16 = cpu.synthesise_on_device(inputs, n_frames, pcm16=True)
    refmu = cpu.synthesise_on_device(inputs, n_frames, mulaw=True)
    for ref in (ref16, refmu):
        assert torch.equal(card["durations"], ref["durations"]), "durations differ card/CPU"
    lengths = card["wav_lengths"].numpy()
    steps = int(np.ceil(WAV_ATOL * 32767)) + 1
    valid = [slice(0, int(n)) for n in lengths]
    d16 = max(int((card["wav_pcm16"][i, s].int() - ref16["wav_pcm16"][i, s].int()).abs().max())
              for i, s in enumerate(valid))
    got = np.concatenate([card["wav_mulaw"][i, s].numpy() for i, s in enumerate(valid)])
    ref = np.concatenate([refmu["wav_mulaw"][i, s].numpy() for i, s in enumerate(valid)])
    dmu, share = codes_agree(got, ref)
    offs = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    assert np.array_equal(card["wav_offsets"].numpy(), offs), "wav_offsets != cumsum"
    packed = card["wav_mulaw_packed"].numpy()
    assert np.array_equal(packed[: int(lengths.sum())], got), "packed rows != code prefixes"
    assert not packed[int(lengths.sum()):].any(), "the packed buffer is not zero past the total"
    print(f"  (c) card against CPU on the merged batch of {inputs.x.shape[0]} rows at "
          f"{n_frames} frames: durations equal; pcm16 max|card - cpu| {d16} steps (bound "
          f"{steps}); µ-law codes max|d| {dmu}, {share:.3%} differ (bound 1 on < "
          f"{MULAW_CODE_SHARE:.0%}) over {len(got)} samples; packed rows equal", flush=True)
    assert d16 <= steps, f"pcm16 differs card/CPU by {d16} steps"
    assert dmu <= 1 and share < MULAW_CODE_SHARE, f"µ-law codes differ: {dmu}, {share:.3%}"
    return dict(rows=int(inputs.x.shape[0]), n_frames=n_frames, pcm16_steps=d16,
                mulaw_max=dmu, mulaw_share=share)


def stream_d_factor(model, text):
    """The d_factor at which `text` (one sentence) lasts about STREAM_FRAMES
    frames: durations are ceil(d * raw) per token, raw the predictor's."""
    inputs = model.prepare_input(text)
    assert inputs.x.shape[0] == 1
    raw = bf16_durations_before_ceiling(model, inputs)[0, : int(inputs.x_lengths[0])]
    return round(STREAM_FRAMES / float(raw.float().sum()), 2)


def serving_stream(fc, model, httpd, base, d_factor=None, label="(d)"):
    """(d) /stream of one long sentence in pcm16 and µ-law, the batcher
    idle: B1 12 times per window, at least 3 windows; pcm16 within 64
    steps of /synthesise's, µ-law above 25 dB SNR against the pcm16. The
    d_factor is read from the live model unless given."""
    from optispeech_tpu_torch.ops.mulaw import mulaw_decode

    d_factor = d_factor or stream_d_factor(model, STREAM_TEXT)
    payload = {"text": STREAM_TEXT, "d_factor": d_factor}
    port, runs = httpd.server_address[1], {}
    for fmt in ("pcm16", "mulaw"):
        fc.convnext_block_fused.launches = 0
        headers, chunks, first, total = http_stream(port, {**payload, "format": fmt})
        runs[fmt] = dict(launches=fc.convnext_block_fused.launches, chunks=len(chunks),
                         first_s=first, total_s=total, data=b"".join(chunks))
        assert headers["Transfer-Encoding"] == "chunked"
        assert int(headers["X-Sample-Rate"]) == model.sample_rate
        assert (headers.get("X-Encoding") == "mulaw") == (fmt == "mulaw")
    status, headers, body, _ = http_post(base, {**payload, "format": "pcm16"})
    assert status == 200, f"/synthesise answered {status}"
    batch = served_audio("pcm16", headers, body, model.sample_rate).astype(int)
    stream = np.frombuffer(runs["pcm16"]["data"], "<i2").astype(int)
    codes = np.frombuffer(runs["mulaw"]["data"], np.uint8)
    windows = -(-len(stream) // (model.hop_length * STREAM_CHUNK))
    same_length = len(stream) == len(batch)
    diff = int(np.abs(stream - batch).max()) if same_length else None
    at = int(np.abs(stream - batch).argmax()) // model.hop_length if same_length else None
    snr = snr_db(stream / 32767.0, mulaw_decode(codes))
    for fmt, r in runs.items():
        print(f"  {label} /stream {fmt}, d_factor {d_factor}: {len(stream) // model.hop_length} "
              f"frames, {r['chunks']} chunks, first chunk after {r['first_s'] * 1e3:.1f} ms, "
              f"all after {r['total_s'] * 1e3:.1f} ms; B1 launches {r['launches']}", flush=True)
    print(f"  stream against /synthesise: max|d| {diff} steps at frame {at} (bound "
          f"{STREAM_PCM16_STEPS}); "
          f"µ-law stream SNR {snr:.1f} dB against the pcm16 stream (bound {MULAW_SNR_DB})",
          flush=True)
    assert windows >= STREAM_WINDOWS, f"{windows} windows, fewer than {STREAM_WINDOWS}"
    for fmt, r in runs.items():
        assert r["chunks"] == windows, f"{fmt}: {r['chunks']} chunks for {windows} windows"
        assert r["launches"] == B1_PER_CALL * windows, f"{fmt}: {r['launches']} B1 launches"
    assert len(codes) == len(stream) == len(batch), (len(codes), len(stream), len(batch))
    assert diff <= STREAM_PCM16_STEPS, f"the stream differs from /synthesise by {diff} steps"
    assert snr > MULAW_SNR_DB, f"µ-law stream SNR {snr:.1f} dB"
    return dict(d_factor=d_factor, windows=windows, b1_launches=runs["pcm16"]["launches"],
                first_chunk_ms={f: r["first_s"] * 1e3 for f, r in runs.items()},
                total_ms={f: r["total_s"] * 1e3 for f, r in runs.items()}, pcm16_steps=diff,
                mulaw_snr_db=snr)


def row_lengths(synthesise, inputs):
    """Per-row durations and sample counts of `inputs` at the frame cap."""
    out = synthesise(inputs, 1024)
    return out["durations"].cpu(), out["wav_lengths"].cpu().numpy().astype(int)


def split_rows(samples, lengths):
    offs = np.concatenate([[0], np.cumsum(lengths)])
    assert offs[-1] == len(samples), (offs[-1], len(samples))
    return [samples[offs[i]:offs[i + 1]] for i in range(len(lengths))]


def serving_bf16(fc, serve, ckpt, base, synthesise):
    """(e) `load_model(bf16=True)` behind a second server: one /synthesise
    and one /stream of SERVE_BF16_TEXT, B1 12 times a call and a window, on
    bf16 x; each sentence whose durations equal the f32 model's within
    BF16_WAV_RTOL of max|f32 row| against the f32 server's /synthesise."""
    from optispeech_tpu_torch.models.modules import convnext

    bmodel = serve.load_model(ckpt, bf16=True)
    inputs = bmodel.prepare_input(SERVE_BF16_TEXT)
    dur32, len32 = row_lengths(synthesise, inputs)
    dur16, len16 = row_lengths(bmodel.synthesise_on_device, inputs)
    same = [bool(torch.equal(dur32[i], dur16[i])) for i in range(len(len32))]
    moved = int((dur32 != dur16).sum())
    status, headers, body, _ = http_post(base, {"text": SERVE_BF16_TEXT, "format": "pcm16"})
    assert status == 200
    ref = split_rows(served_audio("pcm16", headers, body, bmodel.sample_rate), len32)

    seen, wrapper = [], convnext.convnext_block_fused

    def recording(x, *args, **kw):
        seen.append(x.dtype)
        return wrapper(x, *args, **kw)

    calls, _ = counted_calls(bmodel)
    httpd, thread, bbase = start_server(serve, bmodel)
    convnext.convnext_block_fused = recording
    try:
        status, headers, body, _ = http_post(bbase, {"text": SERVE_BF16_TEXT, "format": "pcm16"})
        assert status == 200, f"bf16 /synthesise answered {status}"
        got = split_rows(served_audio("pcm16", headers, body, bmodel.sample_rate), len16)
        n_synth, n_calls = len(seen), len(calls)
        _, chunks, _, _ = http_stream(httpd.server_address[1], {"text": SERVE_BF16_TEXT})
        streamed = split_rows(np.frombuffer(b"".join(chunks), "<i2"), len16)
    finally:
        convnext.convnext_block_fused = wrapper
        stop_server(httpd, thread)
    def worst(rows):  # max|bf16 - f32| / max|f32| over the sentences that kept their durations
        return max((float(np.abs(g.astype(int) - r.astype(int)).max() / np.abs(r.astype(int)).max())
                    for g, r, s in zip(rows, ref, same) if s), default=float("nan"))

    rel = {"synthesise": worst(got), "stream": worst(streamed)}
    windows = sum(-(-int(n) // (bmodel.hop_length * STREAM_CHUNK)) for n in len16)
    print(f"  (e) bf16 server, one request of {len(same)} sentences: B1 launches {n_synth} in "
          f"/synthesise ({n_calls} calls) and {len(seen) - n_synth} in /stream ({windows} "
          f"windows), x {sorted({str(d) for d in seen})}; the bf16 encoder moved {moved} of "
          f"{int(inputs.x_lengths.sum())} durations, {sum(same)} of {len(same)} sentences kept "
          f"all of them; on those, max|bf16 - f32|/max|f32| against the f32 server's /synthesise: "
          + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()) + f" (rtol {BF16_WAV_RTOL})",
          flush=True)
    assert seen and all(d == torch.bfloat16 for d in seen), f"B1 took x in {set(seen)}"
    assert n_synth == B1_PER_CALL * n_calls, f"{n_synth} B1 launches for {n_calls} calls"
    assert len(seen) - n_synth == B1_PER_CALL * windows, (
        f"{len(seen) - n_synth} B1 launches for {windows} windows")
    assert any(same), "no sentence kept the f32 model's durations in bf16"
    assert all(v <= BF16_WAV_RTOL for v in rel.values()), f"bf16 wav off the f32 server's: {rel}"
    return dict(rows_equal=sum(same), rows=len(same), durations_moved=moved, rel_err=rel,
                b1_launches=len(seen), x_dtype="bfloat16")


# -- phase 17: export and replay ---------------------------------------------------

EXPORT_BUCKETS, EXPORT_RUNGS = (32, 64, 128), (1, 2, 4, 8)  # cli/export.py's default ladders
EXPORT_STREAM_WINDOWS = (304, 352)  # chunk 256 + overlap 48 (the first window), + 2 x 48
REPLAY_BUCKET = 64  # (c) replay latency at each batch rung of this text bucket
# phase 4's bench-shape median in the last run before B1 went through its
# registered op (PERF.md §5; NVIDIA H100 80GB HBM3, 700.00 W): printed beside
# this run's
PRE_OP_BENCH_MS = 18.34


def export_keys():
    """The graph keys of an artifact at cli/export.py's defaults (12 frames
    a token, the flagship's mel bucket of 128)."""
    from optispeech_tpu_torch.utils.bucketing import round_up_to_bucket

    keys = []
    for tb in EXPORT_BUCKETS:
        mb = round_up_to_bucket(tb * 12, 128)
        for nb in EXPORT_RUNGS:
            suffix = "" if nb == 1 else f"_b{nb}"
            keys += [f"encode_{tb}{suffix}", f"decode_{tb}_{mb}{suffix}"]
        keys.append(f"stream_upsample_{tb}_{mb}")
    return sorted(keys + [f"stream_decode_{n}" for n in EXPORT_STREAM_WINDOWS])


def export_replay(fc, stream_d_factor_):
    """Phase 17. In a temporary directory, deleted after. Returns what the
    kernels line and the summary keep."""
    import shutil
    import tempfile

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_export_"))
    try:
        return _export_replay(fc, root, stream_d_factor_)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _export_replay(fc, root, stream_d_factor_):
    from optispeech_tpu_torch.cli import export as export_cli
    from optispeech_tpu_torch.cli import serve

    t_phase = time.perf_counter()
    # (a) phase 4's weights through cli/export.py at its default ladders
    ckpt, art = str(root / "flagship"), str(root / "artifact")
    from optispeech_tpu_torch.models.optispeech import OptiSpeech

    OptiSpeech(flagship_config(), seed=0, device="cpu").save_checkpoint(ckpt)
    t0 = time.perf_counter()
    export_cli.main([ckpt, art])
    export_s = time.perf_counter() - t0
    graphs = sorted(p.stem for p in (root / "artifact" / "graphs").iterdir())
    size = {p.name: p.stat().st_size for p in (root / "artifact").iterdir() if p.is_file()}
    graph_bytes = sum(p.stat().st_size for p in (root / "artifact" / "graphs").iterdir())
    print(f"  (a) cli/export.py on phase 4's weights (fused, traced on the CPU): {len(graphs)} "
          f"graphs in {export_s:.1f} s; artifact {(sum(size.values()) + graph_bytes) / 2**20:.1f} "
          f"MiB: graphs {graph_bytes / 2**20:.2f} MiB, " + ", ".join(
              f"{k} {v / 2**20:.2f} MiB" for k, v in sorted(size.items())), flush=True)
    assert graphs == export_keys(), f"graph keys {graphs}"

    out = dict(export_s=export_s, graphs=len(graphs),
               artifact_mib=(sum(size.values()) + graph_bytes) / 2**20)
    out["speak"] = speak_on_card(fc, art, root / "speak")
    model = serve.load_model(art)  # the card, as the server runs it
    assert model.device.type == "cuda" and type(model).__name__ == "ExportedOptiSpeech"
    out["replay"] = replay_on_card(fc, model, art, ckpt)
    out["serve"] = serve_artifact(fc, serve, model, stream_d_factor_)
    out["bench"] = bench_through_the_op(fc, ckpt)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 17 took {out['phase_s']:.1f} s", flush=True)
    return out


def speak_on_card(fc, art, out_dir):
    """(b) cli/speak.py on the card: finite wavs of frames x hop samples, B1
    12 times per decode replay."""
    from optispeech_tpu_torch.cli import speak
    from optispeech_tpu_torch.utils.wavio import load_wav

    fc.convnext_block_fused.launches = 0
    t0 = time.perf_counter()
    outputs = speak.main([art, SENTENCE, str(out_dir)])
    wall = time.perf_counter() - t0
    launches = fc.convnext_block_fused.launches
    wavs = [load_wav(str(out_dir / f"gen-{i + 1}.wav"))[0] for i in range(len(outputs.wav_lengths))]
    assert sorted(p.name for p in out_dir.iterdir()) == [f"gen-{i + 1}.wav"
                                                        for i in range(len(wavs))]
    check_wavs(outputs, wavs, 256, "cli/speak.py")
    print(f"  (b) cli/speak.py on the card: {len(wavs)} wavs, "
          f"{sum(len(w) for w in wavs) / 24000:.3f} s of audio, finite, frames x hop samples; "
          f"{wall:.2f} s of wall (the artifact's load included), latency {outputs.latency:.2f} ms, "
          f"rtf {outputs.rtf:.5f}; B1 launches {launches}", flush=True)
    assert launches == B1_PER_CALL, f"cli/speak.py: {launches} B1 launches for one decode replay"
    return dict(wall_s=wall, latency_ms=outputs.latency, b1_launches=launches)


def replay_inputs(rows, seed=0):
    """`rows` rows of REPLAY_BUCKET seeded token ids."""
    from optispeech_tpu_torch.values import InferenceInputs

    rng = np.random.default_rng(seed)
    ids = [rng.integers(3, 150, REPLAY_BUCKET).astype(np.int64).tolist() for _ in range(rows)]
    return InferenceInputs.from_ids_and_lengths(ids=ids, lengths=[REPLAY_BUCKET] * rows,
                                                clean_text="replay")


def replay_on_card(fc, card, art, ckpt):
    """(c) ExportedOptiSpeech on the card: B1 12 times per decode replay;
    against the live fused model on the card at the same rung and frame
    count, and against the same artifact on the CPU (B1's twin); replay
    latency at each batch rung of the 64-token bucket beside the live
    model's `synthesise`."""
    from optispeech_tpu_torch.export.exporter import ExportedOptiSpeech
    from optispeech_tpu_torch.models.optispeech import OptiSpeech

    live = OptiSpeech.load_from_checkpoint(ckpt, fused=True)
    cpu = ExportedOptiSpeech(art, device="cpu")
    inputs = card.prepare_input(SENTENCE, split_sentences=True)
    tb = card._text_bucket(inputs.x.shape[1])
    mb = card._decode_buckets(tb, 2)[-1]
    fc.convnext_block_fused.launches = 0
    got = card.synthesise(inputs)
    launches = fc.convnext_block_fused.launches
    assert launches == B1_PER_CALL, f"{launches} B1 launches for one decode replay"
    ref = {k: v.cpu().numpy() for k, v in live.synthesise_on_device(inputs, mb).items()}
    before_cpu = fc.convnext_block_fused.launches
    on_cpu = cpu.synthesise(inputs)
    assert fc.convnext_block_fused.launches == before_cpu, "the CPU replay launched B1"
    lengths = got.wav_lengths
    live_dur = ref["durations"][:, :got.durations.shape[1]]
    live_diff = max(float(np.abs(got.wav[i, :n] - ref["wav"][i, :n]).max())
                    for i, n in enumerate(lengths))
    cpu_diff = float(np.abs(got.wav - on_cpu.wav).max())
    print(f"  (c) ExportedOptiSpeech on the card, {inputs.x.shape[0]} sentences at text bucket "
          f"{tb}, rung 2, {mb} frames: B1 launches {launches} in one decode replay; against the "
          f"live fused model at the same rung and frames: durations equal "
          f"{np.array_equal(got.durations, live_dur)}, wav max|d| {live_diff:.3e}; against the "
          f"artifact on the CPU (B1's twin): durations equal "
          f"{np.array_equal(got.durations, on_cpu.durations)}, wav max|d| {cpu_diff:.3e} (atol "
          f"{WAV_ATOL})", flush=True)
    assert np.array_equal(got.durations, live_dur), "durations differ from the live model's"
    assert np.array_equal(got.wav_lengths, ref["wav_lengths"]), "lengths differ from the live's"
    assert live_diff <= WAV_ATOL, f"the replay differs from the live model by {live_diff}"
    assert np.array_equal(got.durations, on_cpu.durations), "durations differ card/CPU"
    assert np.array_equal(got.wav_lengths, on_cpu.wav_lengths)
    assert cpu_diff <= WAV_ATOL, f"the replay differs card/CPU by {cpu_diff}"
    del cpu

    latency = {}
    for nb in EXPORT_RUNGS:
        rung_inputs = replay_inputs(nb, seed=nb)
        replay, direct = [], []
        for _ in range(6):  # the first of each is a warm-up
            replay.append(card.synthesise(rung_inputs).latency)
            direct.append(live.synthesise(rung_inputs).latency)
        latency[nb] = {"replay_ms": statistics.median(replay[1:]),
                       "live_ms": statistics.median(direct[1:])}
    print("  replay latency (InferenceOutputs.latency, median of 5) at text bucket "
          f"{REPLAY_BUCKET}, each batch rung, beside the live fused model's synthesise on the same "
          "inputs (observations): " + "; ".join(
              f"b{nb} {v['replay_ms']:.2f} / {v['live_ms']:.2f} ms" for nb, v in latency.items()),
          flush=True)
    return dict(b1_launches=launches, live_wav_diff=live_diff, cpu_wav_diff=cpu_diff,
                latency_ms=latency)


def counted_slabs(model):
    """Wrap an artifact's `_synthesise_slab` (one encode and one decode
    replay) to record each slab's rows, batch rung and wire."""
    calls, original = [], model._synthesise_slab

    def counted(inputs, tb, row, count, nb):
        calls.append((inputs, nb, "host"))
        return original(inputs, tb, row, count, nb)

    model._synthesise_slab = counted
    return calls


def serve_artifact(fc, serve, model, stream_d_factor_):
    """(d) cli/serve.py on the artifact: prewarm's keys, phase 16(b)'s 32
    concurrent requests (B1 12 times per decode replay), and one /stream
    at phase 16(d)'s d_factor (B1 12 times per window, within 64 steps of
    the artifact's /synthesise)."""
    t0 = time.perf_counter()
    warm = serve.prewarm(model, max_batch=SERVE_MAX_BATCH)
    print(f"  (d) load_model(ARTIFACT) on the card; prewarm in {time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{k} {v}" for k, v in warm.items()), flush=True)
    assert list(warm) == [f"encode_{tb}_b{nb}" for tb in EXPORT_BUCKETS
                          for nb in EXPORT_RUNGS] + ["stream"], list(warm)
    calls = counted_slabs(model)
    httpd, thread, base = start_server(serve, model, max_batch=SERVE_MAX_BATCH)
    try:
        out = serving_batches(fc, model, httpd, base, calls, unit="decode replay")
        out["stream"] = serving_stream(fc, model, httpd, base, d_factor=stream_d_factor_,
                                       label="   ")
    finally:
        stop_server(httpd, thread)
    out["prewarm_s"] = warm
    return out


def bench_through_the_op(fc, ckpt):
    """(e) phase 4's bench-shape figure after the op change: the live fused
    model's synthesise_on_device through B1's registered op, and with B1
    launched as before it became an op (the wrapper straight to the ctypes
    call), interleaved, 3 rounds of a median of 5 each; printed beside the
    figure recorded before the op. Observations."""
    from optispeech_tpu_torch.models.modules import convnext
    from optispeech_tpu_torch.models.optispeech import OptiSpeech

    api = OptiSpeech.load_from_checkpoint(ckpt, fused=True)
    inputs, n_frames = bench_inputs(), BENCH["n_frames"]
    through_op = convnext.convnext_block_fused

    def direct(x, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma, *, packed=None):
        fc._check_args(x, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma)
        return fc.convnext_block_launch(x, dw, dwb, lnw, lnb, packed, b1, b2, gamma)

    def median_ms():
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            api.synthesise_on_device(inputs, n_frames, pcm16=True)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls)

    arms = {"op": [], "direct": []}
    try:
        for arm in ("op", "direct"):  # warm-up
            convnext.convnext_block_fused = through_op if arm == "op" else direct
            median_ms()
        for _ in range(3):
            for arm in ("op", "direct"):
                convnext.convnext_block_fused = through_op if arm == "op" else direct
                arms[arm].append(median_ms())
    finally:
        convnext.convnext_block_fused = through_op
    ms = {arm: statistics.median(v) for arm, v in arms.items()}
    print(f"  (e) synthesise_on_device at bench shape (phase 4's figure), median of 3 rounds of a "
          f"median of 5: through the op {ms['op']:.2f} ms {[round(v, 2) for v in arms['op']]}, B1 "
          f"launched directly (the binding before the op) {ms['direct']:.2f} ms "
          f"{[round(v, 2) for v in arms['direct']]}; phase 4 before the op: {PRE_OP_BENCH_MS} ms "
          f"(PERF.md; observations)", flush=True)
    return dict(op_ms=ms["op"], direct_ms=ms["direct"], rounds=arms, pre_op_ms=PRE_OP_BENCH_MS)


# -- phase 18: the other backbone kinds -----------------------------------------


def other_config(name):
    """OTHER_BACKBONES[name] as the user loads it, with the en-g2p front end,
    D trained from the first step."""
    from optispeech_tpu_torch.utils.yamlcfg import load_experiment

    base, overrides = OTHER_BACKBONES[name]
    return load_experiment(base, WORKFLOW_CONFIG + overrides + ["train_args.pretraining_steps=0"])


def other_synthesis(fc, mas, name, cfg):
    """(a) Returns the fused model, B1's launches per decode and the bench
    median ms."""
    from optispeech_tpu_torch.models.optispeech import OptiSpeech, with_fused_blocks

    api = OptiSpeech(with_fused_blocks(cfg), seed=0, device="cuda")
    g = api.cfg.generator
    assert not g.decoder.fused_pallas and g.vocoder.fused_pallas
    n_params = sum(p.numel() for p in api.generator.parameters())
    inputs, n_frames = bench_inputs(), BENCH["n_frames"]
    fc.convnext_block_fused.launches = 0
    mas.viterbi_decode.launches = mas.viterbi_decode_extract.launches = 0
    o = api.synthesise_on_device(inputs, n_frames, pcm16=True)  # warm-up
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        o = api.synthesise_on_device(inputs, n_frames, pcm16=True)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = fc.convnext_block_fused.launches
    assert launches == 8 * 6, f"{name}: expected 8 B1 launches per decode, got {launches} in 6"
    assert mas.viterbi_decode.launches == mas.viterbi_decode_extract.launches == 0
    wav = o["wav"]
    assert wav.shape == (BENCH["batch"], n_frames * api.hop_length)
    assert bool(torch.isfinite(wav).all()), f"{name}: non-finite samples"
    ms = statistics.median(walls)
    audio_s = float(o["wav_lengths"].sum()) / api.sample_rate
    print(f"  (a) {name}: encoder/decoder {g.encoder.kind}, {n_params} parameters; "
          f"synthesise_on_device at bench shape: median {ms:.2f} ms over 5 calls (min "
          f"{min(walls):.2f}), {audio_s:.2f} s of audio; B1 {launches // 6} per decode",
          flush=True)

    cpu_api = OptiSpeech(api.cfg, device="cpu",
                         state_dict={k: v.cpu() for k, v in api.generator.state_dict().items()})
    rows = bench_inputs(OTHER_ROWS)
    gpu, cpu = api.synthesise_on_device(rows, n_frames), cpu_api.synthesise_on_device(rows,
                                                                                     n_frames)
    dur_equal = torch.equal(gpu["durations"].cpu(), cpu["durations"])
    wav_diff = float((gpu["wav"].cpu() - cpu["wav"]).abs().max())
    print(f"      card against CPU, {OTHER_ROWS} rows at {n_frames} frames: durations equal "
          f"{dur_equal}; wav max|card - cpu| {wav_diff:.3e} (atol {WAV_ATOL})", flush=True)
    assert dur_equal, f"{name}: durations differ between card and CPU"
    assert wav_diff <= WAV_ATOL, f"{name}: wav differs between card and CPU by {wav_diff}"
    return api, launches // 6, ms


def other_training(mas, name, cfg):
    """(b) Returns the step ms, the peak GiB and the B3 / B4 launches."""
    walls, peak, b3, _ = phase7_steps(mas, name, cfg)
    b3_step, b4 = step_card_against_cpu(mas, name, cfg)
    return statistics.median(walls[1:]), peak, b3 + b3_step, b4


def phase7_steps(mas, name, cfg, label="(b)"):
    """Phase 7's batch on `cfg`: 1 warm-up and 3 timed steps from a seeded
    state; returns their walls, the peak GiB, B3's launches and the peak
    GiB of each turn (G's forward and backward, up to its update; D's, from
    G's update to its own)."""
    from optispeech_tpu_torch.training.state import init_train_state
    from optispeech_tpu_torch.training.step import make_train_step

    state = init_train_state(cfg, "cuda", seed=0)
    t_text, t_mel = MAS_SHAPE[2], MAS_SHAPE[1]
    rows = cfg.data.batch_size
    batch = training_batch(cfg, rows, t_text, t_mel, "cuda")
    step = make_train_step(cfg)
    turns = {"generator": 0.0, "discriminator": 0.0}
    for turn, opt in (("generator", state.g_opt), ("discriminator", state.d_opt)):
        update = opt.update

        def peak_then_update(grads, update=update, turn=turn):
            turns[turn] = max(turns[turn], torch.cuda.max_memory_allocated() / 2 ** 30)
            torch.cuda.reset_peak_memory_stats()
            return update(grads)

        opt.update = peak_then_update
    torch.cuda.reset_peak_memory_stats()
    mas.viterbi_decode.launches = 0
    walls = []
    for i in range(4):
        t0 = time.perf_counter()
        logs = step(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        bad = [k for k, v in logs.items() if not bool(torch.isfinite(v))]
        assert not bad, f"{name} step {i}: non-finite logs {bad}"
    b3 = mas.viterbi_decode.launches
    peak = max(torch.cuda.max_memory_allocated() / 2 ** 30, *turns.values())
    assert b3 == 4, f"{name}: expected one B3 launch per step, got {b3} in 4"
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  {label} {name}: batch {rows}, {t_text} tokens, {t_mel} frames: steps "
          f"{', '.join(f'{w:.1f}' for w in walls)} ms (the first a warm-up), peak memory "
          f"{peak:.2f} GiB; B3 {b3} in 4 steps", flush=True)
    return walls, peak, b3, turns


def step_card_against_cpu(mas, name, cfg, validation=True):
    """A step (and a validation) with no dropout at phase 8's size on the
    card and on the CPU from one state: durations equal, every log
    within STEP_LOG_RTOL; returns B3's launches in the card's step and B4's
    in its validation (None without one)."""
    from optispeech_tpu_torch.training.state import init_train_state
    from optispeech_tpu_torch.training.step import make_train_step, make_val_step

    quiet = without_dropout(cfg)
    places = {"card": "cuda", "cpu": "cpu"}
    states = {tag: init_train_state(quiet, dev, seed=0) for tag, dev in places.items()}
    for part in ("generator", "discriminator"):
        sd = getattr(states["card"], part).state_dict()
        getattr(states["cpu"], part).load_state_dict({k: v.cpu() for k, v in sd.items()})
    batches = {tag: training_batch(quiet, 4, 32, 128, dev, seed=1) for tag, dev in places.items()}
    keys = ("x", "x_lengths", "mel", "mel_lengths", "pitches", "energies")
    durations, logs, val_logs = {}, {}, {}
    mas.viterbi_decode.launches = mas.viterbi_decode_extract.launches = 0
    b3_step = b4 = None
    t0 = time.perf_counter()
    for tag, st in states.items():
        b = batches[tag]
        st.generator.eval()
        with torch.no_grad():
            durations[tag] = st.generator(*[b[k] for k in keys],
                                          start_idx=b["start_idx"])["durations"].cpu()
        before = mas.viterbi_decode.launches
        logs[tag] = make_train_step(quiet)(st, b)
        if tag == "card":
            b3_step = mas.viterbi_decode.launches - before
        if validation:
            val_logs[tag] = make_val_step(quiet)(st, b)[0]
            if tag == "card":
                b4 = mas.viterbi_decode_extract.launches
    cross_s = time.perf_counter() - t0
    dur_equal = torch.equal(durations["card"], durations["cpu"])
    gaps = {}
    for kind, pair in (("train", logs), ("val", val_logs)):
        for k in pair.get("cpu", {}):
            ref = float(pair["cpu"][k])
            gaps[f"{kind} {k}"] = abs(float(pair["card"][k]) - ref) / max(abs(ref), 1e-12)
    worst = max(gaps, key=gaps.get)
    print(f"      card against CPU, batch 4, 32 tokens, 128 frames, no dropout: durations equal "
          f"{dur_equal}; largest relative log gap {gaps[worst]:.2e} ({worst}; rtol "
          f"{STEP_LOG_RTOL}); B3 {b3_step} in the step"
          + (f", B4 {b4} in the validation" if validation else "") + f" ({cross_s:.1f} s)",
          flush=True)
    assert dur_equal, f"{name}: MAS durations differ between card and CPU"
    assert gaps[worst] <= STEP_LOG_RTOL, f"{name}: {worst} differs by {gaps[worst]}"
    assert b3_step == 1 and b4 in (None, 1), f"{name}: B3 {b3_step} / B4 {b4} on the card"
    return b3_step, b4


def other_cli(fc, api):
    """(c) `cli/infer.py --fused` on the card on the light model's weights,
    saved with `OptiSpeech.save_checkpoint`; returns B1's launches."""
    import shutil
    import tempfile

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_light_"))
    try:
        api.save_checkpoint(str(root / "ckpt"))
        fc.convnext_block_fused.launches = 0
        out, wavs = workflow_infer(root / "ckpt", root / "wavs")
        launches = fc.convnext_block_fused.launches
        check_wavs(out, wavs, api.hop_length, "light cli/infer.py --fused")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"  (c) light: cli/infer.py --fused on the card: {len(wavs)} wavs, "
          f"{int(out.durations.sum())} frames, latency {out.latency:.2f} ms; B1 {launches}",
          flush=True)
    assert launches == 8, f"cli/infer.py --fused on the light config: B1 {launches}, not 8"
    return launches


def other_backbones(fc, mas):
    """Phase 18: returns, by config, the bench ms, B1 per decode, the step
    ms, peak GiB and the B3 / B4 launches, and the light CLI's B1."""
    t_phase = time.perf_counter()
    out = {}
    for name in OTHER_BACKBONES:
        t0 = time.perf_counter()
        cfg = other_config(name)
        api, b1, bench_ms = other_synthesis(fc, mas, name, cfg)
        if name == "light":
            out["cli_b1_launches"] = other_cli(fc, api)
        del api
        gc.collect()
        torch.cuda.empty_cache()
        step_ms, peak, b3, b4 = other_training(mas, name, cfg)
        out[name] = dict(bench_ms=bench_ms, b1_launches_per_decode=b1, step_ms=step_ms,
                         peak_gib=peak, b3_launches=b3, b4_launches=b4,
                         seconds=time.perf_counter() - t0)
        gc.collect()
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 18 took {out['phase_s']:.1f} s", flush=True)
    return out


# phase 19: the packed data path and the run tools on phase 10's corpus shape
PACKED_STEPS = 3  # per run of (c); checkpoints at steps 2 and 3, the two (e) averages
# the host collator's run twice, first and last, so that the cache's runs are
# compared with a run after the same warm-up
PACKED_RUNS = {"packed": [], "cache": ["--device-cache"],
               "cache_bf16_int16": ["--device-cache", "--cache-mel-dtype", "bfloat16",
                                    "--cache-wav-dtype", "int16"], "packed_again": []}
COLLATE_BATCHES = 2  # (b): the loader's first batches, held against BucketedCollate
COLLATE_KEYS = ("x", "wav", "mel", "pitches", "energies", "x_lengths", "mel_lengths",
                "wav_lengths")
# (f): trials at test widths (tests/test_torch_trainer.py's CLI_OVERRIDES), on the card
SWEEP_TRIALS, SWEEP_STEPS = 2, 2
SWEEP_OVERRIDES = [
    "data.batch_size=4", "data.text_bucket_size=16", "data.mel_bucket_size=64",
    "data.max_text_len=16", "data.max_mel_len=64", "data.features.n_feats=20",
    "data.features.n_fft=256", "data.features.hop_length=64", "data.features.win_length=256",
    "generator.dim=32", "generator.segment_size=16",
    "generator.encoder.intermediate_dim=64", "generator.encoder.num_layers=2",
    "generator.decoder.intermediate_dim=64", "generator.decoder.num_layers=2",
    "generator.vocoder.dim=48", "generator.vocoder.intermediate_dim=96",
    "generator.vocoder.num_layers=2", "discriminator.periods=[2, 3]",
    "discriminator.resolutions=[[256, 64, 256]]", "discriminator.mrd_channels=16",
    "train_args.pretraining_steps=0", f"val_every_n_steps={SWEEP_STEPS}", "log_every_n_steps=1"]
SWEEP_TRAIN_ARGS = ["--synthetic", "--max-steps", str(SWEEP_STEPS), "--profile-steps",
                    f"0,{SWEEP_STEPS - 1}"]
B3_KERNEL = "mas_wavefront_kernel"  # csrc/mas_wavefront.cu's __global__, as the trace names it
PACKED_DEVICE = "cuda"  # phase 19's device; left implicit where it is an entry point's default


def packed_config():
    """Phase 10's trainer config with the en-g2p front end (so that
    cli/infer.py reads its checkpoints), a log every step, one validation at
    the last step and a checkpoint every other step."""
    import dataclasses

    cfg = training_config()
    tp = dataclasses.replace(cfg.data.text_processor, tokenizer="en-g2p")
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, text_processor=tp),
                               log_every_n_steps=1, val_every_n_steps=PACKED_STEPS,
                               ckpt_every_n_steps=2)


def write_datafiles(root, name, n, seed, cfg):
    """Phase 10's synthetic utterances written as datafiles (a .json and a
    .npz each) with a filelist; returns the filelist's path."""
    from optispeech_tpu_torch.data.datamodule import SyntheticDataset

    feats = cfg.generator.features
    ds = SyntheticDataset(n_items=n, n_feats=feats.n_feats, hop_length=feats.hop_length,
                          seed=seed, text_range=TEXT_RANGE, mel_range=MEL_RANGE)
    (root / name).mkdir()
    paths = []
    for i, item in enumerate(ds.items):
        base = root / name / f"utt{i:04d}"
        base.with_suffix(".json").write_text(json.dumps(
            {"phoneme_ids": item["x"].tolist(), "text": item["text"]}))
        np.savez(base.with_suffix(".npz"), wav=item["wav"], mel=item["mel"],
                 energy=item["energy"], pitch=item["pitch"])
        paths.append(str(base))
    filelist = root / f"{name}.txt"
    filelist.write_text("\n".join(paths) + "\n")
    return filelist


def pack_and_collate(root, cfg):
    """(b): cli/pack.py on both splits; the packed loader's first batches
    against BucketedCollate on the same indices (exactly equal), and one
    batch's host-collator and Python times. Returns the two .pak paths and
    the numbers."""
    from optispeech_tpu_torch.cli import pack
    from optispeech_tpu_torch.data.datamodule import BucketedCollate, TextWavDataset
    from optispeech_tpu_torch.data.packed import PackedDataset, PackedLoader

    t0 = time.perf_counter()
    lists = {"train": write_datafiles(root, "train", TRAIN_ITEMS, 0, cfg),
             "val": write_datafiles(root, "val", VAL_ITEMS, 1, cfg)}
    t1 = time.perf_counter()
    paks = {}
    for split, filelist in lists.items():
        paks[split] = root / f"{split}.pak"
        assert pack.main([str(filelist), str(paks[split]), *WORKFLOW_CONFIG]) == 0
    t2 = time.perf_counter()
    sizes = {split: p.stat().st_size for split, p in paks.items()}
    print(f"  datafiles: {TRAIN_ITEMS} train / {VAL_ITEMS} val utterances in {t1 - t0:.1f} s; "
          f"cli/pack.py: train.pak {sizes['train'] / 2 ** 20:.1f} MiB, val.pak "
          f"{sizes['val'] / 2 ** 20:.1f} MiB in {t2 - t1:.1f} s", flush=True)

    d, feats = cfg.data, cfg.generator.features
    ds = PackedDataset(str(paks["train"]), d.statistics, f_min=feats.f_min)
    assert (ds.n_feats, ds.hop_length) == (feats.n_feats, feats.hop_length)
    loader = PackedLoader(ds, d.batch_size, d.text_bucket_size, d.mel_bucket_size, shuffle=True,
                          seed=d.seed, max_text_len=d.max_text_len, max_mel_len=d.max_mel_len)
    items = TextWavDataset(str(lists["train"]), f_min=feats.f_min)  # the filelist's order
    collate = BucketedCollate(n_feats=feats.n_feats, statistics=d.statistics,
                              hop_length=feats.hop_length, text_bucket=d.text_bucket_size,
                              mel_bucket=d.mel_bucket_size, max_text_len=d.max_text_len,
                              max_mel_len=d.max_mel_len)
    order = loader._batch_indices()[:COLLATE_BATCHES]
    for bat, got in zip(order, loader):
        want = collate([items[int(i)] for i in bat])
        bad = [k for k in COLLATE_KEYS if got[k].shape != want[k].shape
               or not np.array_equal(got[k], want[k])]
        assert not bad, f"the host collator differs from BucketedCollate in {bad}"
    bat = order[0]
    args = (d.text_bucket_size, d.mel_bucket_size, d.max_text_len, d.max_mel_len)
    native = []
    for _ in range(7):
        t0 = time.perf_counter()
        ds.assemble(bat, *args)
        native.append(1e3 * (time.perf_counter() - t0))
    read, collated = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        batch = [items[int(i)] for i in bat]
        t1 = time.perf_counter()
        collate(batch)
        t2 = time.perf_counter()
        read.append(1e3 * (t1 - t0))
        collated.append(1e3 * (t2 - t1))
    out = {"pak_bytes": sizes, "native_ms": statistics.median(native),
           "python_read_ms": statistics.median(read),
           "python_collate_ms": statistics.median(collated)}
    print(f"  the loader's first {COLLATE_BATCHES} batches of {d.batch_size} equal "
          f"BucketedCollate's on the same indices, every array bit for bit", flush=True)
    print(f"  one batch of {d.batch_size}: host collator (8 threads) {out['native_ms']:.2f} ms "
          f"(median of 7); the Python path {out['python_read_ms'] + out['python_collate_ms']:.2f} "
          f"ms (median of 3: datafile reads {out['python_read_ms']:.2f} + BucketedCollate "
          f"{out['python_collate_ms']:.2f})", flush=True)
    return paks, out


def packed_runs(fc, mas, root, paks, cfg):
    """(c): cli/train.py::run three ways from one seed; returns per run the
    fit step ms, the launches, the cache's bytes and the step-1 logs, and
    keeps the float32 cache run's directory and cache for (d) and (e)."""
    from optispeech_tpu_torch.cli import train as cli

    out = {}
    n_val_batches = -(-VAL_ITEMS // cfg.data.batch_size)
    for name, flags in PACKED_RUNS.items():
        gc.collect()
        torch.cuda.empty_cache()
        args = cli.parse_args(["--device", PACKED_DEVICE, "--out-dir", str(root / name),
                               "--max-steps", str(PACKED_STEPS), "--packed-train",
                               str(paks["train"]), "--packed-val", str(paks["val"]),
                               "--no-print-config", *flags])
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        train, val = cli.build_packed_loaders(
            cfg, args.packed_train, args.packed_val, device_cache=args.device_cache,
            device=PACKED_DEVICE, cache_mel_dtype=args.cache_mel_dtype,
            cache_wav_dtype=args.cache_wav_dtype)
        torch.cuda.synchronize()
        loaders_s, mem1 = time.perf_counter() - t0, torch.cuda.memory_allocated()
        for counted in (fc.convnext_block_fused, mas.viterbi_decode, mas.viterbi_decode_extract):
            counted.launches = 0
        t0 = time.perf_counter()
        _, state = cli.run(cfg, args, train_loader=train, val_loader=val)
        run_s = time.perf_counter() - t0
        rows = [json.loads(x) for x in (root / name / "metrics.jsonl").read_text().splitlines()]
        fit_ms = {r["step"]: 1e3 / r["perf/steps_per_sec"] for r in rows
                  if "perf/steps_per_sec" in r}
        val_rows = [r for r in rows if "total_loss/val_total" in r]
        step1 = next(r for r in rows if r["step"] == 1 and "total_loss/generator" in r)
        run = {"b3": mas.viterbi_decode.launches, "b4": mas.viterbi_decode_extract.launches,
               "b1": fc.convnext_block_fused.launches, "fit_ms": fit_ms, "run_s": run_s,
               "loaders_s": loaders_s, "cache_bytes_allocated": mem1 - mem0,
               "arena_bytes": getattr(getattr(train, "cache", None), "arena_bytes", 0),
               "step1": {k: v for k, v in step1.items() if not k.startswith("perf/")},
               "val_total": val_rows[0]["total_loss/val_total"] if val_rows else None}
        print(f"  ({name}) {' '.join(flags) or 'the host collator'}: loaders in "
              f"{loaders_s:.2f} s, the cache's arenas {run['arena_bytes'] / 2 ** 20:.1f} MiB "
              f"(memory_allocated {mem0 / 2 ** 20:.1f} -> {mem1 / 2 ** 20:.1f} MiB); run() "
              f"{run_s:.1f} s; fit step ms (perf/steps_per_sec) "
              + ", ".join(f"{k}: {v:.1f}" for k, v in fit_ms.items())
              + f"; val_total {run['val_total']}; B3 {run['b3']}, B4 {run['b4']}, "
              f"B1 {run['b1']}", flush=True)
        bad = [(r["step"], k) for r in rows for k, v in r.items() if not np.isfinite(v)]
        assert not bad, f"{name}: non-finite logged values at {bad}"
        assert state.step == PACKED_STEPS and len(val_rows) == 1, f"{name}: steps or validation"
        assert run["b3"] == PACKED_STEPS, f"{name}: B3 {run['b3']}, not one per step"
        assert run["b4"] == n_val_batches, f"{name}: B4 {run['b4']}, not one per val batch"
        assert run["b1"] == 0, f"{name}: B1 launched in training"
        if name == "cache":
            out["cache_obj"], out["cache_dir"] = train.cache, root / name
        out[name] = run
        del state, train, val
    host, cached = out["packed"]["step1"], out["cache"]["step1"]
    assert set(host) == set(cached)
    gaps = {k: abs(cached[k] - host[k]) / max(abs(host[k]), 1e-12) for k in host if k != "step"}
    worst = max(gaps, key=gaps.get)
    print(f"  step 1, --device-cache against the host collator: largest relative log gap "
          f"{gaps[worst]:.2e} ({worst}; rtol {STEP_LOG_RTOL})", flush=True)
    assert gaps[worst] <= STEP_LOG_RTOL, f"{worst}: cached step 1 differs by {gaps[worst]}"
    out["step1_gap"] = gaps[worst]
    return out


def scan_against_steps(mas, cfg, cache):
    """(d): make_cached_scan_step with K = 2 against two
    make_cached_train_step calls, each from a state made from one seed."""
    import itertools

    from optispeech_tpu_torch.data.device_cache import DeviceCacheLoader
    from optispeech_tpu_torch.ops.segments import host_sample_segment_starts
    from optispeech_tpu_torch.training.state import init_train_state
    from optispeech_tpu_torch.training.step import make_cached_scan_step, make_cached_train_step

    d = cfg.data
    light = list(itertools.islice(DeviceCacheLoader(cache, d.batch_size, d.text_bucket_size,
                                                    d.mel_bucket_size, shuffle=True, seed=3), 2))
    t_text, t_mel = max(b["t_text"] for b in light), max(b["t_mel"] for b in light)
    rng = np.random.default_rng(0)
    seg = min(cfg.generator.segment_size, t_mel)
    idx_start = torch.from_numpy(np.stack([
        np.stack([b["idx"], host_sample_segment_starts(rng, b["mel_lengths"], seg)], axis=1)
        for b in light]).astype(np.int32)).to(PACKED_DEVICE)
    mas.viterbi_decode.launches = 0
    seq = init_train_state(cfg, PACKED_DEVICE, seed=0)
    one = make_cached_train_step(cfg, cache)
    seq_logs = [one(seq, idx_start[k], t_text=t_text, t_mel=t_mel) for k in range(2)]
    del seq
    gc.collect()
    torch.cuda.empty_cache()
    scanned = init_train_state(cfg, PACKED_DEVICE, seed=0)
    logs_k = make_cached_scan_step(cfg, cache)(scanned, idx_start, t_text=t_text, t_mel=t_mel)
    launches = mas.viterbi_decode.launches
    gaps = {(k, i): abs(float(logs_k[k][i]) - float(seq_logs[i][k]))
            / max(abs(float(seq_logs[i][k])), 1e-12) for k in logs_k for i in range(2)}
    worst = max(gaps, key=gaps.get)
    print(f"  K = 2 batches of {d.batch_size} at ({t_text}, {t_mel}): the scan against two "
          f"steps, largest relative log gap {gaps[worst]:.2e} ({worst}; rtol {STEP_LOG_RTOL}); "
          f"B3 {launches}", flush=True)
    assert scanned.step == 2 and all(v.shape == (2,) for v in logs_k.values())
    assert gaps[worst] <= STEP_LOG_RTOL, f"scan {worst} differs by {gaps[worst]}"
    assert launches == 4, f"B3 {launches} over the two steps and the scan of two, not 4"
    del scanned
    return {"gap": gaps[worst], "b3": launches}


def average_run(fc, mas, root, run_dir, paks, cfg):
    """(e): cli/average.py --last 2 --packed-val --compare (on the card by
    default), then cli/infer.py --fused on the averaged checkpoint."""
    from optispeech_tpu_torch.cli import average

    device = [] if PACKED_DEVICE == "cuda" else ["--device", PACKED_DEVICE]
    for counted in (fc.convnext_block_fused, mas.viterbi_decode, mas.viterbi_decode_extract):
        counted.launches = 0
    t0 = time.perf_counter()
    assert average.main([str(run_dir), "--last", "2", "--packed-val", str(paks["val"]),
                         "--compare", *device]) == 0
    avg_s = time.perf_counter() - t0
    b4, b3 = mas.viterbi_decode_extract.launches, mas.viterbi_decode.launches
    compare = json.loads((run_dir / "avg_eval" / "compare.json").read_text())
    n_val_batches = -(-VAL_ITEMS // cfg.data.batch_size)
    print(f"  cli/average.py --last 2 --packed-val --compare: steps {compare['averaged_steps']} "
          f"in {avg_s:.1f} s; val_total newest {compare['last']['total_loss/val_total']:.4f}, "
          f"averaged {compare['averaged']['total_loss/val_total']:.4f}; B4 {b4}, B3 {b3}",
          flush=True)
    assert compare["averaged_steps"] == [2, PACKED_STEPS], compare["averaged_steps"]
    assert all(np.isfinite(compare[k]["total_loss/val_total"]) for k in ("last", "averaged"))
    assert b4 == 2 * n_val_batches, f"B4 {b4}, not one per val batch in each of two passes"
    assert b3 == 0, f"B3 launched {b3} times in validation"
    fc.convnext_block_fused.launches = 0
    out, wavs = workflow_infer(run_dir / "avg_ckpt", root / "avg_wavs", *device)
    b1 = fc.convnext_block_fused.launches
    check_wavs(out, wavs, cfg.generator.features.hop_length, "the averaged checkpoint")
    print(f"  cli/infer.py --fused on the averaged checkpoint: {len(wavs)} wavs, "
          f"{int(out.durations.sum())} frames, latency {out.latency:.2f} ms; B1 {b1}", flush=True)
    assert b1 == 12, f"B1 {b1} per synthesise of the averaged checkpoint, not 12"
    return {"b4": b4, "b1": b1, "seconds": avg_s,
            "val_total": {k: compare[k]["total_loss/val_total"] for k in ("last", "averaged")}}


def b3_in_trace(trace_path, kernel=None) -> int:
    """The launches of B3 (or of `kernel`, by name) in a torch.profiler trace."""
    events = json.loads(Path(trace_path).read_text()).get("traceEvents", [])
    return sum(1 for e in events if str(e.get("cat", "")).lower() == "kernel"
               and (kernel or B3_KERNEL) in str(e.get("name", "")))


def sweep_run(root):
    """(f): cli/sweep.py with 2 trials of 2 steps at test widths, each a
    cli.train subprocess on the card (build/ populated) that traces its two
    steps; returns each trial's wall seconds, objective and B3 count."""
    from optispeech_tpu_torch.cli import sweep

    spec = {"base_config": "default", "trials": SWEEP_TRIALS, "seed": 0,
            "objective": "total_loss/val_total", "direction": "min",
            "train_args": SWEEP_TRAIN_ARGS, "overrides": SWEEP_OVERRIDES,
            "space": {"optimizer.lr": {"log_uniform": [1e-5, 1e-3]}}}
    (root / "spec.yaml").write_text(json.dumps(spec))  # JSON is YAML
    seconds = []
    run_trial = sweep.run_trial

    def timed(*a, **kw):  # each trial's wall seconds
        t0 = time.perf_counter()
        try:
            return run_trial(*a, **kw)
        finally:
            seconds.append(time.perf_counter() - t0)

    sweep.run_trial = timed
    try:
        best = sweep.main([str(root / "spec.yaml"), "--out-dir", str(root / "sweep")])
    finally:
        sweep.run_trial = run_trial
    rows = [json.loads(x)
            for x in (root / "sweep" / "sweep_results.jsonl").read_text().splitlines()]
    b3 = [b3_in_trace(Path(r["out_dir"]) / "profile" / "trace.json") for r in rows]
    for r, s, n in zip(rows, seconds, b3):
        print(f"  trial {r['trial']}: lr {r['params']['optimizer.lr']:.3e}, return code "
              f"{r['returncode']}, objective {r['objective']}, wall {s:.1f} s (a fresh process), "
              f"B3 kernels in its trace of {SWEEP_STEPS} steps: {n}", flush=True)
    print(f"  best trial {best['trial']} (objective {best['objective']})", flush=True)
    assert len(rows) == SWEEP_TRIALS and all(r["returncode"] == 0 for r in rows), rows
    assert all(r["objective"] is not None and np.isfinite(r["objective"]) for r in rows), rows
    assert all(n == SWEEP_STEPS for n in b3), f"B3 in the trials' traces: {b3}"
    return {"trial_s": seconds, "b3": b3, "best": best["trial"],
            "objectives": [r["objective"] for r in rows]}


def packed_path(fc, mas, host_build, root):
    """Phase 19 in `root`, a temporary directory outside the checkout that
    main deletes after phase 20 (which trains on its .pak files). Returns
    the phase's numbers, and what phase 20 takes from it: the .pak paths,
    the config, and the host collator's runs' step-1 logs and fit steps."""
    t_phase = time.perf_counter()
    print(f"  (a) the host collator: {host_build['path']} built in "
          f"{host_build['seconds']:.1f} s in phase 2, beside the kernels", flush=True)
    cfg = packed_config()
    print("  (b) pack and collate", flush=True)
    paks, collate = pack_and_collate(root, cfg)
    print(f"  (c) cli/train.py::run three ways (the first again last), {PACKED_STEPS} "
          f"steps each, batch "
          f"{cfg.data.batch_size}, one validation", flush=True)
    runs = packed_runs(fc, mas, root, paks, cfg)
    print("  (d) the scan of K = 2 against two cached steps", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    scan = scan_against_steps(mas, cfg, runs.pop("cache_obj"))
    gc.collect()
    torch.cuda.empty_cache()
    print("  (e) average", flush=True)
    avg = average_run(fc, mas, root, runs.pop("cache_dir"), paks, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    print("  (f) sweep", flush=True)
    sweep = sweep_run(root)
    handed = {"paks": paks, "cfg": cfg, "step1": runs["packed"]["step1"],
              "fit_ms": {name: runs[name]["fit_ms"] for name in ("packed", "packed_again")}}
    out = {"host_build_s": host_build["seconds"], "collate": collate,
           "runs": {k: {m: v[m] for m in ("b3", "b4", "b1", "fit_ms", "run_s", "loaders_s",
                                          "cache_bytes_allocated", "arena_bytes", "val_total")}
                    for k, v in runs.items() if k in PACKED_RUNS},
           "step1_gap": runs["step1_gap"], "scan": scan, "average": avg, "sweep": sweep,
           "phase_s": time.perf_counter() - t_phase}
    print(f"  phase 19 took {out['phase_s']:.1f} s", flush=True)
    return out, handed


# phase 20: parallelism (one process per device; the machine has one card)
PARALLEL_STEPS = 3  # (a): the first launch's steps; the second resumes to PARALLEL_STEPS + 1
PARALLEL_ROWS = 128  # (b): phase 7's batch, as 2 ranks x 64
PARALLEL_TIMEOUT_S = 120  # a collective that waits longer raises
LAUNCH_LIMIT_S = 300  # one launch of cli/train.py, start to end
PARALLEL_DEVICE = "cuda:0"  # (b): both ranks' device
B4_KERNEL = "mas_extract_kernel"  # csrc/mas_extract.cu's __global__, as the trace names it
BACKEND = re.compile(r"process group: backend (\w+), rank (\d+) of (\d+), device (\S+)")


def launch_train(root, name, cfg, paks, steps, *flags):
    """`python -m torch.distributed.run --standalone --nproc_per_node 1 -m
    optispeech_tpu_torch.cli.train --distributed` on `cfg` (written as YAML)
    and phase 19's .pak files, into root/name; returns (the launch's wall
    seconds, its output)."""
    import yaml

    from optispeech_tpu_torch.config import to_dict

    cfg_path = root / f"{name}-{steps}.yaml"
    # YAML 1.1 reads JSON's 1e-08 as a string: yaml writes it as 1.0e-08
    cfg_path.write_text(yaml.safe_dump(json.loads(json.dumps(to_dict(cfg)))))
    repo = Path(__file__).resolve().parent
    # the CLI leaves PyTorch's TF32 defaults (cuDNN's convolutions in TF32):
    # NVIDIA's libraries read this variable and keep float32, as phase 1 does here
    env = {**os.environ, "NVIDIA_TF32_OVERRIDE": "0", "PYTHONPATH": os.pathsep.join(
        [str(repo)] + [v for v in [os.environ.get("PYTHONPATH")] if v])}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "1", "-m", "optispeech_tpu_torch.cli.train", "--distributed", "--config",
           str(cfg_path), "--out-dir", str(root / name), "--max-steps", str(steps),
           "--packed-train", str(paks["train"]), "--packed-val", str(paks["val"]),
           "--dist-timeout", str(PARALLEL_TIMEOUT_S), "--no-print-config", *flags]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=repo, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=LAUNCH_LIMIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"{name}: the launch ran past {LAUNCH_LIMIT_S} s; killed")
    seconds = time.perf_counter() - t0
    assert proc.returncode == 0, f"{name}: return code {proc.returncode}\n{out[-6000:]}"
    return seconds, out


def one_rank_nccl(root, handed):
    """(a): cli/train.py --distributed on one rank under NCCL, PARALLEL_STEPS
    steps with a validation and one checkpoint, then a second launch that
    resumes to PARALLEL_STEPS + 1 and traces that step and its validation;
    step 1 against phase 19's run without a group."""
    import dataclasses

    cfg = dataclasses.replace(handed["cfg"], val_every_n_steps=PARALLEL_STEPS,
                              ckpt_every_n_steps=100 * PARALLEL_STEPS)
    first_s, out = launch_train(root, "nccl", cfg, handed["paks"], PARALLEL_STEPS)
    backend = BACKEND.findall(out)
    assert backend == [("nccl", "0", "1", "cuda:0")], backend
    run = root / "nccl"
    ckpt = sorted(p.name for p in (run / "checkpoints").iterdir())
    state = torch.load(run / "checkpoints" / str(PARALLEL_STEPS) / "state.pt",
                       map_location="cpu", weights_only=True)
    rows = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    fit_ms = {r["step"]: 1e3 / r["perf/steps_per_sec"] for r in rows if "perf/steps_per_sec" in r}
    step1 = next(r for r in rows if r["step"] == 1 and "total_loss/generator" in r)
    step1 = {k: v for k, v in step1.items() if not k.startswith("perf/")}
    want = handed["step1"]
    assert set(step1) == set(want), set(step1) ^ set(want)
    gaps = {k: abs(step1[k] - want[k]) / max(abs(want[k]), 1e-12) for k in want if k != "step"}
    worst = max(gaps, key=gaps.get)
    resumed = dataclasses.replace(cfg, val_every_n_steps=PARALLEL_STEPS + 1)
    second_s, out2 = launch_train(root, "nccl", resumed, handed["paks"], PARALLEL_STEPS + 1,
                                  "--profile-steps", f"{PARALLEL_STEPS},{PARALLEL_STEPS + 1}")
    trace = run / "profile" / "trace.json"
    b3, b4 = b3_in_trace(trace), b3_in_trace(trace, B4_KERNEL)
    b1 = b3_in_trace(trace, "convnext_block_kernel")
    rows = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    n_val = -(-VAL_ITEMS // cfg.data.batch_size)
    vals = [r["step"] for r in rows if "total_loss/val_total" in r]
    print(f"  (a) backend {backend[0][0]}, rank 0 of 1 on {backend[0][3]}; launch 1: "
          f"{PARALLEL_STEPS} steps of batch {cfg.data.batch_size} in {first_s:.1f} s of wall "
          f"(the launcher, start-up, a validation and the checkpoint included); the "
          f"checkpoint's rank-0 files {ckpt}, {len(state['rngs'])} rank RNG state(s) in it",
          flush=True)
    print(f"  fit step ms (perf/steps_per_sec) "
          + ", ".join(f"{k}: {v:.1f}" for k, v in fit_ms.items())
          + "; phase 19's run without a group (host collator, first / last): "
          + " / ".join(", ".join(f"{k}: {v:.1f}" for k, v in handed["fit_ms"][n].items())
                       for n in ("packed", "packed_again")), flush=True)
    print(f"  step 1 against phase 19's run without a group: largest relative log gap "
          f"{gaps[worst]:.2e} ({worst}; rtol {STEP_LOG_RTOL})", flush=True)
    print(f"  launch 2 resumed {PARALLEL_STEPS} -> {PARALLEL_STEPS + 1} in {second_s:.1f} s; "
          f"its trace of step {PARALLEL_STEPS + 1} and its validation: B3 {b3}, B4 {b4} "
          f"({n_val} val batch(es)), B1 {b1}; validations at steps {vals}", flush=True)
    assert ckpt == [str(PARALLEL_STEPS), "config.json", f"loader_state-{PARALLEL_STEPS}.json"], ckpt
    assert len(state["rngs"]) == 1
    assert gaps[worst] <= STEP_LOG_RTOL, f"{worst}: step 1 under the group differs by {gaps[worst]}"
    assert BACKEND.findall(out2)[0][0] == "nccl"
    assert b3 == 1, f"B3 {b3} in the trace of one step"
    assert b4 == n_val, f"B4 {b4} in the trace of one validation of {n_val} batch(es)"
    assert b1 == 0, f"B1 {b1} in training"
    assert vals == [PARALLEL_STEPS, PARALLEL_STEPS + 1], vals
    bad = [(r["step"], k) for r in rows for k, v in r.items() if not np.isfinite(v)]
    assert not bad, f"non-finite logged values at {bad}"
    return {"backend": backend[0][0], "fit_ms": fit_ms, "step1_gap": gaps[worst],
            "launch_s": [first_s, second_s], "b3_per_step": b3, "b4_per_val_batch": b4 / n_val,
            "checkpoint_files": ckpt}


GLOO_RANK = """
import json, sys
sys.path.insert(0, {repo!r})
import chip_smoke
print(json.dumps(chip_smoke.gloo_rank()))
"""


def gloo_rank() -> dict:
    """(b), in one of two processes on cuda:0: `init_distributed(backend=
    "gloo")`, the phase-7 batch's shard of this rank, one
    `make_train_step(cfg, mesh)` step without dropout, its global logs, the
    parameters' digest, the peak memory, B3's launches, and the reducer
    timed on gradients of G's and D's shapes."""
    from optispeech_tpu_torch.ops import mas
    from optispeech_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        reduce_logs,
        shard_batch,
    )
    from optispeech_tpu_torch.parallel.mesh import all_reduce_grads, parameter_digest
    from optispeech_tpu_torch.training.state import init_train_state
    from optispeech_tpu_torch.training.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = init_distributed(device=PARALLEL_DEVICE, backend="gloo",
                              timeout_s=PARALLEL_TIMEOUT_S)
    import torch.distributed as dist

    rank = dist.get_rank()
    mesh = make_mesh()
    cfg = without_dropout(training_config())
    state = init_train_state(cfg, device, seed=0, rank=rank)
    t_text, t_mel = MAS_SHAPE[2], MAS_SHAPE[1]
    batch = shard_batch(training_batch(cfg, PARALLEL_ROWS, t_text, t_mel, device), mesh)
    step = make_train_step(cfg, mesh)
    torch.cuda.reset_peak_memory_stats()
    mas.viterbi_decode.launches = 0
    logs = reduce_logs(step(state, batch), mesh)
    torch.cuda.synchronize()
    b3 = mas.viterbi_decode.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = {"rank": rank, "rows": int(batch["x"].shape[0]), "b3": b3, "peak_gib": peak,
           "logs": {k: float(v) for k, v in logs.items()},
           "digest": parameter_digest([state.generator, state.discriminator])}
    for part, opt in (("g", state.g_opt), ("d", state.d_opt)):
        grads = [torch.ones_like(p) for p in opt.params]
        ms = []
        for _ in range(4):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_reduce_grads(grads, mesh)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        out[f"reducer_{part}_ms"] = statistics.median(ms[1:])
        out[f"reducer_{part}_mib"] = sum(g.numel() * g.element_size() for g in grads) / 2 ** 20
    dist.destroy_process_group()
    return out


def two_ranks_gloo():
    """(b): one process's step over PARALLEL_ROWS rows (no dropout, phase
    7's shape), then two processes on the one card, each stepping on its
    half over gloo; each rank's logs against the one process's, and both
    ranks' parameters after the step equal bit for bit."""
    from optispeech_tpu_torch.parallel.mesh import parameter_digest
    from optispeech_tpu_torch.training.state import init_train_state
    from optispeech_tpu_torch.training.step import make_train_step

    cfg = without_dropout(training_config())
    state = init_train_state(cfg, PARALLEL_DEVICE, seed=0)
    batch = training_batch(cfg, PARALLEL_ROWS, MAS_SHAPE[2], MAS_SHAPE[1], PARALLEL_DEVICE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    want = {k: float(v) for k, v in make_train_step(cfg)(state, batch).items()}
    one_ms = 1e3 * (time.perf_counter() - t0)
    one_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    one_digest = parameter_digest([state.generator, state.discriminator])
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()

    repo = Path(__file__).resolve().parent
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
           "WORLD_SIZE": "2"}
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", GLOO_RANK.format(repo=str(repo))],
                              cwd=repo, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              start_new_session=True) for r in range(2)]
    results = []
    try:
        for r, proc in enumerate(procs):
            out, err = proc.communicate(timeout=LAUNCH_LIMIT_S)
            assert proc.returncode == 0, f"gloo rank {r}: return code {proc.returncode}\n" \
                                         f"{err[-6000:]}"
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    wall_s = time.perf_counter() - t0
    gaps = {(r["rank"], k): abs(r["logs"][k] - want[k]) / max(abs(want[k]), 1e-12)
            for r in results for k in want}
    worst = max(gaps, key=gaps.get)
    reducer_ms = statistics.mean(r["reducer_g_ms"] + r["reducer_d_ms"] for r in results)
    print(f"  (b) one process, {PARALLEL_ROWS} rows: step {one_ms:.1f} ms (first, cold), peak "
          f"{one_peak:.2f} GiB; two ranks on the one card over gloo, "
          f"{results[0]['rows']} rows each, in {wall_s:.1f} s of wall (start-up included)",
          flush=True)
    for r in results:
        print(f"  rank {r['rank']}: B3 {r['b3']}, peak {r['peak_gib']:.2f} GiB, reducer (gloo "
              f"through the host, not NCCL) G {r['reducer_g_ms']:.1f} ms for "
              f"{r['reducer_g_mib']:.1f} MiB, D {r['reducer_d_ms']:.1f} ms for "
              f"{r['reducer_d_mib']:.1f} MiB", flush=True)
    print(f"  each rank's step-1 logs (grad_norm/* included) against the one process's: "
          f"largest relative gap {gaps[worst]:.2e} ({worst}; rtol {STEP_LOG_RTOL}); the ranks' "
          f"parameters equal {results[0]['digest'] == results[1]['digest']}; equal to the one "
          f"process's {results[0]['digest'] == one_digest}", flush=True)
    assert all(r["b3"] == 1 for r in results), [r["b3"] for r in results]
    assert gaps[worst] <= STEP_LOG_RTOL, f"{worst} differs by {gaps[worst]}"
    assert results[0]["digest"] == results[1]["digest"], "the ranks' parameters differ"
    return {"b3_per_rank": [r["b3"] for r in results], "gap": gaps[worst],
            "reducer_ms_per_step": reducer_ms,
            "reducer_mib_per_turn": {"g": results[0]["reducer_g_mib"],
                                     "d": results[0]["reducer_d_mib"]},
            "peak_gib": [r["peak_gib"] for r in results], "one_process_peak_gib": one_peak,
            "wall_s": wall_s}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_path(root, handed):
    """Phase 20: (a) one rank under NCCL through the launcher, (b) two ranks
    on the one card over gloo."""
    t_phase = time.perf_counter()
    # the launched processes need the card's memory: this process keeps none cached
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  this process holds {torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB of the card "
          "(reserved by its allocator) while the ranks run", flush=True)
    nccl = one_rank_nccl(root, handed)
    gc.collect()
    torch.cuda.empty_cache()
    gloo = two_ranks_gloo()
    out = {"nccl_one_rank": nccl, "gloo_two_ranks": gloo,
           "phase_s": time.perf_counter() - t_phase}
    print(f"  phase 20 took {out['phase_s']:.1f} s", flush=True)
    return out


# phase 21: the configurations the port had not run: the 48 kHz and 22.05 kHz
# feature blocks, preprocessing at 48 kHz and at kareem.yaml's Arabic front
# end, and the campaign (scripts/port_campaign.py) at campaign-ms.yaml
RATE_CONFIGS = ("ljspeech-48k", "ljspeech-22k")
CONFIG_ROWS = 4  # (a): card against CPU on the bench inputs' first rows
RATE_CORPUS = 16  # (b): synthcorpus utterances written at 48 kHz
ARABIC_SENTENCES = (  # (b): kareem's rows, in Arabic script and in Buckwalter
    "السَّلامُ عَلَيكُم", "كِتابٌ جَديدٌ عَلى الطّاوِلَةِ.", "مَرحَباً بِالعالَمِ، كَيفَ حالُك؟",
    "ذَهَبَ الوَلَدُ إِلى المَدرَسَةِ صَباحاً", "مرحبا بكم في المدينة", "Alsa~alAmu Ealaykum",
    "*ahaba Alwaladu <ilaY Almadrasapi SabAHAF.", "qara>a Altilmy*u Alkitaba")
# (c): a train split of 132 at the campaign's val fraction (0.03): one batch of 128
CAMPAIGN_UTTERANCES, CAMPAIGN_STEPS = 136, 3
CAMPAIGN_OVERRIDES = ["train_args.pretraining_steps=1", f"val_every_n_steps={CAMPAIGN_STEPS}",
                      "log_every_n_steps=1"]
# the export stage's ladders, in place of campaign.py's 32,64 x 1,2,4,8 (the
# script's time limit); the serve check's sentences take at most 38 tokens
CAMPAIGN_LADDERS = {"--text-buckets": "64", "--batch-sizes": "1,4"}


def named_config(name, *overrides):
    """configs/<name>.yaml as the user loads it, D trained from the first
    step; the English files with the en-g2p front end."""
    from optispeech_tpu_torch.utils.yamlcfg import load_experiment

    front = [] if name == "kareem" else WORKFLOW_CONFIG
    return load_experiment(name, [*front, "train_args.pretraining_steps=0", *overrides])


def head_ms(head):
    """Device ms of the WaveNeXt head alone on bench-shape frame features."""
    x = torch.randn(BENCH["batch"], BENCH["n_frames"], head.linear_1.in_features,
                    device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    with torch.no_grad():
        return time_ms(lambda: head(x), iters=5)


def rate_synthesis(fc, mas, name, cfg):
    """(a) bench-shape synthesis of `cfg` on the card, then card against CPU
    on the first CONFIG_ROWS rows; returns its figures."""
    from optispeech_tpu_torch.models.optispeech import OptiSpeech, with_fused_blocks

    api = OptiSpeech(with_fused_blocks(cfg), seed=0, device="cuda")
    g, f = api.cfg.generator, api.cfg.generator.features
    assert g.decoder.fused_pallas and g.vocoder.fused_pallas
    inputs, n_frames = bench_inputs(), BENCH["n_frames"]
    fc.convnext_block_fused.launches = 0
    mas.viterbi_decode.launches = mas.viterbi_decode_extract.launches = 0
    o = api.synthesise_on_device(inputs, n_frames, pcm16=True)  # warm-up
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        o = api.synthesise_on_device(inputs, n_frames, pcm16=True)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = fc.convnext_block_fused.launches
    assert launches == 12 * 6, f"{name}: expected 12 B1 launches per decode, got {launches} in 6"
    assert mas.viterbi_decode.launches == mas.viterbi_decode_extract.launches == 0
    assert o["wav"].shape == (BENCH["batch"], n_frames * f.hop_length)
    assert bool(torch.isfinite(o["wav"]).all()), f"{name}: non-finite samples"
    ms, head = statistics.median(walls), head_ms(api.generator.vocoder.head)
    audio_s = float(o["wav_lengths"].sum()) / f.sample_rate
    print(f"  (a) {name}: {f.sample_rate} Hz, hop {f.hop_length}, n_fft {f.n_fft}, {f.n_feats} "
          f"mels to {f.f_max:g} Hz; synthesise_on_device at bench shape: median {ms:.2f} ms over "
          f"5 calls (min {min(walls):.2f}), {audio_s:.2f} s of audio ({audio_s / (ms / 1e3):.1f}x "
          f"real time); B1 {launches // 6} per decode; the WaveNeXt head ({g.vocoder.dim} -> "
          f"{f.n_fft + 2} -> {f.hop_length}) alone {head:.3f} ms of device time", flush=True)

    cpu_api = OptiSpeech(api.cfg, device="cpu",
                         state_dict={k: v.cpu() for k, v in api.generator.state_dict().items()})
    rows = bench_inputs(CONFIG_ROWS)
    gpu, cpu = api.synthesise_on_device(rows, n_frames), cpu_api.synthesise_on_device(rows,
                                                                                     n_frames)
    dur_equal = torch.equal(gpu["durations"].cpu(), cpu["durations"])
    wav_diff = float((gpu["wav"].cpu() - cpu["wav"]).abs().max())
    print(f"      card against CPU, {CONFIG_ROWS} rows at {n_frames} frames: durations equal "
          f"{dur_equal}; wav max|card - cpu| {wav_diff:.3e} (atol {WAV_ATOL})", flush=True)
    assert dur_equal, f"{name}: durations differ between card and CPU"
    assert wav_diff <= WAV_ATOL, f"{name}: wav differs between card and CPU by {wav_diff}"
    return dict(bench_ms=ms, b1_launches_per_decode=launches // 6, head_ms=head,
                head_share=head / ms, audio_s=audio_s)


def rate_training(mas, name, cfg):
    """(a) phase 7's batch on `cfg`; returns the step figures, the peak per
    turn and B3's launches."""
    walls, peak, b3, turns = phase7_steps(mas, name, cfg, label="(a)")
    print(f"      {name}: median of the 3 after the warm-up {statistics.median(walls[1:]):.1f} "
          f"ms a step; peak per turn: G {turns['generator']:.2f} GiB, D "
          f"{turns['discriminator']:.2f} GiB", flush=True)
    return dict(step_ms=statistics.median(walls[1:]), steps_ms=walls, peak_gib=peak,
                turn_peak_gib=turns, b3_launches=b3)


def config_preprocessing(fc, root):
    """(b) cli/preprocess.py and cli/stats.py at 48 kHz on RATE_CORPUS
    utterances written at 48 kHz, and at kareem.yaml on ARABIC_SENTENCES
    over synthcorpus wavs; then kareem's synthesis on the card (B1 12 times
    per decode). Returns the seconds of each and B1's launches."""
    from optispeech_tpu_torch.cli import preprocess, stats
    from optispeech_tpu_torch.data.synthcorpus import generate_corpus
    from optispeech_tpu_torch.models.optispeech import OptiSpeech, with_fused_blocks

    out = {}
    for name, corpus_kw, flags in (
            ("ljspeech-48k", dict(n_utterances=RATE_CORPUS, sr=48000, frontend="en-g2p"),
             ["--tokenizer", "en-g2p", "--workers", "4"]),
            ("kareem", dict(n_utterances=len(ARABIC_SENTENCES), frontend="char"),
             ["--workers", "1"])):
        corpus, data = root / f"corpus-{name}", root / f"data-{name}"
        t0 = time.perf_counter()
        generate_corpus(str(corpus), seed=0, **corpus_kw)
        if name == "kareem":  # the same wavs under Arabic text, one speaker
            ids = [r.split("|")[0] for r in (corpus / "metadata.csv").read_text().splitlines()]
            (corpus / "metadata.csv").write_text(
                "".join(f"{i}|{t}\n" for i, t in zip(ids, ARABIC_SENTENCES)), encoding="utf-8")
        t1 = time.perf_counter()
        train, val = preprocess.main([str(corpus), str(data), "--config", name, *flags,
                                      "--val-fraction", "0.125"])
        t2 = time.perf_counter()
        stats_ = stats.main(["--config", name, "-o", str(data / "stats.json"),
                             f"data.train_filelist_path={data / 'train.txt'}"])
        t3 = time.perf_counter()
        n = len(train) + len(val)
        feats = named_config(name).generator.features
        with np.load(Path(train[0]).with_suffix(".npz")) as z:
            assert z["mel"].shape[0] == feats.n_feats and len(z["pitch"]) == z["mel"].shape[1]
        assert n == corpus_kw["n_utterances"] and all(np.isfinite(v) for v in stats_.values())
        print(f"  (b) {name} ({feats.sample_rate} Hz): corpus {t1 - t0:.2f} s; cli/preprocess.py "
              f"{n} utterances in {t2 - t1:.2f} s ({1e3 * (t2 - t1) / n:.1f} ms per utterance, "
              f"{' '.join(flags[-2:])}); cli/stats.py {t3 - t2:.2f} s; mel_mean "
              f"{stats_['mel_mean']:.4f}"
              f", pitch_mean {stats_['pitch_mean']:.2f}", flush=True)
        out[name] = dict(corpus_s=t1 - t0, preprocess_s=t2 - t1, stats_s=t3 - t2, utterances=n)

    api = OptiSpeech(with_fused_blocks(named_config("kareem")), seed=0, device="cuda")
    fc.convnext_block_fused.launches = 0
    res = api.synthesise(api.prepare_input(ARABIC_SENTENCES[3]))  # split: one sentence
    launches = fc.convnext_block_fused.launches
    assert np.isfinite(res.wav).all() and res.wav.shape[0] == 1
    assert launches == 12, f"kareem: expected 12 B1 launches per decode, got {launches}"
    print(f"      kareem, flagship widths: synthesise on an Arabic sentence, "
          f"{int(res.durations.sum())} frames, latency {res.latency:.2f} ms; B1 {launches}",
          flush=True)
    out["kareem"]["b1_launches"] = launches
    return out


def campaign_path(root):
    """(c) scripts/port_campaign.py at campaign-ms.yaml on the card, its
    training stage traced (`--profile-steps`), in `root`; returns the
    verdict, the stage seconds and the kernels' launches read from the
    stages' outputs."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "port_campaign", Path(__file__).resolve().parent / "scripts" / "port_campaign.py")
    port_campaign = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(port_campaign)
    run = port_campaign.run

    def traced(cmd, *args, **kwargs):
        cmd = [str(c) for c in cmd]
        if "optispeech_tpu_torch.cli.train" in cmd:  # the steps and the validation in a trace
            cmd = [*cmd[:3], "--profile-steps", f"0,{CAMPAIGN_STEPS}", *cmd[3:]]
        if "optispeech_tpu_torch.cli.export" in cmd:  # the artifact at CAMPAIGN_LADDERS
            for flag, value in CAMPAIGN_LADDERS.items():
                cmd[cmd.index(flag) + 1] = value
        return run(cmd, *args, **kwargs)

    port_campaign.run = traced
    work = root / "work"
    info = port_campaign.main([
        "--work-dir", str(work), "--n-utterances", str(CAMPAIGN_UTTERANCES),
        "--max-steps", str(CAMPAIGN_STEPS), "--disc-on-step", "1", "--device", "cuda",
        *CAMPAIGN_OVERRIDES])
    n_val = len((work / "pre" / "val.txt").read_text().splitlines())
    n_train = len((work / "pre" / "train.txt").read_text().splitlines())
    trace = work / "run" / "profile" / "trace.json"
    b3, b4 = b3_in_trace(trace), b3_in_trace(trace, B4_KERNEL)
    speakers = json.loads((work / "speaker_f0.json").read_text())
    kernels = speakers.pop("_kernels")
    served = json.loads((work / "serve_check.json").read_text())
    names = json.loads((work / "corpus" / "manifest.json").read_text())["speakers"]
    print(f"  (c) scripts/port_campaign.py: {n_train} train / {n_val} val utterances, "
          f"{CAMPAIGN_STEPS} steps of batch 128; stage seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in info["stage_seconds"].items())
          + f"; the artifact at {CAMPAIGN_LADDERS}; in the training stage's trace B3 {b3}, "
          f"B4 {b4}; the speaker check's "
          f"{kernels['synthesise_calls']} synthesise calls on {kernels['device']}: B1 "
          f"{kernels['b1_launches']}", flush=True)
    for name in names:
        print(f"      {name}: assigned F0 {speakers[name]['assigned_f0']}, tracked "
              f"{speakers[name]['tracked_median_f0']:.1f} Hz, predicted "
              f"{speakers[name]['predicted_median_f0']:.1f} Hz; served "
              f"{served[name]['audio_seconds']:.3f} s in {served[name]['wall_ms']:.1f} ms "
              f"(F0 {served[name]['served_median_f0']:.1f} Hz)", flush=True)
    print(f"      /stream {served['_stream']['bytes']} bytes in {served['_stream']['wall_ms']:.1f} "
          f"ms; quality gate {info['quality_gate']} (data, not a check, at {CAMPAIGN_STEPS} "
          f"steps): {info['quality_failures']}", flush=True)
    assert n_train >= 128, f"the campaign's train split holds {n_train} utterances"
    assert b3 == CAMPAIGN_STEPS, f"B3 {b3} in the trace of {CAMPAIGN_STEPS} steps"
    assert b4 == -(-n_val // 128), f"B4 {b4} in the trace of one validation of {n_val} items"
    assert kernels["device"].startswith("cuda")
    assert kernels["b1_launches"] == 12 * kernels["synthesise_calls"], kernels
    assert all(speakers[n]["wav_seconds"] > 0 for n in names), speakers
    assert all(served[n]["audio_seconds"] > 0 and not served[n]["truncated"] for n in names)
    assert served["_stream"]["bytes"] > 0 and served["_health"]["status"] == "ok"
    assert (work / "run" / "avg_eval" / "compare.json").exists()
    return dict(stage_s=info["stage_seconds"], verdict=info["quality_gate"],
                failures=info["quality_failures"], b3_launches=b3, b4_launches=b4,
                val_items=n_val, b1_launches=kernels["b1_launches"],
                synthesise_calls=kernels["synthesise_calls"])


def configurations(fc, mas):
    """Phase 21: returns each part's figures and launch counts."""
    t_phase, out = time.perf_counter(), {}
    for name in RATE_CONFIGS:
        cfg = named_config(name)
        out[name] = rate_synthesis(fc, mas, name, cfg)
        gc.collect()
        torch.cuda.empty_cache()
        if name == "ljspeech-48k":
            out[name].update(rate_training(mas, name, cfg))
            gc.collect()
            torch.cuda.empty_cache()
        b3, b4 = step_card_against_cpu(mas, name, cfg, validation=name == "ljspeech-48k")
        out[name].update(b3_cross=b3, b4_cross=b4)
    from optispeech_tpu_torch.models.vocoder.wavenext import WaveNeXtHead

    flagship = WaveNeXtHead(384, 1024, 256).to("cuda")
    out["flagship_head_ms"] = head_ms(flagship)
    print(f"  (a) the flagship's head (384 -> 1026 -> 256) alone {out['flagship_head_ms']:.3f} ms"
          f" on the same frame features", flush=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_configs_"))
    try:
        t0 = time.perf_counter()
        out["preprocessing"] = config_preprocessing(fc, root)
        out["preprocessing_phase_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["campaign"] = campaign_path(root)
        out["campaign"]["seconds"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 21 took {out['phase_s']:.1f} s", flush=True)
    return out


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
    # the packed data path's host collator builds beside the kernels
    with ThreadPoolExecutor(max_workers=1) as pool:
        host_job = pool.submit(_build.build_host, "packed_dataset")
        built = _build.build_kernels(sources={"mas_chain": probe})
        host_build = host_job.result()
    print(f"  packed_dataset (host C++, csrc/packed_dataset.cpp): {host_build['path']} built in "
          f"{host_build['seconds']:.1f} s")
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

    phase("16. the serving runtime (cli/serve.py: prewarm, 32 concurrent requests, card "
          "against CPU, /stream, --bf16)")
    gc.collect()
    torch.cuda.empty_cache()
    serving = serving_runtime(fc)

    phase("17. export and replay (cli/export.py, cli/speak.py, ExportedOptiSpeech card against "
          "CPU, cli/serve.py on the artifact, phase 4's figure through the op)")
    gc.collect()
    torch.cuda.empty_cache()
    export = export_replay(fc, serving["stream"]["d_factor"])

    phase("18. the other backbone kinds (light, transformer, conformer, leanspeech): "
          "synthesis card against CPU, training, cli/infer.py")
    gc.collect()
    torch.cuda.empty_cache()
    others = other_backbones(fc, mas)

    # phases 19 and 20 in a temporary directory outside the checkout, deleted after
    scratch = Path(tempfile.mkdtemp(prefix="chip_smoke_packed_"))
    try:
        phase("19. the packed data path and the run tools (cli/pack.py, --packed-train, "
              "--device-cache, the scan, cli/average.py, cli/infer.py, cli/sweep.py)")
        gc.collect()
        torch.cuda.empty_cache()
        packed, handed = packed_path(fc, mas, host_build, scratch)

        phase("20. parallelism (cli/train.py --distributed on one rank under NCCL, then a "
              "resume; two ranks on the one card over gloo)")
        gc.collect()
        torch.cuda.empty_cache()
        parallel = parallel_path(scratch, handed)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    phase("21. the configurations not run before (48 kHz and 22.05 kHz synthesis and "
          "training, preprocessing at 48 kHz and kareem.yaml, scripts/port_campaign.py)")
    gc.collect()
    torch.cuda.empty_cache()
    configs = configurations(fc, mas)

    trunk = rows["trunk"]
    kernel = {
        "name": "convnext_block_fused", "route": "cuda",
        "source": "optispeech_tpu_torch/csrc/convnext_block.cu",
        "replaces": "optispeech_tpu/ops/pallas_convnext.py:224",
        "launches": launches, "launch_path": "phase 4, synthesis",
        "launches_dim192_decode": dim192_launches,
        "launches_phase_14": workflow_launches,
        "launches_bf16_decode": bf16["b1_launches_per_decode"],
        "launches_serving": {
            "batches": serving["b1_launches"], "synthesise_calls": serving["calls"],
            "stream_windows": serving["stream"]["windows"],
            "stream": serving["stream"]["b1_launches"], "bf16": serving["bf16"]["b1_launches"]},
        "launches_export": {
            "speak": export["speak"]["b1_launches"], "replay": export["replay"]["b1_launches"],
            "serve_batches": export["serve"]["b1_launches"],
            "serve_decode_replays": export["serve"]["calls"],
            "serve_stream_windows": export["serve"]["stream"]["windows"],
            "serve_stream": export["serve"]["stream"]["b1_launches"]},
        "launches_other_backbones": {
            **{name: others[name]["b1_launches_per_decode"] for name in OTHER_BACKBONES},
            "unit": "per fused decode", "light_cli_infer": others["cli_b1_launches"]},
        "launches_averaged_checkpoint_cli_infer": packed["average"]["b1"],
        "launches_phase_21": {
            **{name: configs[name]["b1_launches_per_decode"] for name in RATE_CONFIGS},
            "unit": "per decode", "kareem_synthesise": configs["preprocessing"]["kareem"][
                "b1_launches"],
            "campaign_speaker_check": configs["campaign"]["b1_launches"],
            "campaign_speaker_check_synthesise_calls": configs["campaign"]["synthesise_calls"]},
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
        "launches_other_backbones": {name: others[name]["b3_launches"] for name in OTHER_BACKBONES},
        "launches_packed_path": {
            **{name: run["b3"] for name, run in packed["runs"].items()},
            "unit": f"per run of {PACKED_STEPS} steps", "scan_and_two_steps": packed["scan"]["b3"],
            "sweep_trials_traced": packed["sweep"]["b3"]},
        "launches_parallel": {
            "nccl_one_rank_per_step": parallel["nccl_one_rank"]["b3_per_step"],
            "gloo_two_ranks_per_rank": parallel["gloo_two_ranks"]["b3_per_rank"],
            "unit": "per step (phase 20)"},
        "launches_phase_21": {
            "ljspeech-48k_phase_7_batch": configs["ljspeech-48k"]["b3_launches"],
            **{f"{name}_step_card_against_cpu": configs[name]["b3_cross"]
               for name in RATE_CONFIGS},
            "campaign_traced_steps": configs["campaign"]["b3_launches"]},
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
        "launches_other_backbones": {name: others[name]["b4_launches"] for name in OTHER_BACKBONES},
        "launches_packed_path": {
            **{name: run["b4"] for name, run in packed["runs"].items()},
            "unit": "per validation of one batch", "average_two_passes": packed["average"]["b4"]},
        "launches_parallel": {
            "nccl_one_rank_per_val_batch": parallel["nccl_one_rank"]["b4_per_val_batch"],
            "unit": "per validation batch (phase 20(a), in a trace)"},
        "launches_phase_21": {
            "ljspeech-48k_validation_card_against_cpu": configs["ljspeech-48k"]["b4_cross"],
            "campaign_traced_validation": configs["campaign"]["b4_launches"],
            "campaign_val_items": configs["campaign"]["val_items"]},
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
    print("\n  serving: " + json.dumps(serving))
    print("\n  export: " + json.dumps(export))
    print("\n  other backbones: " + json.dumps(others))
    print("\n  packed path: " + json.dumps(packed))
    print("\n  parallelism: " + json.dumps(parallel))
    print("\n  configurations: " + json.dumps(configs))
    print(f"\n  build {build_s:.1f} s; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [kernel, wide_kernel, mas_kernel, extract_kernel, int8_kernel]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
