#!/usr/bin/env python3
"""Variants of B1's kernel source held and timed beside the shipped kernel.

    python3 scripts/b1_variants.py DIR

Builds `optispeech_tpu_torch/csrc/convnext_block.cu` ("shipped") and every
DIR/NAME.cu with ops/_build.py's nvcc flags (and csrc/ on the include path,
for `hopper.cuh`), one nvcc each, all at once, and
prints each build's ptxas report: registers, spill stores, and whether
ptxas serialized the wgmma groups (its warning C7514). Each variant must
export `convnext_block_fused_launch` with the shipped signature and take
the pack of `fused_convnext.kernel_weights`.

Then each build runs in a process of its own, so that a fault stops only
that one: it is held against the twin at C = 128 / 256 / 384 and at C = 97
and 500 (padded to 128 and 512), B x T = 1 x 1,
2 x 65, 4 x 1000 and 32 x 1792, x float32 and bfloat16, within
chip_smoke.py's tolerances (a variant whose name holds "_no" leaves a part
out to price it, and is timed only), and timed at B = 32, T = 1792: the
decoder (256 / 1024) and the trunk (384 / 1152) with x float32, the trunk
with x bfloat16, C = 448 / I = 1792 with x bfloat16, C = 512 / I = 2048
with x float32 and bfloat16, and the padded C = 300 / I = 1200,
C = 500 / I = 2000 and C = 96 / I = 384 with x bfloat16. A time is chip_smoke.py's `time_ms` (CUDA events), the
better of two windows of 20 launches. Needs a card.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from optispeech_tpu_torch.ops import _build  # noqa: E402
from optispeech_tpu_torch.ops import fused_convnext as fc  # noqa: E402

CHECKED = ((1, 1), (2, 65), (4, 1000), (32, 1792))  # (B, T)
TIMED = {"decoder": ((256, 1024), torch.float32), "trunk": ((384, 1152), torch.float32),
         "trunk_bf16": ((384, 1152), torch.bfloat16), "c448_bf16": ((448, 1792), torch.bfloat16),
         "c512": ((512, 2048), torch.float32), "c512_bf16": ((512, 2048), torch.bfloat16),
         "c300_bf16": ((300, 1200), torch.bfloat16), "c500_bf16": ((500, 2000), torch.bfloat16),
         "c96_bf16": ((96, 384), torch.bfloat16)}


def launcher(lib_path):
    fn = ctypes.CDLL(str(lib_path)).convnext_block_fused_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x, p, packed):
        dw, dwb, lnw, lnb, _, b1, _, b2, gamma = p
        out = torch.empty_like(x)
        b, t, c = x.shape
        err = fn(x.data_ptr(), out.data_ptr(), dw.data_ptr(), dwb.data_ptr(), lnw.data_ptr(),
                 lnb.data_ptr(), packed.data_ptr(), b1.data_ptr(), b2.data_ptr(), gamma.data_ptr(),
                 b, t, c, b1.shape[0], int(x.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed with cudaError {err}")
        return out

    return run


def check_and_time(name, lib_path) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = launcher(lib_path)
    res = {"name": name, "cases_outside": 0, "max_abs_err": 0.0}
    if "_no" not in name:
        gen = torch.Generator().manual_seed(0)
        for c, inter in ((128, 512), (256, 1024), (384, 1152), (97, 291), (500, 1000)):
            for b, t in CHECKED:
                for dtype in (torch.float32, torch.bfloat16):
                    x, p = cs.block_inputs(gen, b, t, c, inter, dtype, "cuda")
                    got = run(x, p, fc.kernel_weights(p[4], p[6]))
                    ref = fc.convnext_block_reference(x, *p).float()
                    diff = (got.float() - ref).abs()
                    rtol = cs.BF16_RTOL if dtype == torch.bfloat16 else 0.0
                    res["cases_outside"] += not bool((diff <= cs.ATOL + rtol * ref.abs()).all())
                    res["max_abs_err"] = max(res["max_abs_err"], float(diff.max()))
    gen = torch.Generator().manual_seed(1)
    for key, ((c, inter), dtype) in TIMED.items():
        x, p = cs.block_inputs(gen, 32, 1792, c, inter, dtype, "cuda")
        packed = fc.kernel_weights(p[4], p[6])
        res[key + "_ms"] = min(cs.time_ms(lambda: run(x, p, packed), iters=20) for _ in range(2))
    return res


def build_all(sources: dict) -> dict:
    """{name: library path} of the sources that built, after printing each
    build's ptxas summary."""
    procs = {}
    for name, src in sources.items():
        lib = _build.BUILD_DIR / f"variant-{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        summary = cs.ptxas_summary(log)
        print(f"{name}: nvcc rc {proc.returncode}; registers "
              f"{[e.get('registers') for e in summary]}, spill stores "
              f"{[e.get('spill_store_bytes') for e in summary]}, wgmma serialized "
              f"{[e['wgmma_serialized'] for e in summary]}", flush=True)
        reasons = {line.split("serialized", 1)[1].split(" in the function")[0].strip()
                   for line in log.splitlines() if "C7514" in line and "serialized" in line}
        for reason in sorted(reasons):  # ptxas's reason for serializing
            print(f"    C7514: serialized {reason}", flush=True)
        if proc.returncode == 0:
            built[name] = lib
        else:
            print("    " + "\n    ".join(line for line in log.splitlines()[-6:]
                                        if "C75" not in line), flush=True)
    return built


def drive(shipped: Path, variants: str, script: str) -> int:
    """Build `shipped` and every variants/NAME.cu at once (`build_all`),
    then run `script --one NAME LIB` for each build in a process of its own,
    killed after 180 s, and print the RESULT line it prints. Returns 1 if a
    build or a run failed, else 0."""
    print(cs.card_line(), flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = {"shipped": shipped, **{p.stem: p for p in sorted(Path(variants).glob("*.cu"))}}
    built = build_all(sources)
    failed = len(sources) - len(built)
    for name, lib in built.items():
        proc = subprocess.run(["timeout", "-s", "KILL", "180", sys.executable, script, "--one",
                               name, str(lib)], capture_output=True, text=True)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not line:
            failed += 1
            print(f"{name}: run failed, rc {proc.returncode}: {proc.stderr[-600:]}", flush=True)
            continue
        print(line[0][len("RESULT "):], flush=True)
    return 1 if failed else 0


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print("RESULT " + json.dumps(check_and_time(argv[1], argv[2])), flush=True)
        return 0
    return drive(_build.CSRC / "convnext_block.cu", argv[0], __file__)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
