#!/usr/bin/env python3
"""B1's wide path (csrc/convnext_block_wide.cu), and variants of it, held
against the twin and timed whole and kernel by kernel.

    python3 scripts/b1_wide_variants.py [DIR]

Builds `optispeech_tpu_torch/csrc/convnext_block_wide.cu` ("shipped") and
every DIR/NAME.cu at once (scripts/b1_variants.py's `drive`: one nvcc each,
each build's ptxas registers, spills and C7514 verdict printed), then runs
each build in a process of its own:
- checked against the twin (unless its name holds "_no": a variant that
  leaves a part out to price it is only timed) (ops/fused_convnext.py::
  convnext_block_reference) within chip_smoke.py's tolerances at C / I /
  B / T = 576 / 1152 / 2 / 1000, 768 / 3072 / 1 / 63, 1000 / 200 / 2 / 128,
  1088 / 4160 / 1 / 129 and 12272 / 64 / 2 / 64, x float32 and bfloat16;
- timed at chip_smoke.py phase 3's three wide widths, x float32: C = 576 /
  I = 1152 and 768 / 3072 at B = 32, T = 1792, and 12272 / 64 at T = 64.
  The whole launch is chip_smoke.py's `time_ms` (CUDA events, 20 launches,
  median of 5), each kernel's device time is `kernel_split_ms`
  (torch.profiler over 10 launches).
A source that exports `convnext_block_wide_smem_bytes` is launched with the
shipped ABI (h, u and split scratch from `fused_convnext.wide_plan`); one
without it with the earlier one (11 pointers and 5 ints: h scratch only).
Needs a card; prints the card's name and power limit first.
"""

import ctypes
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
from b1_variants import drive  # noqa: E402
from optispeech_tpu_torch.ops import _build  # noqa: E402
from optispeech_tpu_torch.ops import fused_convnext as fc  # noqa: E402

CHECKED = ((576, 1152, 2, 1000), (768, 3072, 1, 63), (1000, 200, 2, 128), (1088, 4160, 1, 129),
           (12272, 64, 2, 64))  # (C, I, B, T)
TIMED = {"c576": (576, 1152, 32, 1792), "c768": (768, 3072, 32, 1792),
         "c12272": (12272, 64, 32, 64)}


def launcher(lib_path):
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.convnext_block_wide_launch
    shipped_abi = hasattr(lib, "convnext_block_wide_smem_bytes")
    fn.argtypes = ([ctypes.c_void_p] * (13 if shipped_abi else 11)
                   + [ctypes.c_int] * (7 if shipped_abi else 5) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(x, p, packed):
        dw, dwb, lnw, lnb, _, b1, _, b2, gamma = p
        b, t, c = x.shape
        inter = b1.shape[0]
        out = torch.empty_like(x)
        ptrs = [q.data_ptr() for q in (x, out, dw, dwb, lnw, lnb, packed, b1, b2, gamma)]
        if shipped_abi:
            plan = fc.wide_plan(b, t, c, inter,
                                torch.cuda.get_device_properties(0).multi_processor_count)
            scratch = [torch.empty(max(1, plan[k]), dtype=dtype, device=x.device)
                       for k, dtype in (("h_elems", torch.bfloat16), ("u_elems", torch.bfloat16),
                                        ("partial_elems", torch.float32))]
            ptrs += [q.data_ptr() for q in scratch]
            ints = [b, t, c, inter, plan["k_splits"], plan["k_per_split"]]
        else:
            h_img = torch.empty(b * -(-t // 64) * 64 * fc.padded_width(c), dtype=torch.bfloat16,
                                device=x.device)
            ptrs.append(h_img.data_ptr())
            ints = [b, t, c, inter]
        err = fn(*ptrs, *ints, int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed with cudaError {err}")
        return out

    return run


def check_and_time(name, lib_path) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = launcher(lib_path)
    res = {"name": name, "cases_outside": 0, "max_abs_err": 0.0}
    gen = torch.Generator().manual_seed(0)
    for c, inter, b, t in CHECKED if "_no" not in name else ():
        for dtype in (torch.float32, torch.bfloat16):
            x, p = cs.block_inputs(gen, b, t, c, inter, dtype, "cuda")
            got = run(x, p, fc.kernel_weights(p[4], p[6]))
            ref = fc.convnext_block_reference(x, *p).float()
            diff = (got.float() - ref).abs()
            rtol = cs.BF16_RTOL if dtype == torch.bfloat16 else 0.0
            res["cases_outside"] += not bool((diff <= cs.ATOL + rtol * ref.abs()).all())
            res["max_abs_err"] = max(res["max_abs_err"], float(diff.max()))
    gen = torch.Generator().manual_seed(1)
    for key, (c, inter, b, t) in TIMED.items():
        x, p = cs.block_inputs(gen, b, t, c, inter, torch.float32, "cuda")
        packed = fc.kernel_weights(p[4], p[6])
        res[key + "_ms"] = cs.time_ms(lambda: run(x, p, packed), iters=20)
        res[key + "_kernels_ms"] = cs.kernel_split_ms(lambda: run(x, p, packed))
    return res


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print("RESULT " + json.dumps(check_and_time(argv[1], argv[2])), flush=True)
        return 0
    return drive(_build.CSRC / "convnext_block_wide.cu", argv[0] if argv else None, __file__)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
