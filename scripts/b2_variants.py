#!/usr/bin/env python3
"""Variants of B2's kernel source held and timed beside the shipped kernel.

    python3 scripts/b2_variants.py DIR

Builds `optispeech_tpu_torch/csrc/convnext_block_int8.cu` ("shipped") and
every DIR/NAME.cu through scripts/b1_variants.py's `drive` (ops/_build.py's
nvcc flags, csrc/ on the include path, one nvcc each, all at once), and
prints each build's ptxas report: registers, spill stores, and whether
ptxas serialized the wgmma groups (its warning C7514). Each variant must
export `convnext_block_int8_launch` with the shipped signature and take
the pack of `fused_convnext.kernel_weights_int8`.

Then each build runs in a process of its own, so that a fault stops only
that one: it must be bit-equal to the twin at C = 128 / 256 / 384 (I =
512 / 1024 / 1152), B x T = 1 x 1, 2 x 65, 4 x 1000 and 32 x 1792, x float32
and bfloat16 (a variant whose name holds "_no" leaves a part out to price
it, and is timed only), and is timed at B = 32, T = 1792, x bfloat16 (the
A/B's type): the trunk (384 / 1152) and the decoder (256 / 1024). A time is
chip_smoke.py's `time_ms` (CUDA events), the better of two windows of 20
launches. Needs a card.
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

CHECKED = ((1, 1), (2, 65), (4, 1000), (32, 1792))  # (B, T)
TIMED = {"trunk": (384, 1152), "decoder": (256, 1024)}


def launcher(lib_path):
    fn = ctypes.CDLL(str(lib_path)).convnext_block_int8_launch
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x, p, packed):
        dw, dwb, lnw, lnb, _, b1, _, b2, gamma = p
        images, s1, s2 = packed
        out = torch.empty_like(x)
        b, t, c = x.shape
        err = fn(x.data_ptr(), out.data_ptr(), dw.data_ptr(), dwb.data_ptr(), lnw.data_ptr(),
                 lnb.data_ptr(), images.data_ptr(), s1.data_ptr(), b1.data_ptr(), s2.data_ptr(),
                 b2.data_ptr(), gamma.data_ptr(), b, t, c, b1.shape[0],
                 int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed with cudaError {err}")
        return out

    return run


def check_and_time(name, lib_path) -> dict:
    run = launcher(lib_path)
    res = {"name": name, "cases_not_bit_equal": 0, "max_abs_err": 0.0}
    if "_no" not in name:
        gen = torch.Generator("cuda").manual_seed(0)
        for c, inter in ((128, 512), (256, 1024), (384, 1152)):
            for b, t in CHECKED:
                for dtype in (torch.float32, torch.bfloat16):
                    x, p = cs.block_inputs(gen, b, t, c, inter, dtype, "cuda",
                                           weight_dtype=torch.float32)
                    got = run(x, p, fc.kernel_weights_int8(p[4], p[6]))
                    ref = fc.convnext_block_int8_reference(x, *p)
                    res["cases_not_bit_equal"] += not torch.equal(got, ref)
                    res["max_abs_err"] = max(res["max_abs_err"],
                                             float((got.float() - ref.float()).abs().max()))
    gen = torch.Generator("cuda").manual_seed(1)
    for key, (c, inter) in TIMED.items():
        x, p = cs.block_inputs(gen, 32, 1792, c, inter, torch.bfloat16, "cuda",
                               weight_dtype=torch.float32)
        packed = fc.kernel_weights_int8(p[4], p[6])
        res[key + "_ms"] = min(cs.time_ms(lambda: run(x, p, packed), iters=20) for _ in range(2))
    return res


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print("RESULT " + json.dumps(check_and_time(argv[1], argv[2])), flush=True)
        return 0
    return drive(_build.CSRC / "convnext_block_int8.cu", argv[0], __file__)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
