#!/usr/bin/env python3
"""Variants of the MAS kernels' sources (B3, B4) held and timed beside the
shipped ones.

    python3 scripts/mas_variants.py DIR

Builds `optispeech_tpu_torch/csrc/mas_wavefront.cu` ("shipped_b3"),
`mas_extract.cu` ("shipped_b4") and every DIR/NAME.cu with ops/_build.py's
nvcc flags (csrc/ on the include path, for `mas_forward.cuh`), one nvcc
each, all at once (scripts/b1_variants.py's `build_all`, which prints each
build's registers and spills). A variant exports `mas_wavefront_launch` or
`mas_extract_launch` with the shipped signature and takes the decision
scratch of `ops/mas.py::decision_bytes`.

Each build then runs in a process of its own: held against the twin, its
durations exactly equal (B4: and its per-token sums bit-equal) at B x
T_feats x T_text = 128 x 768 x 192 (chip_smoke.py phase 6's lengths), 133 x
300 x 33 and 3 x 300 x 384 (a variant whose name holds "_no" leaves a part
out to price it, and is timed only); then timed by launching the kernel on
inputs made once (chip_smoke.py's `time_ms`, CUDA events, the better of two
windows of 50 launches) at 128 x 768 x 192 and at phase 6's second shape,
2 x 43 x 23. Needs a card.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
from b1_variants import build_all  # noqa: E402
from optispeech_tpu_torch.ops import _build, mas  # noqa: E402


def inputs(b, t_feats, t_text, seed):
    if (b, t_feats, t_text) == cs.MAS_SHAPE:
        return cs.mas_timing_inputs("cuda")[0]
    rng = np.random.default_rng(seed)
    lp = np.log(rng.dirichlet(np.ones(t_text), size=(b, t_feats)) + 1e-8).astype(np.float32)
    tl, fl = cs.mas_lengths(rng, b, t_feats, t_text)
    tl[0], fl[-1] = 1, 1
    return [torch.as_tensor(np.asarray(a), device="cuda") for a in (lp, tl, fl)]


def launcher(lib_path):
    """A function of (lp, tl, fl) that returns chip_smoke.py's `mas_kernel`
    launch of the variant and the outputs it writes; whether it is B4."""
    lib = ctypes.CDLL(str(lib_path))
    extract = hasattr(lib, "mas_extract_launch")
    fn = lib.mas_extract_launch if extract else lib.mas_wavefront_launch
    fn.argtypes = [ctypes.c_void_p] * (6 if extract else 5) + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return (lambda lp, tl, fl: cs.mas_kernel(mas, fn, 2 if extract else 1, lp, tl, fl)), extract


def check_and_time(name, lib_path) -> dict:
    prepare, extract = launcher(lib_path)
    res = {"name": name, "kernel": "B4" if extract else "B3", "cases_unequal": 0}
    if "_no" not in name:
        for seed, shape in enumerate((cs.MAS_SHAPE, (133, 300, 33), (3, 300, 384))):
            lp, tl, fl = inputs(*shape, seed)
            launch, outs = prepare(lp, tl, fl)
            launch()
            torch.cuda.synchronize()
            ds, bs = mas.extract_reference(lp, tl, fl)
            same = torch.equal(outs[0], ds) and (not extract or torch.equal(outs[1], bs))
            res["cases_unequal"] += not same
    for key, shape in (("ms", cs.MAS_SHAPE), ("ms_2x43x23", (2, 43, 23))):
        launch, _ = prepare(*inputs(*shape, 7))
        res[key] = min(cs.time_ms(launch, iters=50) for _ in range(2))
    return res


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print("RESULT " + json.dumps(check_and_time(argv[1], argv[2])), flush=True)
        return 0
    print(cs.card_line(), flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = {"shipped_b3": _build.CSRC / "mas_wavefront.cu",
               "shipped_b4": _build.CSRC / "mas_extract.cu",
               **{p.stem: p for p in sorted(Path(argv[0]).glob("*.cu"))}}
    built = build_all(sources)
    failed = len(sources) - len(built)
    for name, lib in built.items():
        proc = subprocess.run(["timeout", "-s", "KILL", "180", sys.executable, __file__, "--one",
                               name, str(lib)], capture_output=True, text=True)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not line:
            failed += 1
            print(f"{name}: run failed, rc {proc.returncode}: {proc.stderr[-600:]}", flush=True)
            continue
        print(line[0][len("RESULT "):], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
