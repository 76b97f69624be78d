#!/usr/bin/env python3
"""Largest gaps between the PyTorch port and the JAX package on the CPU.

    JAX_PLATFORMS=cpu python scripts/port_parity_gaps.py

Same weights (JAX init, seed 0, through `state_dict_from_jax_params`) and
the same numpy inputs as tests/test_torch_synthesis.py and
tests/test_torch_fused_convnext.py; where those tests assert tolerances,
this prints the measured max |port - JAX| per output.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from optispeech_tpu.ops.pallas_convnext import convnext_block_fused as jax_block  # noqa: E402
from optispeech_tpu_torch.ops.fused_convnext import convnext_block_fused  # noqa: E402
from torch_parity import build_pair, full_width_config, random_tokens, small_config  # noqa: E402

FACTORS = (3.0, 1.3, 0.9)


def stage_gaps(pair, lengths, ids=(None, None), n_frames=None):
    japi, tapi = pair
    x, x_lengths = random_tokens(np.random.default_rng(1), lengths)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    jenc = {k: np.array(v) for k, v in japi._encode_jit(
        japi.params, j(x), j(x_lengths), j(ids[0]), j(ids[1]),
        *[jnp.float32(f) for f in FACTORS]).items()}
    t = lambda a: None if a is None else torch.tensor(a)  # noqa: E731
    with torch.no_grad():
        tenc = tapi.generator.encode(t(x).long(), t(x_lengths), t(ids[0]), t(ids[1]), *FACTORS)
    gaps = {k: float(np.abs(tenc[k].numpy() - jenc[k]).max()) for k in ("hidden", "pitch", "energy")}
    gaps["durations_equal"] = bool(np.array_equal(tenc["durations"].numpy(), jenc["durations"]))
    n = n_frames or -(-int(jenc["y_lengths"].max()) // 128) * 128
    y_lengths = np.minimum(jenc["y_lengths"], n).astype(np.int32)
    pitch = jenc["pitch"] if japi.cfg.generator.vocoder.f0_cond else None
    jdec = japi._decode_jit(japi.params, j(jenc["hidden"]), j(jenc["durations"]),
                            j(jenc["x_mask"]), j(y_lengths), n, pitch=j(pitch))
    with torch.no_grad():
        tdec = tapi.generator.decode(t(jenc["hidden"]), t(jenc["durations"]), t(jenc["x_mask"]),
                                     t(y_lengths), n, pitch=t(pitch))
    gaps["wav (decode on JAX's encode)"] = float(np.abs(tdec["wav"].numpy()
                                                        - np.asarray(jdec["wav"])).max())
    return gaps


def main():
    torch.set_num_threads(4)
    multi_ids = (np.array([2, 0, 1], np.int32), np.array([1, 0, 1], np.int32))
    cases = {
        "single speaker": (small_config(), [31, 12, 4], (None, None), None),
        "3 speakers x 2 languages": (small_config(num_speakers=3, languages=("en-us", "en-gb")),
                                     [31, 12, 4], multi_ids, None),
        "f0_cond": (small_config(f0_cond=True), [31, 12, 4], (None, None), None),
        "full width, 2 blocks per stack": (full_width_config(2), [30], (None, None), 128),
    }
    for name, (cfg, lengths, ids, n_frames) in cases.items():
        print(f"{name}: {stage_gaps(build_pair(cfg), lengths, ids, n_frames)}")
    rng = np.random.default_rng(1234)
    mk = lambda *s, sc=0.1: (rng.normal(size=s) * sc).astype(np.float32)  # noqa: E731
    c, inter = 128, 256
    args = [mk(2, 256, c, sc=0.5), mk(7, c), mk(c), 1.0 + mk(c), mk(c), mk(c, inter, sc=0.05),
            mk(inter, sc=0.02), mk(inter, c, sc=0.05), mk(c, sc=0.02), np.full((c,), 0.25, np.float32)]
    twin = convnext_block_fused(*[torch.from_numpy(a) for a in args]).numpy()
    for t_tile in (128, 256):
        ref = np.asarray(jax_block(*[jnp.asarray(a) for a in args], t_tile=t_tile, interpret=True))
        print(f"fused block twin vs JAX Pallas interpret (B=2 T=256 C=128 I=256, "
              f"t_tile {t_tile}): {float(np.abs(twin - ref).max()):.3e}")


if __name__ == "__main__":
    main()
