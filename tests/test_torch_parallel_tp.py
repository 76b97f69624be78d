"""Tensor-parallel synthesis in the port (`parallel/tp.py`) on the CPU: two
gloo ranks hold the model with its FFNs split over the `model` axis of a
1 x 2 (data, model) mesh, by JAX's name rule, and synthesise; the result
equals the replicated model's and JAX's `synthesise_on_device` at atol 2e-4
(tests/test_tensor_parallel.py's). The ConvNeXt model's `pwconv1` /
`pwconv2` (encoder, decoder, WaveNeXt trunk) and WaveNeXt's head
`linear_1` / `linear_2` are `ColwiseParallel` / `RowwiseParallel` DTensors;
the transformer model's `w_1` / `w_2` are `Conv1d`s split by channels by
hand. With the fused blocks asked for, a sharded block runs unfused, so the
result is unchanged.
"""

import dataclasses

import numpy as np
import pytest
import torch

from optispeech_tpu_torch.config import to_dict
from torch_dist import launch_ranks
from torch_parity import build_pair, random_tokens, small_config, to_torch_config

torch.set_num_threads(1)

ATOL = 2e-4
N_FRAMES = 96


def transformer_config():
    cfg = small_config()
    g = cfg.generator
    bb = lambda b: dataclasses.replace(b, kind="transformer", num_blocks=2,  # noqa: E731
                                       linear_units=64)
    return dataclasses.replace(cfg, generator=dataclasses.replace(
        g, encoder=bb(g.encoder), decoder=bb(g.decoder)))


@pytest.mark.parametrize("kind", ["convnext", "transformer"])
def test_tensor_parallel_synthesis_equals_replicated_and_jax(kind, tmp_path):
    cfg = small_config() if kind == "convnext" else transformer_config()
    japi, tapi = build_pair(cfg)
    x, x_lengths = random_tokens(np.random.default_rng(3), [29, 17, 6])
    from optispeech_tpu_torch.values import InferenceInputs

    inputs = InferenceInputs(clean_text="", x=x, x_lengths=x_lengths, d_factor=2.0)
    want = japi.synthesise_on_device(inputs, n_frames=N_FRAMES)
    job = {"cfg": to_dict(to_torch_config(cfg)), "g": tapi.generator.state_dict(), "x": x,
           "x_lengths": x_lengths, "d_factor": 2.0, "n_frames": N_FRAMES}
    torch.save(job, tmp_path / "job.pt")
    launch_ranks(2, ["tests/torch_parallel_worker.py", "tp", str(tmp_path / "job.pt"),
                     str(tmp_path)])
    records = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]

    split = records[0]["split"]
    names = ("pwconv1", "pwconv2", "linear_1", "linear_2") + (
        ("w_1", "w_2") if kind == "transformer" else ())
    for name in names:
        assert any(name in k for k in split), name
    for k, (full, local, placements) in split.items():
        column = any(n in k for n in ("pwconv1", "w_1", "linear_1"))
        if k.endswith("bias") and not column:  # a row-parallel bias stays whole
            assert full == local and "Replicate()" in placements, (k, placements)
            continue
        dim = 0 if column else 1  # output features (columns), or input features
        assert local[dim] * 2 >= full[dim] > local[dim], (k, full, local)
        assert f"Shard(dim={dim})" in placements, (k, placements)
    if kind == "transformer":
        assert any(".w_1.weight" in k for k in split) and any(".w_2.weight" in k for k in split)
    for r in records:
        for out in ("sharded", "fused_asked"):
            np.testing.assert_array_equal(r[out]["durations"].numpy(),
                                          r["replicated"]["durations"].numpy())
            np.testing.assert_allclose(r[out]["wav"].numpy(), r["replicated"]["wav"].numpy(),
                                       atol=ATOL)
            np.testing.assert_allclose(r[out]["wav"].numpy(), np.asarray(want["wav"]), atol=ATOL)
        np.testing.assert_array_equal(r["fused_asked"]["wav"].numpy(), r["sharded"]["wav"].numpy())
    np.testing.assert_array_equal(records[0]["sharded"]["wav"].numpy(),
                                  records[1]["sharded"]["wav"].numpy())
