"""`cli/train.py --distributed --device cpu` on 2 gloo ranks, launched by
`python -m torch.distributed.run --standalone` at tests/test_torch_trainer.py's
sizes (CLI_OVERRIDES, dropout on), without JAX:
- 2 steps, exit, relaunch to 4, against an uninterrupted 4-step run: the
  same parameters, optimiser states and logs at steps 3 and 4 (1e-6), and
  every rank's parameter digest the same (the port of
  tests/test_multihost_ckpt.py); the per-rank step RNGs, saved by rank 0
  and restored rank by rank, are what makes the dropout masks agree;
- only rank 0 writes metrics, checkpoints, TensorBoard events and the
  inference checkpoint;
- the validation logs are the global batch's: one process's validation
  step over both shards put together, from the step-2 checkpoint, within
  rtol 1e-5;
- `--packed-train` with `--device-cache` trains on 2 ranks.
Each launch's processes run under a time limit and die together; the
group's collectives give up after `torch_dist.GROUP_TIMEOUT_S`.
"""

import json
import re
import shutil

import numpy as np
import pytest
import torch

from optispeech_tpu_torch.training.checkpoint import TrainCheckpointManager
from test_torch_trainer import CLI_OVERRIDES
from torch_dist import GROUP_TIMEOUT_S, base_env, tf_stub, torchrun

torch.set_num_threads(1)

STEP_ATOL = 1e-6
VAL_RTOL = 1e-5  # float32 sums of the shards' shares in another order
DIGEST = re.compile(r"rank (\d+): parameter digest ([0-9a-f]{64}) at step (\d+)")


def train(out, env, *flags, steps):
    output = torchrun(2, ["optispeech_tpu_torch.cli.train", "--distributed", "--device", "cpu",
                          "--dist-timeout", str(GROUP_TIMEOUT_S), "--max-steps", str(steps),
                          "--out-dir", str(out), "--no-print-config", *flags, *CLI_OVERRIDES],
                      env=env)
    digests = {int(r): (d, int(s)) for r, d, s in DIGEST.findall(output)}
    assert set(digests) == {0, 1}, output[-3000:]
    assert digests[0] == digests[1], digests
    return digests[0]


def rows(out):
    return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    env = base_env(tf_stub(root))
    resumed, straight = root / "resumed", root / "straight"
    first = train(resumed, env, "--synthetic", steps=2)
    second = train(resumed, env, "--synthetic", steps=4)
    whole = train(straight, env, "--synthetic", steps=4)
    yield dict(resumed=resumed, straight=straight, digests=(first, second, whole))
    shutil.rmtree(root)  # ~0.7 GB of checkpoints at these sizes


def test_resumed_run_equals_an_uninterrupted_one(runs):
    first, second, whole = runs["digests"]
    assert first[1] == 2 and second[1] == whole[1] == 4
    assert second[0] == whole[0]  # the parameters, bit for bit
    a, _ = TrainCheckpointManager(str(runs["resumed"] / "checkpoints")).read(4)
    b, _ = TrainCheckpointManager(str(runs["straight"] / "checkpoints")).read(4)
    for part in ("generator", "discriminator"):
        for k, v in b[part].items():
            np.testing.assert_allclose(a[part][k].numpy(), v.numpy(), atol=STEP_ATOL, err_msg=k)
    for opt in ("g_opt", "d_opt"):
        for i, s in b[opt]["adamw"]["state"].items():
            for k, v in s.items():
                np.testing.assert_allclose(a[opt]["adamw"]["state"][i][k].numpy(), v.numpy(),
                                           atol=STEP_ATOL, err_msg=f"{opt} {i} {k}")
    assert len(a["rngs"]) == len(b["rngs"]) == 2
    assert all(torch.equal(x, y) for x, y in zip(a["rngs"], b["rngs"]))
    assert not torch.equal(a["rngs"][0], a["rngs"][1])  # each rank draws its own masks
    want = {r["step"]: r for r in rows(runs["straight"]) if "total_loss/generator" in r}
    got = {r["step"]: r for r in rows(runs["resumed"]) if "total_loss/generator" in r}
    for step in (3, 4):
        for k, v in want[step].items():
            if not k.startswith("perf/"):
                np.testing.assert_allclose(got[step][k], v, rtol=STEP_ATOL, err_msg=k)


def test_only_rank_zero_writes(runs):
    out = runs["straight"]
    logged = rows(out)
    keyed = [(r["step"], tuple(sorted(r))) for r in logged]
    assert len(keyed) == len(set(keyed)), "a metrics row written twice"
    assert sum(1 for r in logged if "total_loss/generator" in r) == 4
    assert sum(1 for r in logged if "total_loss/val_total" in r) == 2
    csv = (out / "metrics.csv").read_text().splitlines()
    assert len(csv) == len(set(csv))
    assert len(list(out.glob("events.out.tfevents.*"))) == 1  # one launch, one writer
    assert len(list(runs["resumed"].glob("events.out.tfevents.*"))) == 2
    ckpt = out / "checkpoints"
    assert sorted(p.name for p in ckpt.iterdir()) == ["4", "config.json", "loader_state-4.json"]
    assert sorted(p.name for p in (out / "inference_ckpt").iterdir()) == ["config.json",
                                                                         "generator.pt"]


def test_validation_logs_are_the_global_batch(runs):
    """The step-2 validation of the resumed run's first launch, against one
    process's validation step over the global batch: both ranks' rows,
    with the segment starts each rank drew from its own stream."""
    from optispeech_tpu_torch.cli.train import build_loaders
    from optispeech_tpu_torch.ops.segments import (
        host_sample_segment_starts,
        host_slice_wav_segments,
    )
    from optispeech_tpu_torch.training.state import RANK_SEED_STRIDE, init_train_state
    from optispeech_tpu_torch.training.step import make_val_step
    from optispeech_tpu_torch.utils.yamlcfg import load_experiment

    cfg = load_experiment("default", CLI_OVERRIDES)
    state = init_train_state(cfg, "cpu", seed=cfg.seed)
    TrainCheckpointManager(str(runs["resumed"] / "checkpoints")).restore(state, 2)
    _, val = build_loaders(cfg, synthetic=True)
    (batch,) = list(val)  # one global batch of data.batch_size
    seg = min(cfg.generator.segment_size, batch["mel"].shape[-1])
    hop = cfg.generator.features.hop_length
    half = cfg.data.batch_size // 2
    starts = np.concatenate([host_sample_segment_starts(
        np.random.default_rng((cfg.seed * 1_000_003 + rank * RANK_SEED_STRIDE + 2 * 131)
                              & 0x7FFFFFFF), batch["mel_lengths"][rank * half:(rank + 1) * half],
        seg) for rank in range(2)])
    keys = ("x", "mel", "x_lengths", "mel_lengths", "energies", "pitches")
    one = {k: torch.as_tensor(batch[k]) for k in keys}
    one["start_idx"] = torch.as_tensor(starts)
    one["wav_seg"] = torch.as_tensor(host_slice_wav_segments(batch["wav"], starts, seg, hop))
    logs, _, _ = make_val_step(cfg)(state, one)
    (logged,) = [r for r in rows(runs["resumed"]) if "total_loss/val_total" in r and r["step"] == 2]
    for k, v in logs.items():
        np.testing.assert_allclose(logged[k], float(v), rtol=VAL_RTOL, err_msg=k)


def test_packed_device_cache_trains_on_two_ranks(tmp_path):
    from optispeech_tpu_torch.data.packed import pack_dataset
    from torch_packed_data import HOP, N_FEATS, write_datafiles

    pak = pack_dataset(str(write_datafiles(tmp_path, n=12)), str(tmp_path / "t.pak"), N_FEATS,
                       HOP)
    out = tmp_path / "cache"
    digest, step = train(out, base_env(tf_stub(tmp_path)), "--packed-train", pak,
                         "--packed-val", pak, "--device-cache", "data.max_mel_len=128",
                         "data.mel_bucket_size=64", steps=2)
    assert step == 2 and (out / "checkpoints" / "2" / "state.pt").exists()
    logged = rows(out)
    assert sum(1 for r in logged if "total_loss/generator" in r) == 2
    assert any("total_loss/val_total" in r for r in logged)
    assert all(np.isfinite(v) for r in logged for v in r.values())
    shutil.rmtree(out)
