"""The port's data-parallel train step (`make_train_step(cfg, mesh)`,
`parallel/mesh.py`) on the CPU: ranks of one gloo group, each stepping on
its shard of a global batch, against one process's step over the whole
batch, in the port and in JAX.

`tiny_experiment()`'s sizes with every dropout at 0, the same weights in
every process (JAX init -> `compat/from_jax.py`), segment starts sampled on
the host. The shards' token counts differ by more than 10%, so a rank
that divided by its own token count (the mean of the ranks' local means)
would fail.

Tolerances:
- ranks against the port's one process: logs rtol 1e-5 (float32 sums in
  another order: the token count and the spectral norms summed over the
  ranks), parameters after the step atol 1e-6, and the summed gradients
  within 2e-4 of each tensor's largest entry (tests/test_torch_train_step.py's
  GRAD_RTOL: the convolutions at the shards' batch sizes run other
  algorithms; measured <= 7.8e-5 in the vocoder trunk at one row a rank,
  and 5.1e-5 between oneDNN on and off in one process). Adam's first
  update lr g / (|g| + eps) turns a gradient difference d into a parameter
  difference up to lr eps d / g^2: entries where that bound passes 1e-7
  (gradients near eps) are held within 2 lr instead, and must be under 1%
  of every tensor;
- against JAX's one-process `make_train_step`: logs rtol 1e-4
  (tests/test_torch_train_step.py's LOG_RTOL).
The 4-rank hybrid mesh (2 x 2, the port of tests/test_multislice.py) and
gradient accumulation over 2 calls are held against the port's one
process.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optispeech_tpu.training.step import make_train_step as jax_make_train_step
from optispeech_tpu_torch.config import to_dict
from optispeech_tpu_torch.models.discriminator import VocosDiscriminator
from optispeech_tpu_torch.models.generator import OptiSpeechGenerator
from optispeech_tpu_torch.training.state import TrainState
from optispeech_tpu_torch.training.step import make_train_step
from test_train_step import tiny_experiment
from torch_dist import launch_ranks
from torch_parity import no_dropout, to_torch_config, train_batch, train_setup

torch.set_num_threads(1)

LOG_RTOL = 1e-5
PARAM_ATOL = 1e-6
JAX_LOG_RTOL = 1e-4
TOKEN_GAP = 0.10  # the shards' token counts differ by more than this share
GRAD_RTOL = 2e-4  # the summed gradients, relative to each tensor's largest entry
SENSITIVE = 1e-7  # Adam's bound on a parameter's difference above which it is held to 2 lr


def unequal_batch(rng, cfg, b, world):
    """`train_batch` with the first shard's texts long and the last's short."""
    batch = train_batch(rng, cfg, b=b)
    t_text = cfg.data.text_bucket_size
    per = b // world
    lengths = np.concatenate([np.full(per, t_text - 1 - 2 * r) for r in range(world)])
    lengths[::2] -= 1
    x = rng.integers(1, 100, (b, t_text)).astype(np.int32)
    x[np.arange(t_text)[None, :] >= lengths[:, None]] = 0
    counts = lengths.reshape(world, per).sum(axis=1)
    assert counts.max() > (1 + TOKEN_GAP) * counts.min(), counts
    return {**batch, "x": x, "x_lengths": lengths.astype(np.int32)}


def one_process(tcfg, g_sd, d_sd, batches):
    """The port's step over each whole batch in one process: (logs, state),
    the state's `calls` and `applied` holding, per module, the gradients
    of each call and of each applied update."""
    gen = OptiSpeechGenerator(tcfg.generator)
    gen.load_state_dict(g_sd)
    disc = VocosDiscriminator(tcfg.discriminator, tcfg.generator.features)
    disc.load_state_dict(d_sd)
    state = TrainState(tcfg, gen, disc, torch.Generator().manual_seed(0))
    state.calls, state.applied = {"g": [], "d": []}, {"g": [], "d": []}
    for part, opt in (("g", state.g_opt), ("d", state.d_opt)):
        update, apply = opt.update, opt._apply

        def recording_update(grads, update=update, part=part):
            state.calls[part].append([None if g is None else g.detach().clone()
                                      for g in grads])
            return update(grads)

        def recording_apply(grads, norm, apply=apply, part=part):
            state.applied[part].append([g.detach().clone() for g in grads])
            return apply(grads, norm)

        opt.update, opt._apply = recording_update, recording_apply
    step = make_train_step(tcfg)
    logs = [{k: float(v) for k, v in step(state, {k: torch.as_tensor(v) for k, v in b.items()})
             .items()} for b in batches]
    return logs, state


def ranks(tmp_path, world, tcfg, g_sd, d_sd, batches, mesh="flat"):
    """The worker's step on `world` ranks; returns each rank's record (the
    files, ~75 MB a rank at these sizes, are deleted once read)."""
    job = {"cfg": to_dict(tcfg), "g": g_sd, "d": d_sd, "batches": batches, "mesh": mesh}
    torch.save(job, tmp_path / "job.pt")
    launch_ranks(world, ["tests/torch_parallel_worker.py", "step", str(tmp_path / "job.pt"),
                         str(tmp_path)])
    records = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]
    for path in [tmp_path / "job.pt", *(tmp_path / f"rank{r}.pt" for r in range(world))]:
        path.unlink()
    return records


def assert_logs_close(got, want, rtol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-7, err_msg=k)


def assert_same_replicas(records):
    """Every rank ends with the same parameters, bit for bit."""
    for r in records[1:]:
        for part in ("g", "d"):
            for k, v in records[0][part].items():
                assert torch.equal(v, r[part][k]), (r["rank"], part, k)


def grad_gaps(record, state) -> dict:
    """Rank 0's summed gradients against one process's, call by call (G's
    turn, then D's), each within GRAD_RTOL of its tensor's largest entry.
    Returns per module the difference of the applied gradients (the mean
    over the calls), entry by entry."""
    gaps = {"g": [], "d": []}
    turns = iter(record["grads"])
    for want_g, want_d in zip(state.calls["g"], state.calls["d"]):
        for part, want in (("g", want_g), ("d", want_d)):
            got = next(turns)
            assert [g is None for g in got] == [w is None for w in want]
            for g, w in zip(got, want):
                if w is not None:
                    gap = float((g - w).abs().max())
                    assert gap <= GRAD_RTOL * float(w.abs().max()), (part, gap)
            gaps[part].append([None if w is None else g - w for g, w in zip(got, want)])
    return {part: [None if d[0] is None else (sum(d) / len(d)).abs() for d in zip(*calls)]
            for part, calls in gaps.items()}


def assert_params_close(record, state):
    """A rank's parameters against one process's (the module's tolerances;
    one applied update)."""
    gaps = grad_gaps(record, state)
    for part, module, opt in (("g", state.generator, state.g_opt),
                              ("d", state.discriminator, state.d_opt)):
        (grads,) = state.applied[part]
        lr, eps = opt.adamw.param_groups[0]["lr"], opt.adamw.param_groups[0]["eps"]
        for (name, p), g, d in zip(module.named_parameters(), grads, gaps[part]):
            diff = (record[part][name] - p.detach()).abs()
            d = torch.zeros_like(g) if d is None else d
            sensitive = lr * eps * d > SENSITIVE * (g.abs() + eps) ** 2
            assert float(torch.where(sensitive, 0.0, diff).max()) <= PARAM_ATOL, name
            assert float(torch.where(sensitive, diff, 0.0).max()) <= 2 * lr, name
            assert sensitive.float().mean() < 0.01, name
        for name, b in module.named_buffers():
            assert torch.equal(record[part][name], b), name


@pytest.fixture(scope="module")
def setup():
    cfg = no_dropout(tiny_experiment(pretraining_steps=0))
    jgen, jdisc, jstate, state = train_setup(cfg)
    g_sd = {k: v.clone() for k, v in state.generator.state_dict().items()}
    d_sd = {k: v.clone() for k, v in state.discriminator.state_dict().items()}
    return dict(cfg=cfg, jgen=jgen, jdisc=jdisc, jstate=jstate, g_sd=g_sd, d_sd=d_sd)


@pytest.fixture(scope="module")
def two_ranks(setup, tmp_path_factory):
    tcfg = to_torch_config(setup["cfg"])
    batch = unequal_batch(np.random.default_rng(0), setup["cfg"], 4, 2)
    records = ranks(tmp_path_factory.mktemp("two"), 2, tcfg, setup["g_sd"], setup["d_sd"],
                    [batch])
    logs, state = one_process(tcfg, setup["g_sd"], setup["d_sd"], [batch])
    return dict(batch=batch, records=records, logs=logs, state=state)


def test_two_ranks_equal_one_process_over_the_global_batch(two_ranks):
    records, state = two_ranks["records"], two_ranks["state"]
    batch = two_ranks["batch"]
    # each rank stepped on its own rows; together they are the batch
    for key in ("x", "wav_seg", "start_idx"):
        np.testing.assert_array_equal(
            np.concatenate([r["shards"][0][key].numpy() for r in records]), batch[key])
    for r in records:
        assert_logs_close(r["logs"][0], two_ranks["logs"][0], LOG_RTOL)
    assert_same_replicas(records)
    assert_params_close(records[0], state)
    # one reduction per turn (G, then D), each over every parameter's gradient
    n_g = sum(p.numel() for p in state.generator.parameters())
    n_d = sum(p.numel() for p in state.discriminator.parameters())
    assert records[0]["reduced"][1] == n_d and records[0]["reduced"][0] <= n_g
    assert len(records[0]["reduced"]) == 2


def test_two_ranks_equal_jax_one_process(setup, two_ranks):
    cfg = setup["cfg"]
    jstep = jax_make_train_step(cfg, setup["jgen"], setup["jdisc"])
    _, jlogs = jstep(setup["jstate"], {k: jnp.asarray(v) for k, v in two_ranks["batch"].items()})
    jlogs = {k: float(v) for k, v in jax.device_get(jlogs).items()}
    got = two_ranks["records"][0]["logs"][0]
    assert set(got) <= set(jlogs)
    assert_logs_close(got, {k: jlogs[k] for k in got}, JAX_LOG_RTOL)


def test_two_ranks_under_gradient_accumulation(setup, tmp_path):
    """gradient_accumulate_batches 2: the gradients are reduced at every
    call and the mean applied at the second, as in one process."""
    cfg = setup["cfg"]
    cfg = dataclasses.replace(cfg, train_args=dataclasses.replace(
        cfg.train_args, gradient_accumulate_batches=2))
    tcfg = to_torch_config(cfg)
    rng = np.random.default_rng(1)
    batches = [unequal_batch(rng, cfg, 4, 2) for _ in range(2)]
    records = ranks(tmp_path, 2, tcfg, setup["g_sd"], setup["d_sd"], batches)
    logs, state = one_process(tcfg, setup["g_sd"], setup["d_sd"], batches)
    assert state.g_opt.count == 1 and len(records[0]["reduced"]) == 4
    for r in records:
        for got, want in zip(r["logs"], logs):
            assert_logs_close(got, want, LOG_RTOL)
    assert_same_replicas(records)
    assert_params_close(records[0], state)


def test_hybrid_mesh_of_four_ranks_equals_one_process(setup, tmp_path):
    """A 2 x 2 (dcn_data, data) mesh: the gradient is summed over `data`,
    then over `dcn_data`; the step equals one process's over the batch."""
    tcfg = to_torch_config(setup["cfg"])
    batch = unequal_batch(np.random.default_rng(2), setup["cfg"], 4, 4)
    records = ranks(tmp_path, 4, tcfg, setup["g_sd"], setup["d_sd"], [batch], mesh="hybrid")
    logs, state = one_process(tcfg, setup["g_sd"], setup["d_sd"], [batch])
    np.testing.assert_array_equal(
        np.concatenate([r["shards"][0]["x"].numpy() for r in records]), batch["x"])
    for r in records:
        assert_logs_close(r["logs"][0], logs[0], LOG_RTOL)
    assert_same_replicas(records)
    assert_params_close(records[0], state)
