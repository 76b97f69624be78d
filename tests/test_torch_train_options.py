"""The train step's options against the JAX package on the CPU (mirroring
tests/test_train_options.py): gradient accumulation (`optax.MultiSteps`'s
role) and the recompute branch (`cache_generator_outputs=False`).
`tiny_experiment()`'s sizes, every dropout and drop-path rate at 0, the same
weights in both.

End to end, after every call of JAX's step and the port's, the logs agree
within rtol 1e-4, as one train step's do (tests/test_torch_train_step.py),
and so do the updates, p_after - p_before, of every tensor of G and D: the
port's within 2.2e-5 of the largest entry of JAX's update (the gradient
gate of tests/test_torch_train_step.py) plus two float32 spacings of the
tensor's largest entry, for the rounding of p + update in each package. An
update that is skipped, applied twice or computed from other waveforms is
far outside that.

Two choices in the set-up make the update a measure of the gradient:
- The optimiser runs with eps 1e3, no weight decay and a constant rate of
  1, so that Adam's step, lr * m / (sqrt(v) + eps), is about 1e-3 times
  the clipped gradient. At the default eps 1e-8 the first steps move every
  entry by about the learning rate whatever its gradient, and an entry whose
  gradient is near zero can move the other way in the two packages.
- D's biases start non-zero (normal, 0.05). With them at their initial
  zeros, JAX's jitted CPU step gives one MPD bias a gradient 3.7% (of the
  tensor's largest entry) away from its own unjitted step's, which the
  port's matches (scripts/port_train_parity_gaps.py); with non-zero biases
  the port's updates match the jitted step's within the gate above.
The optimiser at the default settings is held to optax's on shared
gradients, to 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from optispeech_tpu import config as jax_config
from optispeech_tpu.training.step import make_train_step as jax_make_train_step
from optispeech_tpu_torch.compat.from_jax import (
    discriminator_state_dict_from_jax_params,
    state_dict_from_jax_params,
)
from optispeech_tpu_torch.training.step import make_train_step
from test_train_step import tiny_experiment
from torch_parity import no_dropout, params_np, to_torch_config, train_batch, train_setup

torch.set_num_threads(1)

LOG_RTOL = 1e-4
GATE = 2.2e-5  # the gradient gate of tests/test_torch_train_step.py, on the update


def _with(cfg, **train_args):
    return dataclasses.replace(cfg, train_args=dataclasses.replace(cfg.train_args, **train_args))


def _linear_adam(cfg):
    """`cfg` with an optimiser whose step is about 1e-3 x the clipped gradient."""
    return dataclasses.replace(
        cfg, optimizer=jax_config.OptimizerConfig(lr=1.0, eps=1e3, weight_decay=0.0),
        scheduler=jax_config.SchedulerConfig(kind="constant"))


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _assert_close(got, expect, what, at_least=0.0, gate=GATE):
    """Each tensor of `got` (name -> torch tensor) within `gate` of the
    largest entry of its counterpart in `expect` (name -> numpy)."""
    assert set(got) == set(expect), what
    for k, g in got.items():
        ref = np.asarray(expect[k])
        np.testing.assert_allclose(g.detach().numpy(), ref, rtol=0,
                                   atol=gate * max(np.abs(ref).max(), at_least, 1e-12),
                                   err_msg=f"{what}: {k}")


def _update_gap(port_before, port_after, jax_before, jax_after):
    """The largest over the tensors of |port update - JAX update| over its
    tolerance (at most 1 passes), and that tensor's name."""
    worst = (0.0, "")
    for k, p0 in port_before.items():
        expect = np.asarray(jax_after[k]) - np.asarray(jax_before[k])
        got = port_after[k].detach().numpy() - p0.numpy()
        biggest = max(np.abs(np.asarray(jax_before[k])).max(), np.abs(np.asarray(jax_after[k])).max())
        tol = GATE * np.abs(expect).max() + 2 * np.spacing(np.float32(biggest))
        worst = max(worst, (float(np.abs(got - expect).max() / tol), k))
    return worst


def _assert_logs_match(logs, jlogs, what):
    assert set(logs) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=LOG_RTOL,
                                   atol=1e-7, err_msg=f"{what}: {k}")


def _adam_mu(opt_state):
    return next(s.mu for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _setup(cfg):
    """`train_setup` with D's biases drawn non-zero in both packages."""
    jgen, jdisc, jstate, state = train_setup(cfg)
    rng = np.random.default_rng(7)

    def draw(path, x):
        if "bias" not in jax.tree_util.keystr(path):
            return x
        return jnp.asarray(rng.normal(size=x.shape).astype(np.float32) * 0.05)

    jstate = jstate.replace(d_params=jax.tree_util.tree_map_with_path(draw, jstate.d_params))
    state.discriminator.load_state_dict(discriminator_state_dict_from_jax_params(
        params_np(jstate.d_params), to_torch_config(cfg).discriminator))
    return jgen, jdisc, jstate, state


def _params(module):
    return {k: p.detach().clone() for k, p in module.named_parameters()}


def _run_both(cfg, n_calls, seed, others=()):
    """n_calls steps of JAX's and the port's train step on the same
    micro-batches, compared after each call. `others` are configs whose port
    states take the same calls beside. Returns, per call, each part's
    update gap (`_update_gap`), whether G and D moved, and, per config of
    `others`, its D update's gap to JAX's."""
    jgen, jdisc, jstate, state = _setup(cfg)
    tcfg = to_torch_config(cfg)
    jstep, step = jax_make_train_step(cfg, jgen, jdisc), make_train_step(tcfg)
    beside = [(_setup(c)[3], make_train_step(to_torch_config(c))) for c in others]
    to_g = lambda t: state_dict_from_jax_params(params_np(t), tcfg.generator)  # noqa: E731
    to_d = lambda t: discriminator_state_dict_from_jax_params(params_np(t), tcfg.discriminator)  # noqa: E731
    rng = np.random.default_rng(seed)
    calls = []
    for i in range(n_calls):
        batch = train_batch(rng, cfg)
        g0, d0 = _params(state.generator), _params(state.discriminator)
        jg0, jd0 = to_g(jstate.g_params), to_d(jstate.d_params)
        others_d0 = [_params(s.discriminator) for s, _ in beside]
        jstate, jlogs = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        logs = step(state, _torch_batch(batch))
        _assert_logs_match(logs, jlogs, f"call {i}")
        jd1 = to_d(jstate.d_params)
        others_gap = []
        for (s, other_step), od0 in zip(beside, others_d0):
            other_step(s, _torch_batch(batch))
            others_gap.append(_update_gap(od0, dict(s.discriminator.named_parameters()), jd0, jd1))
        calls.append({
            "G": _update_gap(g0, dict(state.generator.named_parameters()), jg0,
                             to_g(jstate.g_params)),
            "D": _update_gap(d0, dict(state.discriminator.named_parameters()), jd0, jd1),
            "moved": tuple(any(not torch.equal(a, p) for a, p in zip(before.values(),
                                                                      m.parameters()))
                           for before, m in ((g0, state.generator), (d0, state.discriminator))),
            "others": others_gap,
        })
    return state, calls


@pytest.fixture(scope="module")
def accumulated():
    cfg = _with(_linear_adam(no_dropout(tiny_experiment(pretraining_steps=0))),
                gradient_accumulate_batches=2)
    return _run_both(cfg, n_calls=4, seed=21)


def test_accumulation_matches_jax_multisteps(accumulated):
    """k = 2 over 4 micro-batches: G's and D's updates and the logs after
    each call."""
    state, calls = accumulated
    assert state.step == 4
    assert state.g_opt.count == 2 and state.d_opt.count == 2
    for i, call in enumerate(calls):
        for part in ("G", "D"):
            gap, name = call[part]
            assert gap <= 1.0, f"call {i}: {part}'s update at {name}, {gap:.2f} x its tolerance"


def test_accumulation_applies_every_kth_call(accumulated):
    """G and D move on the 2nd and 4th calls and stay bit for bit the same
    on the others."""
    _, calls = accumulated
    assert [c["moved"] for c in calls] == [(False, False), (True, True)] * 2


def test_accumulating_optimizer_matches_optax_multisteps():
    """The port's optimiser and `optax.MultiSteps(make_optimizer(cfg), 2)`
    on the same four gradient sets, from the same weights: the running mean,
    Adam's first moment and the parameters after each call, to 1e-6 of each
    tensor's largest entry (at least 1 for the parameters)."""
    from optispeech_tpu.training.state import make_optimizer
    from optispeech_tpu_torch.models.generator import OptiSpeechGenerator
    from optispeech_tpu_torch.training.state import Optimizer

    cfg = _with(tiny_experiment(), gradient_accumulate_batches=2)
    jgen, jdisc, jstate, _ = train_setup(cfg)
    tcfg = to_torch_config(cfg)
    to_g = lambda t: state_dict_from_jax_params(t, tcfg.generator)  # noqa: E731
    opt = make_optimizer(cfg)
    update = jax.jit(lambda g, s, p: opt.update(g, s, p))
    params, opt_state = jstate.g_params, opt.init(jstate.g_params)
    gen = OptiSpeechGenerator(tcfg.generator)
    gen.load_state_dict(to_g(params_np(params)))
    port = Optimizer(gen.parameters(), tcfg)
    names = [k for k, _ in gen.named_parameters()]
    rng = np.random.default_rng(26)
    for i in range(4):
        grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)), params)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        port.update([to_g(params_np(grads))[k] for k in names])
        assert port.mini_step == (i + 1) % 2 and port.count == (i + 1) // 2
        _assert_close(dict(zip(names, port.acc)), to_g(params_np(opt_state.acc_grads)),
                      f"running mean after call {i}", gate=1e-6)
        if port.count:
            mu = [port.adamw.state[p]["exp_avg"] for p in port.params]
            _assert_close(dict(zip(names, mu)), to_g(params_np(_adam_mu(opt_state))),
                          f"first moment after call {i}", gate=1e-6)
        _assert_close(dict(gen.named_parameters()), to_g(params_np(params)),
                      f"parameters after call {i}", at_least=1.0, gate=1e-6)


@pytest.fixture(scope="module")
def recomputed():
    """Two calls of the recompute branch against JAX's, with a port state
    of the cached branch taking the same calls beside."""
    base = _linear_adam(no_dropout(tiny_experiment(pretraining_steps=0)))
    return _run_both(_with(base, cache_generator_outputs=False), n_calls=2, seed=22,
                     others=(_with(base, cache_generator_outputs=True),))


def test_recompute_branch_matches_jax(recomputed):
    """`cache_generator_outputs=False`: D trains on a second G forward,
    without gradients, through the updated G; G's and D's updates and the
    logs match JAX's after each call."""
    _, calls = recomputed
    for i, call in enumerate(calls):
        for part in ("G", "D"):
            gap, name = call[part]
            assert gap <= 1.0, f"call {i}: {part}'s update at {name}, {gap:.2f} x its tolerance"
        assert call["moved"] == (True, True)


def test_recompute_branch_trains_d_on_the_updated_generator(recomputed):
    """From the same weights, the cached branch's first D update (on the G
    turn's waveforms) is far outside the tolerance of JAX's recompute
    branch, so the check above tells the two branches apart."""
    _, calls = recomputed
    (gap, name), = calls[0]["others"]
    assert gap > 100.0, f"the cached branch's D update is only {gap:.2f} x the tolerance ({name})"


def test_recompute_branch_replays_the_step_rng():
    """With dropout on and the `wav` form, the recomputed forward replays the
    G turn's draws (dropout masks, segment starts) from a rewound RNG: the
    step leaves the RNG where a cached step leaves it, and G's update is
    the cached step's."""
    from optispeech_tpu_torch.training.state import init_train_state

    base = tiny_experiment(pretraining_steps=0)
    cfg = to_torch_config(_with(base, cache_generator_outputs=False))
    cached_cfg = to_torch_config(_with(base, cache_generator_outputs=True))
    batch = _torch_batch(train_batch(np.random.default_rng(23), cfg, b=2, host_seg=False))
    recompute = init_train_state(cfg, "cpu", seed=0)
    cached = init_train_state(cached_cfg, "cpu", seed=0)
    make_train_step(cfg)(recompute, batch)
    make_train_step(cached_cfg)(cached, batch)
    assert torch.equal(recompute.rng.get_state(), cached.rng.get_state())
    assert all(torch.equal(a, b) for a, b in zip(recompute.generator.parameters(),
                                                 cached.generator.parameters()))


def test_pretraining_gate_counts_optimizer_steps_under_accumulation():
    """pretraining_steps=1 with k=2: D is frozen for two micro-batches and
    trains on the third (tests/test_train_options.py:41-66)."""
    from optispeech_tpu_torch.training.state import init_train_state

    cfg = to_torch_config(_with(no_dropout(tiny_experiment(pretraining_steps=1)),
                                gradient_accumulate_batches=2))
    state = init_train_state(cfg, "cpu", seed=0)
    step = make_train_step(cfg)
    batch = _torch_batch(train_batch(np.random.default_rng(24), cfg))
    d0 = [p.detach().clone() for p in state.discriminator.parameters()]
    for _ in range(2):
        assert float(step(state, batch)["total_loss/discriminator"]) == 0.0
    assert all(torch.equal(a, p) for a, p in zip(d0, state.discriminator.parameters()))
    assert float(step(state, batch)["total_loss/discriminator"]) != 0.0


def test_accumulation_state_round_trips():
    """The optimiser's state dict carries the mean so far and its count."""
    from optispeech_tpu_torch.training.state import init_train_state

    cfg = to_torch_config(_with(no_dropout(tiny_experiment(pretraining_steps=0)),
                                gradient_accumulate_batches=3))
    state = init_train_state(cfg, "cpu", seed=0)
    make_train_step(cfg)(state, _torch_batch(train_batch(np.random.default_rng(25), cfg)))
    saved = state.g_opt.state_dict()
    assert saved["mini_step"] == 1 and saved["count"] == 0
    fresh = init_train_state(cfg, "cpu", seed=1)
    fresh.g_opt.load_state_dict(saved)
    assert all(torch.equal(a, b) for a, b in zip(fresh.g_opt.acc, state.g_opt.acc))
    no_accum = init_train_state(to_torch_config(no_dropout(tiny_experiment())), "cpu")
    with pytest.raises(ValueError, match="accumulation"):
        no_accum.g_opt.load_state_dict(saved)
