"""The port's GAN train step (training/step.py) against the JAX package's
`make_train_step` on the CPU: `tiny_experiment()`'s sizes, every dropout and
drop-path rate at 0, segment starts sampled on the host (`start_idx` +
`wav_seg`), the same weights in both.

JAX's step runs once with a pass-through optimiser whose state keeps the
gradients it is handed, so one compile gives the logs and the G and D
gradients; the optimiser is then held apart, on those same gradients. The
port's step records its gradients the same way, by wrapping
`Optimizer.update`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from optispeech_tpu.training.state import make_optimizer
from optispeech_tpu.training.step import make_train_step as jax_make_train_step
from optispeech_tpu_torch.compat.from_jax import (
    discriminator_state_dict_from_jax_params,
    state_dict_from_jax_params,
)
from optispeech_tpu_torch.training.step import make_train_step
from test_train_step import tiny_experiment
from torch_parity import no_dropout, params_np, to_torch_config, train_batch, train_setup

torch.set_num_threads(1)

# logs of one step: float32 with other summation orders; measured <= 2e-6
LOG_RTOL = 1e-4
# gradients, per tensor, relative to the tensor's largest entry: measured
# <= 2.2e-5 (the vocoder trunk, behind the MR-STFT and mel losses)
GRAD_RTOL = 2e-4


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _record_gradients(state):
    grads = {}
    for name, opt in (("g", state.g_opt), ("d", state.d_opt)):
        update = opt.update

        def recording(g, update=update, name=name):
            grads[name] = [x if x is None else x.clone() for x in g]
            return update(g)

        opt.update = recording
    return grads


@pytest.fixture(scope="module")
def run():
    cfg = no_dropout(tiny_experiment(pretraining_steps=0))
    jgen, jdisc, jstate, state = train_setup(cfg)
    batch = train_batch(np.random.default_rng(0), cfg)

    passthrough = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda g, s, params=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    jstep = jax_make_train_step(cfg, jgen, jdisc, optimizer=passthrough)
    start = jstate.replace(g_opt_state=passthrough.init(jstate.g_params),
                           d_opt_state=passthrough.init(jstate.d_params))
    jnew, jlogs = jstep(start, {k: jnp.asarray(v) for k, v in batch.items()})

    tcfg = to_torch_config(cfg)
    g_before = {k: v.clone() for k, v in state.generator.state_dict().items()}
    grads = _record_gradients(state)
    logs = make_train_step(tcfg)(state, _torch_batch(batch))
    return dict(cfg=cfg, tcfg=tcfg, jstate=jstate, jnew=jnew, jlogs=jlogs, state=state,
                logs=logs, grads=grads, g_before=g_before)


def test_step_logs_match_jax(run):
    jlogs, logs = run["jlogs"], run["logs"]
    assert set(logs) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=LOG_RTOL, err_msg=k)
    assert run["state"].step == 1


def _assert_gradients(named_params, grads, expect):
    assert {k for k, _ in named_params} == set(expect)
    for (k, p), g in zip(named_params, grads):
        ref = expect[k].numpy()
        got = np.zeros_like(ref) if g is None else g.numpy()
        np.testing.assert_allclose(got, ref, atol=GRAD_RTOL * max(np.abs(ref).max(), 1e-12),
                                   err_msg=k)


def test_generator_gradients_match_jax(run):
    """Against `jax.grad` of JAX's G loss (as the pass-through optimiser saw
    it), leaf by leaf through the bridge's layout."""
    expect = state_dict_from_jax_params(params_np(run["jnew"].g_opt_state),
                                        run["tcfg"].generator)
    named = list(run["state"].generator.named_parameters())
    _assert_gradients(named, run["grads"]["g"], expect)
    # the decoder feeds only the detached vocoder segment: no gradient, as in JAX
    decoder = [g for (k, _), g in zip(named, run["grads"]["g"]) if k.startswith("decoder.")]
    assert decoder and all(g is None for g in decoder)


def test_discriminator_gradients_match_jax(run):
    expect = discriminator_state_dict_from_jax_params(params_np(run["jnew"].d_opt_state),
                                                      run["tcfg"].discriminator)
    _assert_gradients(list(run["state"].discriminator.named_parameters()), run["grads"]["d"],
                      expect)


def test_optimizer_on_jax_gradients_matches_optax(run):
    """Two AdamW + clip updates on JAX's gradients, from JAX's weights, in
    both packages. The updates differ by float32 rounding only (torch's
    p * (1 - lr * wd) - lr * u against optax's p - lr * (u + wd * p)):
    held to 1e-6, scaled by the tensor's largest weight where that is above 1."""
    from optispeech_tpu_torch.models.generator import OptiSpeechGenerator
    from optispeech_tpu_torch.training.state import Optimizer

    cfg, tcfg, jstate = run["cfg"], run["tcfg"], run["jstate"]
    jgrads = run["jnew"].g_opt_state
    opt = make_optimizer(cfg)

    @jax.jit
    def update(g, opt_state, params):
        updates, opt_state = opt.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    params, opt_state = jstate.g_params, opt.init(jstate.g_params)
    for scale in (1.0, -0.5):  # the second step flips and halves the gradient
        params, opt_state = update(jax.tree_util.tree_map(lambda x: x * scale, jgrads),
                                   opt_state, params)
    expect = state_dict_from_jax_params(params_np(params), tcfg.generator)

    gen = OptiSpeechGenerator(tcfg.generator)
    gen.load_state_dict(state_dict_from_jax_params(params_np(jstate.g_params), tcfg.generator))
    grads = state_dict_from_jax_params(params_np(jgrads), tcfg.generator)
    port_opt = Optimizer(gen.parameters(), tcfg)
    for scale in (1.0, -0.5):
        port_opt.update([grads[k] * scale for k, _ in gen.named_parameters()])
    assert port_opt.count == 2
    for k, p in gen.named_parameters():
        ref = expect[k].numpy()
        np.testing.assert_allclose(p.detach().numpy(), ref,
                                   atol=1e-6 * max(np.abs(ref).max(), 1.0), err_msg=k)


def test_clip_and_schedule_follow_optax():
    """Clip as optax does (scale by max/norm only when norm > max, no
    epsilon); the rate at count 0 is lr / warmup, not 0."""
    from optispeech_tpu.training.schedules import cosine_with_warmup as jax_schedule
    from optispeech_tpu_torch.training.schedules import cosine_with_warmup
    from optispeech_tpu_torch.training.state import Optimizer

    # float32 on both sides; XLA's cos and numpy's may differ in the last ulp
    for step in (0, 1, 9, 10, 11, 55, 99, 100, 250):
        assert cosine_with_warmup(2e-4, 10, 100)(step) == pytest.approx(
            float(jax_schedule(2e-4, 10, 100)(step)), rel=1e-6, abs=0)
    tcfg = to_torch_config(tiny_experiment())
    for norm in (3.0, 40.0):
        p = torch.nn.Parameter(torch.zeros(4))
        opt = Optimizer([p], tcfg)
        g = torch.tensor([norm, 0.0, 0.0, 0.0])
        assert float(opt.update([g])) == norm
        assert float(p[0]) == pytest.approx(-2e-4 / 10, rel=1e-5)  # Adam's first step: lr
        expect = optax.clip_by_global_norm(10.0).update(jnp.asarray(g.numpy()), None)[0]
        opt.update([g])  # the clip decides the second moment's ratio
        np.testing.assert_allclose(opt.adamw.state[p]["exp_avg"].numpy() / 0.36,
                                   np.asarray(expect), rtol=1e-6)


def test_pretraining_gate():
    """Before `pretraining_steps`, D is untouched and the adversarial logs
    are 0; G still trains."""
    cfg = to_torch_config(no_dropout(tiny_experiment(pretraining_steps=100)))
    from optispeech_tpu_torch.training.state import init_train_state

    state = init_train_state(cfg, "cpu", seed=0)
    d_before = {k: v.clone() for k, v in state.discriminator.state_dict().items()}
    g_before = {k: v.clone() for k, v in state.generator.state_dict().items()}
    batch = _torch_batch(train_batch(np.random.default_rng(1), cfg))
    logs = make_train_step(cfg)(state, batch)
    assert all(torch.equal(v, d_before[k]) for k, v in state.discriminator.state_dict().items())
    assert all(p.grad is None for p in state.discriminator.parameters())
    assert state.d_opt.count == 0 and state.g_opt.count == 1
    assert any(not torch.equal(v, g_before[k]) for k, v in state.generator.state_dict().items())
    for k in ("total_loss/train_gen_adv_loss", "total_loss/discriminator",
              "grad_norm/discriminator", "gen_adv_loss/train_mel_loss"):
        assert float(logs[k]) == 0.0, k
    assert np.isfinite(float(logs["total_loss/generator"]))


def test_wav_form_matches_wav_seg_form():
    """The `wav` batch form (starts drawn from the state's RNG, ground truth
    cropped on the device) against the `wav_seg` form fed the same starts."""
    from optispeech_tpu_torch.ops.segments import host_slice_wav_segments
    from optispeech_tpu_torch.training.state import init_train_state

    cfg = to_torch_config(no_dropout(tiny_experiment(pretraining_steps=0)))
    batch = train_batch(np.random.default_rng(2), cfg, host_seg=False)
    seg = min(cfg.generator.segment_size, cfg.data.mel_bucket_size)
    # with no dropout the segment draw is the RNG's only use
    u = torch.rand(len(batch["x"]), generator=torch.Generator().manual_seed(0)).numpy()
    max_start = np.maximum(np.maximum(batch["mel_lengths"] - 4, 1) - seg, 0)
    starts = np.floor(u * max_start).astype(np.int32)
    host = {k: v for k, v in batch.items() if k != "wav"}
    host.update(start_idx=starts, wav_seg=host_slice_wav_segments(
        batch["wav"], starts, seg, cfg.generator.features.hop_length))
    step = make_train_step(cfg)
    logs_wav = step(init_train_state(cfg, "cpu", seed=0), _torch_batch(batch))
    logs_seg = step(init_train_state(cfg, "cpu", seed=0), _torch_batch(host))
    for k in logs_wav:
        np.testing.assert_allclose(float(logs_wav[k]), float(logs_seg[k]), rtol=1e-6, err_msg=k)


def test_segment_size_exceeding_mel_bucket_is_clamped():
    """segment_size 96 > the 64-frame mel bucket: the generator clamps its
    segment, and the ground-truth crop follows it (test_train_step.py:177)."""
    from optispeech_tpu_torch.training.state import init_train_state

    cfg = tiny_experiment(pretraining_steps=0)
    cfg = to_torch_config(dataclasses.replace(
        cfg, generator=dataclasses.replace(cfg.generator, segment_size=96)))
    state = init_train_state(cfg, "cpu", seed=0)
    logs = make_train_step(cfg)(state, _torch_batch(train_batch(np.random.default_rng(3), cfg,
                                                                b=2, host_seg=False)))
    assert np.isfinite(float(logs["total_loss/generator"]))
    assert np.isfinite(float(logs["total_loss/discriminator"]))


def test_a_fixed_generator_reproduces_a_step_with_dropout():
    """The published dropout and drop-path rates, the `wav` form: the same
    seed gives the same step, another seed another one."""
    from optispeech_tpu_torch.training.state import init_train_state

    cfg = to_torch_config(tiny_experiment(pretraining_steps=0))
    batch = _torch_batch(train_batch(np.random.default_rng(4), cfg, b=2, host_seg=False))
    step = make_train_step(cfg)

    def one_step(seed):
        state = init_train_state(cfg, "cpu", seed=0)
        state.rng.manual_seed(seed)
        return step(state, batch)["total_loss/generator"]

    a, b, c = one_step(5), one_step(5), one_step(6)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_accumulation_is_not_ported_yet():
    """The name is kept from when accumulation raised; accumulation is
    ported now (tests/test_torch_train_options.py holds it against
    optax.MultiSteps). A state with k = 2 builds a running-mean buffer per
    parameter, and one without builds none."""
    from optispeech_tpu_torch.training.state import init_train_state

    cfg = to_torch_config(tiny_experiment())
    assert init_train_state(cfg, "cpu").g_opt.acc is None
    cfg = dataclasses.replace(cfg, train_args=dataclasses.replace(
        cfg.train_args, gradient_accumulate_batches=2))
    opt = init_train_state(cfg, "cpu").g_opt
    assert opt.every == 2 and opt.mini_step == 0
    assert [a.shape for a in opt.acc] == [p.shape for p in opt.params]
