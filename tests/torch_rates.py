"""One train step, port against JAX on the CPU, at a configs/*.yaml feature
block (tests/test_torch_rate_48k.py, _22k.py; the validation step is
tests/test_torch_rate_val.py).

A test module sets `CONFIG` (the YAML's name) and imports the fixture and
tests below; each module is one worker's job under `--dist loadfile`, so the
two rates' JAX compiles run side by side. The widths are
`torch_parity.TEST_WIDTHS`; the feature block (rate, 100 mels, n_fft, hop,
win, f_min, f_max) is the file's own; the batch is `train_batch`'s 4 items.

Tolerances are tests/test_torch_train_step.py's: logs rtol 1e-4, gradients
per tensor 2e-4 of the tensor's largest entry. The discriminators' leaky
ReLUs make D's gradient a discontinuous function of their pre-activations:
at these rates a step computes millions of them, and float32 rounding puts
one or two within a rounding step of 0, on the other side than in exact
arithmetic, in one package or the other in most steps, and the layers of
that sub-discriminator below the element move by more than the bound
(scripts/port_rate_gradient_gaps.py prints by how much). So D's gradient
is held three ways, each tensor at the bound:
- in float64, where no pre-activation sits that close to 0: JAX's
  `forward_disc` under `jax.enable_x64` and the port's (with a float64 copy
  of its STFT) on the port's D-turn inputs: the same function;
- the port's float32 gradient from its step against the port's float64
  gradient with the leaky ReLUs' sides taken from the port's own float32
  forward: its float32 arithmetic is exact up to its kink decisions;
- the port's float32 gradient against JAX's float32 gradient, except in a
  sub-discriminator where the port's float32 forward put a pre-activation
  on the other side of a kink than float64 does, or where JAX's float32
  gradient is off the float64 one and the port's on it.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from optispeech_tpu.models.discriminator.vocos import VocosDiscriminator as JaxDisc
from optispeech_tpu.training.step import make_train_step as jax_make_train_step
from optispeech_tpu_torch import config as torch_config
from optispeech_tpu_torch.compat.from_jax import (
    discriminator_state_dict_from_jax_params,
    state_dict_from_jax_params,
)
from optispeech_tpu_torch.models.discriminator import critics
from optispeech_tpu_torch.models.discriminator.vocos import VocosDiscriminator
from optispeech_tpu_torch.ops import stft
from optispeech_tpu_torch.training.step import make_train_step
from torch_parity import params_np, to_torch_config, train_batch, train_setup, yaml_config

torch.set_num_threads(1)

LOG_RTOL = 1e-4
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


def _stft_magnitude_f64(x, n_fft, hop_length, win_length=None, window="hann", center=True,
                        magnitude_floor=0.0):
    """`ops/stft.py::stft_magnitude` for the MRD's rectangular window, in
    float64 (the port's keeps float32 DFT bases)."""
    assert window == "ones" and center and not magnitude_floor and win_length == n_fft
    frames = stft._reflect_pad(x, n_fft // 2).unfold(-1, n_fft, hop_length)
    ang = -2.0 * np.pi * np.outer(np.arange(n_fft), np.arange(n_fft // 2 + 1)) / n_fft
    re, im = frames @ torch.from_numpy(np.cos(ang)), frames @ torch.from_numpy(np.sin(ang))
    return torch.sqrt(torch.clamp(re * re + im * im, min=1e-14))


def _disc_grads(tcfg, turn, dtype, sides=None, record=None):
    """D's gradient on the port's D-turn inputs in `dtype` (float64 with a
    float64 STFT). Each leaky ReLU records its input's sides into `record`
    and takes them from `sides` (a list, consumed in call order) if given."""
    disc = VocosDiscriminator(tcfg.discriminator, tcfg.generator.features)
    disc.load_state_dict(turn["state_dict"])
    disc = disc.to(dtype)

    def leaky_relu(x):
        side = x >= 0
        if record is not None:
            record.append(side)
        if sides is not None:
            side = sides.pop(0)
        return torch.where(side, x, x * critics.LRELU_SLOPE)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(critics, "_leaky_relu", leaky_relu)
        if dtype == torch.float64:
            mp.setattr(critics, "stft_magnitude", _stft_magnitude_f64)
        loss, _ = disc.forward_disc(turn["wav"].to(dtype), turn["wav_hat"].to(dtype))
    assert sides is None or not sides
    names = [k for k, _ in disc.named_parameters()]
    return dict(zip(names, torch.autograd.grad(loss, list(disc.parameters()))))


def _jax_disc_references(tcfg, jdisc, d_params, turn):
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), d_params)
        loss_fn = lambda p: jdisc.apply(  # noqa: E731
            {"params": p}, jnp.asarray(turn["wav"].double().numpy()),
            jnp.asarray(turn["wav_hat"].double().numpy()), method=JaxDisc.forward_disc)[0]
        grads = jax.jit(jax.grad(loss_fn))(p64)
        assert jax.tree_util.tree_leaves(grads)[0].dtype == jnp.float64
        return discriminator_state_dict_from_jax_params(params_np(grads), tcfg.discriminator)


def _disc_references(tcfg, jdisc, d_params, turn):
    """D's gradients on the port's D-turn inputs: the port's in float32 (its
    leaky ReLUs' sides recorded), in float64, and in float64 at those sides;
    JAX's in float64; and the sub-discriminators where the port's float32
    sides differ from float64's (each sub-discriminator makes 5 leaky ReLU
    calls on the real and 5 on the generated waveform, in order)."""
    sides32, sides64 = [], []
    port32 = _disc_grads(tcfg, turn, torch.float32, record=sides32)
    exact = _disc_grads(tcfg, turn, torch.float64, record=sides64)
    at_port_sides = _disc_grads(tcfg, turn, torch.float64, sides=list(sides32))
    d = tcfg.discriminator
    subs = ([f"multiperioddisc.discriminators.{j}" for j in range(len(d.periods))]
            + [f"multiresddisc.discriminators.{j}" for j in range(len(d.resolutions))])
    assert len(sides32) == len(sides64) == 10 * len(subs)
    flipped = {subs[i // 10] for i, (a, b) in enumerate(zip(sides32, sides64))
               if not torch.equal(a, b)}
    return dict(port32=port32, exact=exact, at_port_sides=at_port_sides, flipped=flipped,
                jax=_jax_disc_references(tcfg, jdisc, d_params, turn))


def rate_step(name):
    """configs/<name>.yaml at the tests' widths: one compile of JAX's step
    with a pass-through optimiser (its state keeps the gradients), the
    port's step on the same weights and batch with its D-turn inputs kept,
    and D's reference gradients on them
    (scripts/port_rate_gradient_gaps.py prints their gaps)."""
    cfg = yaml_config(name, "data.text_processor.tokenizer=en-g2p")
    jgen, jdisc, jstate, state = train_setup(cfg)
    tcfg = to_torch_config(cfg)
    batch = train_batch(np.random.default_rng(0), cfg)

    passthrough = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda g, s, params=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    jstep = jax_make_train_step(cfg, jgen, jdisc, optimizer=passthrough)
    start = jstate.replace(g_opt_state=passthrough.init(jstate.g_params),
                           d_opt_state=passthrough.init(jstate.d_params))
    jnew, jlogs = jstep(start, {k: jnp.asarray(v) for k, v in batch.items()})

    grads, turn = _record_gradients(state), {}
    forward_disc = VocosDiscriminator.forward_disc

    def keep_inputs(disc, wav, wav_hat, mesh=None):
        turn.update(wav=wav.detach().clone(), wav_hat=wav_hat.detach().clone(),
                    state_dict=copy.deepcopy(disc.state_dict()))
        return forward_disc(disc, wav, wav_hat, mesh)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(VocosDiscriminator, "forward_disc", keep_inputs)
        logs = make_train_step(tcfg)(state, _torch_batch(batch))
    d64 = _disc_references(tcfg, jdisc, jstate.d_params, turn)
    return dict(name=name, cfg=cfg, tcfg=tcfg, jnew=jnew, jlogs=jlogs,
                state=state, logs=logs, grads=grads, d64=d64)


@pytest.fixture(scope="module")
def run(request):
    return rate_step(request.module.CONFIG)


def test_config_keeps_its_feature_block(run):
    from optispeech_tpu.utils.yamlcfg import load_experiment

    published = load_experiment(run["name"]).data.features
    assert run["cfg"].generator.features == published
    assert torch_config.to_dict(run["tcfg"].generator.features) == dataclasses.asdict(published)
    assert published.sample_rate != 24000


def test_step_logs_match_jax(run):
    jlogs, logs = run["jlogs"], run["logs"]
    assert set(logs) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=LOG_RTOL, err_msg=k)


def _gap(got, ref):
    """max|got - ref| over the bound for `ref` (GRAD_RTOL of its largest entry)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max()) / (GRAD_RTOL * max(float(np.abs(ref).max()), 1e-12))


def test_generator_gradients_match_jax(run):
    expect = state_dict_from_jax_params(params_np(run["jnew"].g_opt_state),
                                        run["tcfg"].generator)
    named = list(run["state"].generator.named_parameters())
    assert {k for k, _ in named} == set(expect)
    for (k, _), g in zip(named, run["grads"]["g"]):
        ref = expect[k].numpy()
        got = np.zeros_like(ref) if g is None else g.numpy()
        assert _gap(got, ref) <= 1.0, (k, _gap(got, ref))


def test_discriminator_gradients_in_float64_are_equal(run):
    exact, jax_grads = run["d64"]["exact"], run["d64"]["jax"]
    assert set(exact) == set(jax_grads)
    for k, g in exact.items():
        assert g.dtype == torch.float64
        assert _gap(g.numpy(), jax_grads[k].numpy()) <= 1.0, (k, _gap(g.numpy(), jax_grads[k]))


def test_port_float32_discriminator_gradients_are_exact_at_its_kinks(run):
    d64 = run["d64"]
    named = list(run["state"].discriminator.named_parameters())
    for (k, _), g in zip(named, run["grads"]["d"]):
        # the recomputation on the kept inputs is the step's own
        np.testing.assert_array_equal(d64["port32"][k].numpy(), g.numpy(), err_msg=k)
        assert _gap(g.numpy(), d64["at_port_sides"][k].numpy()) <= 1.0, k


def test_discriminator_gradients_match_jax(run):
    expect = discriminator_state_dict_from_jax_params(params_np(run["jnew"].d_opt_state),
                                                      run["tcfg"].discriminator)
    d64 = run["d64"]
    named = list(run["state"].discriminator.named_parameters())
    assert {k for k, _ in named} == set(expect)
    for (k, _), g in zip(named, run["grads"]["d"]):
        got, ref, exact = g.numpy(), expect[k].numpy(), d64["exact"][k].numpy()
        if _gap(got, ref) <= 1.0:
            continue
        sub = k.split(".convs")[0].split(".conv_post")[0]
        jax_across_a_kink = _gap(ref, exact) > 1.0 and _gap(got, exact) <= 1.0
        assert sub in d64["flipped"] or jax_across_a_kink, (k, _gap(got, ref))
