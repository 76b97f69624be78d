"""Training with the other backbone kinds: the port's GAN train step and
validation step against the JAX package's on the CPU, for LightSpeech,
Transformer, Conformer (both conv norms) and LeanSpeech, at
`tiny_experiment()`'s sizes (dim 32, 2 blocks; LightSpeech kernel sizes 5
and 9), every dropout and drop-path rate at 0, segment starts sampled on
the host, the same weights in both.

Tolerances are the flagship's (tests/test_torch_train_step.py,
tests/test_torch_val_step.py): the train step's logs rtol 1e-4 and the
generator's gradients 2e-4 of each tensor's largest entry, the validation
step's logs rtol 1e-5 and its wavs atol 1e-5; the MAS durations of the
training forward exactly equal.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from optispeech_tpu.training.step import make_train_step as jax_make_train_step
from optispeech_tpu.training.step import make_val_step as jax_make_val_step
from optispeech_tpu_torch.compat.from_jax import state_dict_from_jax_params
from optispeech_tpu_torch.training.step import make_train_step, make_val_step
from test_torch_train_step import GRAD_RTOL, LOG_RTOL, _record_gradients
from test_torch_val_step import _compare
from test_train_step import tiny_experiment
from torch_parity import no_dropout, params_np, to_torch_config, train_batch, train_setup

torch.set_num_threads(1)

KINDS = {"lightspeech": ("lightspeech", "layernorm"), "transformer": ("transformer", "layernorm"),
         "conformer": ("conformer", "layernorm"), "conformer_affine": ("conformer", "affine"),
         "leanspeech": ("leanspeech", "layernorm")}


def kind_experiment(kind, norm):
    """`tiny_experiment()` with both stacks of `kind`, every dropout at 0
    (the backbones' own rates too)."""
    cfg = no_dropout(tiny_experiment(pretraining_steps=0))
    g = cfg.generator
    bb = lambda b: dataclasses.replace(  # noqa: E731
        b, kind=kind, kernel_sizes=(5, 9), conv_norm=norm, kernel_size=5, dropout=0.0,
        attention_dropout_rate=0.0, positional_dropout_rate=0.0)
    return dataclasses.replace(cfg, generator=dataclasses.replace(
        g, encoder=bb(g.encoder), decoder=bb(g.decoder)))


def _assert_gradients(named_params, grads, expect):
    """Each of G's gradients against JAX's through the bridge's layout,
    within GRAD_RTOL of the tensor's largest entry; a bias within GRAD_RTOL
    of the larger of its own and its layer's weight gradient's largest
    entry. A bias's gradient is a sum over every frame of the batch, and
    where the terms cancel (an attention layer's key bias, whose gradient is
    zero in exact arithmetic, or the pitch predictor's output bias, whose
    terms are the residuals of a mean squared error) the float32 noise of
    the terms stays. The bridge's zero `bias_ih_l0` is a buffer in the port
    (`FlaxLSTM`), so it has no gradient."""
    expect = {k: v.numpy() for k, v in expect.items() if not k.endswith(".lstm.bias_ih_l0")}
    assert {k for k, _ in named_params} == set(expect)
    for (k, _), g in zip(named_params, grads):
        ref = expect[k]
        got = np.zeros_like(ref) if g is None else g.numpy()
        scale = np.abs(ref).max()
        weight = k[:-len("bias")] + "weight"
        if k.endswith(".bias") and weight in expect:
            scale = max(scale, np.abs(expect[weight]).max())
        np.testing.assert_allclose(got, ref, atol=GRAD_RTOL * max(scale, 1e-12), err_msg=k)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module", params=list(KINDS))
def setup(request):
    cfg = kind_experiment(*KINDS[request.param])
    jgen, jdisc, jstate, state = train_setup(cfg)
    return dict(name=request.param, cfg=cfg, tcfg=to_torch_config(cfg), jgen=jgen, jdisc=jdisc,
                jstate=jstate, state=state)


def test_training_forward_durations_match_jax(setup):
    """The training forward's MAS durations (deterministic, host segment
    starts) equal JAX's; its losses within the train step's rtol."""
    batch = train_batch(np.random.default_rng(11), setup["cfg"])
    keys = ("x", "x_lengths", "mel", "mel_lengths", "pitches", "energies")
    expect = jax.jit(lambda p, *a: setup["jgen"].apply(
        {"params": p}, *a, deterministic=True, start_idx=a[-1]))(
        setup["jstate"].g_params, *[jnp.asarray(batch[k]) for k in keys],
        jnp.asarray(batch["start_idx"]))
    gen = setup["state"].generator.eval()
    with torch.no_grad():
        got = gen(*[torch.from_numpy(batch[k]) for k in keys],
                  start_idx=torch.from_numpy(batch["start_idx"]))
    np.testing.assert_array_equal(got["durations"].numpy(), np.asarray(expect["durations"]))
    for k in ("loss", "align_loss", "duration_loss", "pitch_loss", "energy_loss"):
        np.testing.assert_allclose(float(got[k]), float(expect[k]), rtol=LOG_RTOL, err_msg=k)


def test_train_step_matches_jax(setup):
    """One GAN step from the same state: every log, and the generator's
    gradients leaf by leaf through the bridge (JAX's with a pass-through
    optimiser that keeps them, as tests/test_torch_train_step.py does)."""
    cfg, tcfg, jstate = setup["cfg"], setup["tcfg"], setup["jstate"]
    batch = train_batch(np.random.default_rng(0), cfg)
    passthrough = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda g, s, params=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    jstep = jax_make_train_step(cfg, setup["jgen"], setup["jdisc"], optimizer=passthrough)
    start = jstate.replace(g_opt_state=passthrough.init(jstate.g_params),
                           d_opt_state=passthrough.init(jstate.d_params))
    jnew, jlogs = jstep(start, {k: jnp.asarray(v) for k, v in batch.items()})

    state = setup["state"]
    g_before = {k: v.clone() for k, v in state.generator.state_dict().items()}
    d_before = {k: v.clone() for k, v in state.discriminator.state_dict().items()}
    grads = _record_gradients(state)
    try:
        logs = make_train_step(tcfg)(state, _torch_batch(batch))
        assert set(logs) == set(jlogs)
        for k in jlogs:
            np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), rtol=LOG_RTOL,
                                       err_msg=k)
        expect = state_dict_from_jax_params(params_np(jnew.g_opt_state), tcfg.generator)
        _assert_gradients(list(state.generator.named_parameters()), grads["g"], expect)
    finally:  # the validation test starts from the same weights
        for opt in (state.g_opt, state.d_opt):
            del opt.update
        state.generator.load_state_dict(g_before)
        state.discriminator.load_state_dict(d_before)


def test_val_step_matches_jax(setup):
    """The validation step (MAS by the duration extraction) from the same
    weights: every log, the wav and wav_hat."""
    batch = train_batch(np.random.default_rng(5), setup["cfg"])
    jstep = jax_make_val_step(setup["cfg"], setup["jgen"], setup["jdisc"])
    jout = jstep(setup["jstate"], {k: jnp.asarray(v) for k, v in batch.items()},
                 jax.random.PRNGKey(0))
    out = make_val_step(setup["tcfg"])(setup["state"], _torch_batch(batch))
    _compare(jout, out)


# cli/train.py at the other configs, at test size: the trainer tests'
# overrides (tests/test_torch_trainer.py) and the backbones cut to 2 blocks
CONFIGS = Path(__file__).resolve().parent.parent / "configs"
CLI_CONFIGS = {"light": ["--config", str(CONFIGS / "light.yaml")],
               "transformer": ["--config", str(CONFIGS / "transformer.yaml")],
               "conformer": ["--config", str(CONFIGS / "conformer.yaml")],
               "leanspeech": ["generator.encoder.kind=leanspeech",
                              "generator.decoder.kind=leanspeech"]}
CLI_SMALL = ["data.text_processor.tokenizer=en-g2p"] + [
    f"generator.{stack}.{key}" for stack in ("encoder", "decoder") for key in (
        "kernel_sizes=[5, 9]", "num_blocks=2", "linear_units=64", "num_layers=2",
        "kernel_size=5")]


@pytest.mark.parametrize("name", list(CLI_CONFIGS))
def test_cli_trains_and_infers_each_config(name, tmp_path, monkeypatch):
    """`cli/train.py` (2 steps with a validation, the inference export),
    then `cli/infer.py --fused` on its export, on the CPU, for each of
    configs/light.yaml, transformer.yaml, conformer.yaml and the default
    with LeanSpeech stacks: the backbone kinds arrive in the model, the fused
    model fuses the trunk alone, and the wavs are finite, one per sentence,
    of the durations' length."""
    from optispeech_tpu_torch.cli import infer
    from optispeech_tpu_torch.cli.train import main
    from optispeech_tpu_torch.models.optispeech import OptiSpeech
    from optispeech_tpu_torch.training import loggers
    from optispeech_tpu_torch.utils.wavio import load_wav
    from test_torch_trainer import CLI_OVERRIDES

    monkeypatch.setitem(loggers._SINK_REGISTRY, "tensorboard", lambda *args: None)
    out = tmp_path / "run"
    overrides = CLI_CONFIGS[name] + CLI_OVERRIDES + CLI_SMALL
    assert main(["--synthetic", "--device", "cpu", "--max-steps", "2", "--out-dir", str(out),
                 "--no-print-config", *overrides]) == 0
    ckpt = out / "inference_ckpt"
    model = OptiSpeech.load_from_checkpoint(str(ckpt), device="cpu", fused=True)
    kind = {"light": "lightspeech"}.get(name, name)
    g = model.cfg.generator
    assert g.encoder.kind == g.decoder.kind == kind
    assert g.vocoder.fused_pallas and not g.decoder.fused_pallas
    text = "Some text. More of it."
    result = infer.main([str(ckpt), text, str(tmp_path / "wavs"), "--fused", "--device", "cpu",
                         "--d-factor", "2"])
    frames = result.durations.sum(axis=1)
    assert len(frames) == 2
    for i, n in enumerate(frames):
        wav, _ = load_wav(str(tmp_path / "wavs" / f"gen-{i + 1}.wav"))
        assert len(wav) == n * model.hop_length > 0 and np.isfinite(wav).all()
