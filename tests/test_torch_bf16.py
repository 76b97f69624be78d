"""The bf16 compute path, port against the JAX package's `dtype=jnp.bfloat16`
on the CPU, with the same float32 weights in both (JAX init ->
`compat/from_jax.py` -> port) and numpy inputs from seeds.

Tolerances:
- each module against JAX's module applied op by op, the port following
  flax's order per layer (product or conv rounded, then the bias; LayerNorm
  statistics in float32; GELU as `(0.5 x) erfc(-x c)` in bf16): bit-equal
  for the ConvNeXt block and backbone, the embedding and encoder, the
  predictors. Where a product or conv sums many terms, torch and XLA sum
  them in other orders in float32, and a sum near the midpoint of two bf16
  values rounds to the other one (1-2 elements of 18432 in one layer); a
  later layer carries that step on. So `gaussian_upsample` and WaveNeXt
  are held to one bf16 step of max|ref| on every element, with at most
  `MAX_SHARE` of the elements differing (measured 0.005% and 1.9%), and
  the alignment module's float32 log-probs, whose distance reads its bf16
  convs, to `ALIGN_ATOL` on the valid cells (measured 3.1e-3);
- the slice against JAX's jitted synthesis: inside its fusions XLA also
  keeps float32 where flax's ops would round to bf16 (the GELU chain, a
  conv's output into the LayerNorm), so jitted JAX differs from its own
  op-by-op bf16 by a bf16 step on some elements. Predicted durations are
  asserted equal; the pitch and energy predictions are held to
  `PRED_ATOL`, and the wav to `WAV_RTOL` of max|wav| and, as a yardstick
  that does not depend on that noise, to 1.25x JAX's own bf16 error
  against JAX's float32 wav.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import params_np, random_tokens, small_config, to_torch_config

torch.set_num_threads(1)

BF16_STEP = 2.0 ** -7  # one bf16 step, relative (8 significant bits)
MAX_SHARE = 0.05
ALIGN_ATOL = 1e-2
PRED_ATOL = 5e-2  # of predictions up to ~2.5; measured 1.9e-2
EAGER_RTOL = 1e-2  # wav against JAX op by op; measured 2.7e-3
# wav: max|port - jax| / max|jax|; measured 1.17e-2 unfused, 1.26e-2 fused
WAV_RTOL = 3e-2
YARDSTICK = 1.25
TEXT = "The birch canoe slid on the smooth planks. Glue the sheet to the dark blue background."


def bf16_config(**kw):
    """2 blocks a stack, dim 64 (decoder 64/128, trunk 96/192), the test-size
    predictors."""
    return small_config(dim=64, inter=128, voc_dim=96, voc_inter=192, **kw)


@pytest.fixture(scope="module")
def models():
    """(JAX bf16, JAX f32, port bf16 on the CPU), one set of weights."""
    from optispeech_tpu.models.optispeech import OptiSpeech as JaxOptiSpeech
    from optispeech_tpu_torch.models.optispeech import OptiSpeech

    cfg = bf16_config(num_speakers=3, languages=("en-us", "en-gb"))
    jbf = JaxOptiSpeech(cfg, seed=0, compute_dtype=jnp.bfloat16)
    jf32 = JaxOptiSpeech(cfg, params=jbf.params, compute_dtype=jnp.float32)
    port = OptiSpeech.load_from_jax_params(to_torch_config(cfg), params_np(jbf.params),
                                           device="cpu", compute_dtype=torch.bfloat16)
    return jbf, jf32, port


def _apply(japi, fn, *args):
    """`fn(generator_module, *args)` inside JAX's bf16 generator, op by op."""
    return japi.generator.apply({"params": japi.params}, *args, method=fn)


def _np(a):
    return a.float().numpy() if torch.is_tensor(a) else np.asarray(jnp.asarray(a, jnp.float32))


def _hidden(seed, dim=64, lengths=(32, 20, 9)):
    """bf16 hidden states (JAX, port) and the PAD mask (numpy, JAX, port)."""
    rng = np.random.default_rng(seed)
    x, x_lengths = random_tokens(rng, lengths)
    h = rng.normal(size=(len(lengths), x.shape[1], dim)).astype(np.float32)
    pad = np.arange(x.shape[1])[None, :] >= x_lengths[:, None]
    return (jnp.asarray(h, jnp.bfloat16), torch.from_numpy(h).bfloat16(),
            jnp.asarray(pad), torch.from_numpy(pad))


def _assert_bits(got, expect, name=""):
    assert got.dtype == torch.bfloat16, name
    assert expect.dtype == jnp.bfloat16, name
    np.testing.assert_array_equal(_np(got), _np(expect), err_msg=name)


def _assert_bf16_close(got, expect, name=""):
    """bf16 out; every element within one bf16 step of max|expect|, at most
    MAX_SHARE of them not equal."""
    assert got.dtype == torch.bfloat16, name
    got, expect = _np(got), _np(expect)
    share = np.mean(got != expect)
    print(f"{name}: {share:.3%} of elements differ, max {np.abs(got - expect).max():.3e} "
          f"at max|ref| {np.abs(expect).max():.3e}")
    np.testing.assert_allclose(got, expect, rtol=0, atol=BF16_STEP * np.abs(expect).max(),
                               err_msg=name)
    assert share <= MAX_SHARE, name


# -- modules ----------------------------------------------------------------


def test_convnext_block_and_backbone_unfused(models):
    from optispeech_tpu.models.modules.convnext import ConvNeXtBlock

    jbf, _, port = models
    jh, th, jpad, tpad = _hidden(0)
    p = jbf.params["encoder"]["block_0"]
    block = ConvNeXtBlock(dim=64, intermediate_dim=128, layer_scale_init_value=0.5,
                          dtype=jnp.bfloat16)
    expect = block.apply({"params": p}, jh)
    with torch.no_grad():
        got = port.generator.encoder.convnext[0](th)
    _assert_bits(got, expect, "block")
    expect = _apply(jbf, lambda m, h, pad: m.encoder(h, pad), jh, jpad)
    with torch.no_grad():
        got = port.generator.encoder(th, tpad)
    _assert_bits(got, expect, "backbone")


def test_text_embedding_and_encoder(models):
    jbf, _, port = models
    rng = np.random.default_rng(1)
    x, x_lengths = random_tokens(rng, (32, 20, 9))
    jx, tx = jnp.asarray(x), torch.from_numpy(x).long()
    expect, jemb = _apply(jbf, lambda m, x: m.text_embedding(x), jx)
    with torch.no_grad():
        got, temb = port.generator.text_embedding(tx)
    _assert_bits(got, expect, "embedding")
    _assert_bits(temb, jemb, "scaled table rows")
    pad = np.arange(32)[None, :] >= x_lengths[:, None]
    sids, lids = np.array([0, 2, 1]), np.array([1, 0, 1])
    expect = _apply(jbf, lambda m, x, p, s, l: m._encode_text(x, p, s, l, True), jx,
                    jnp.asarray(pad), jnp.asarray(sids), jnp.asarray(lids))
    with torch.no_grad():
        got = port.generator._encode_text(tx, torch.from_numpy(pad), torch.from_numpy(sids),
                                          torch.from_numpy(lids))
    _assert_bits(got, expect, "encoder + speaker and language rows")


@pytest.mark.parametrize("factor", [1.0, 8.0])
def test_duration_predictor(models, factor):
    """The forward in bf16, bit-equal; `infer` at factors 1 and 8 equal to
    JAX's, with the factor as a Python float (weakly typed: the product in
    bf16) and as the float32 array that JAX's synthesis passes."""
    jbf, _, port = models
    jh, th, jpad, tpad = _hidden(2)
    expect = _apply(jbf, lambda m, h, p: m.duration_predictor(h, p), jh, jpad)
    with torch.no_grad():
        got = port.generator.duration_predictor(th, tpad)
        durations = port.generator.duration_predictor.infer(th, tpad, factor)
    _assert_bits(got, expect)
    assert durations.dtype == torch.int32
    for f in (factor, jnp.float32(factor)):
        expect = _apply(jbf, lambda m, h, p, f: m.duration_predictor.infer(h, p, f), jh, jpad, f)
        np.testing.assert_array_equal(durations.numpy(), np.asarray(expect))
    assert durations.numpy().sum() > 0


@pytest.mark.parametrize("name", ["pitch_predictor", "energy_predictor"])
def test_pitch_and_energy_predictors(models, name):
    """`infer` at factors 1 and 1.3 (the factor a float32 array, as in JAX's
    synthesis: float32 predictions) and the teacher-forced forward."""
    jbf, _, port = models
    jh, th, jpad, tpad = _hidden(3)
    module = getattr(port.generator, name)
    for factor in (1.0, 1.3):
        jx, jp = _apply(jbf, lambda m, h, p, f: getattr(m, name).infer(h, p, f), jh, jpad,
                        jnp.float32(factor))
        with torch.no_grad():
            tx, tp = module.infer(th, tpad, factor)
        _assert_bits(tx, jx, f"hidden at {factor}")
        assert tp.dtype == torch.float32 and jp.dtype == jnp.float32
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    target = np.random.default_rng(4).normal(size=tpad.shape).astype(np.float32)
    jx, jp = _apply(jbf, lambda m, h, p, t: getattr(m, name)(h, p, t), jh, jpad,
                    jnp.asarray(target))
    with torch.no_grad():
        tx, tp = module(th, tpad, torch.from_numpy(target))
    _assert_bits(tx, jx, "teacher-forced hidden")
    _assert_bits(tp, jp, "teacher-forced predictions")


def test_alignment_module(models):
    """bf16 convs, the distance in float32: float32 log-probs within the
    float32 tests' 1e-4 on the valid cells, PAD tokens masked alike."""
    jbf, _, port = models
    jh, th, jpad, tpad = _hidden(5)
    rng = np.random.default_rng(5)
    mel = rng.normal(size=(3, 96, 100)).astype(np.float32)
    x_lengths = np.array([32, 20, 9], np.int32)
    mel_lengths = np.array([96, 70, 40], np.int32)
    expect = _apply(jbf, lambda m, t, f, tl, fl, p: m.alignment_module(t, f, tl, fl, x_masks=p),
                    jh, jnp.asarray(mel, jnp.bfloat16), jnp.asarray(x_lengths),
                    jnp.asarray(mel_lengths), jpad)
    with torch.no_grad():
        got = port.generator.alignment_module(th, torch.from_numpy(mel).bfloat16(),
                                              torch.from_numpy(x_lengths),
                                              torch.from_numpy(mel_lengths), x_masks=tpad)
    assert got.dtype == torch.float32 and expect.dtype == jnp.float32
    got, expect = got.numpy(), np.asarray(expect)
    valid = ((np.arange(32)[None, None, :] < x_lengths[:, None, None])
             & (np.arange(96)[None, :, None] < mel_lengths[:, None, None]))
    print(f"alignment: max|d| {np.abs(got[valid] - expect[valid]).max():.3e}")
    np.testing.assert_allclose(got[valid], expect[valid], rtol=0, atol=ALIGN_ATOL)
    np.testing.assert_array_equal(got[~valid] < -1e8, expect[~valid] < -1e8)


def test_gaussian_upsample():
    from optispeech_tpu.ops.duration import gaussian_upsample as jax_upsample
    from optispeech_tpu_torch.ops.duration import gaussian_upsample

    rng = np.random.default_rng(6)
    h = rng.normal(size=(3, 32, 64)).astype(np.float32)
    pad = np.arange(32)[None, :] >= np.array([32, 20, 9])[:, None]
    ds = rng.integers(0, 5, (3, 32))
    ds[pad] = 0
    frames = np.arange(96)[None, :] < ds.sum(1)[:, None]
    expect = jax_upsample(jnp.asarray(h, jnp.bfloat16), jnp.asarray(ds), jnp.asarray(frames),
                          jnp.asarray(~pad))
    got = gaussian_upsample(torch.from_numpy(h).bfloat16(), torch.from_numpy(ds),
                            torch.from_numpy(frames), torch.from_numpy(~pad))
    _assert_bf16_close(got, expect, "gaussian_upsample")


@pytest.mark.parametrize("f0_cond", [False, True])
def test_wavenext(f0_cond):
    """The vocoder alone (embed conv, f0 embed, norm, trunk, two-Dense head),
    bf16 out."""
    from optispeech_tpu.models.optispeech import OptiSpeech as JaxOptiSpeech
    from optispeech_tpu_torch.models.optispeech import OptiSpeech

    cfg = bf16_config(f0_cond=f0_cond)
    jbf = JaxOptiSpeech(cfg, seed=1, compute_dtype=jnp.bfloat16)
    port = OptiSpeech.load_from_jax_params(to_torch_config(cfg), params_np(jbf.params),
                                           device="cpu", compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(7)
    y = rng.normal(size=(2, 64, 64)).astype(np.float32)
    f0 = rng.normal(size=(2, 64)).astype(np.float32)
    pad = np.arange(64)[None, :] >= np.array([64, 40])[:, None]
    expect = _apply(jbf, lambda m, y, f, p: m.vocoder(y, f0=f, padding_mask=p),
                    jnp.asarray(y, jnp.bfloat16), jnp.asarray(f0), jnp.asarray(pad))
    with torch.no_grad():
        got = port.generator.vocoder(torch.from_numpy(y).bfloat16(), f0=torch.from_numpy(f0),
                                     padding_mask=torch.from_numpy(pad))
    _assert_bf16_close(got, expect, f"WaveNeXt, f0_cond {f0_cond}")


# -- parameters ---------------------------------------------------------------


def test_parameters_stay_float32(models, tmp_path):
    """The bf16 model keeps the f32 model's state-dict keys and dtypes (every
    parameter float32), writes the same checkpoint, and reads it back to the
    same wav; its activations are bf16."""
    from optispeech_tpu_torch.models.generator import OptiSpeechGenerator, compute_dtype
    from optispeech_tpu_torch.models.optispeech import OptiSpeech

    jbf, _, port = models
    f32 = OptiSpeechGenerator(port.cfg.generator).state_dict()
    bf16 = port.generator.state_dict()
    assert list(bf16) == list(f32)
    assert all(bf16[k].dtype == f32[k].dtype for k in f32)
    assert {p.dtype for p in port.generator.parameters()} == {torch.float32}
    assert compute_dtype("bfloat16") == torch.bfloat16
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        compute_dtype("float16")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        OptiSpeechGenerator(port.cfg.generator, dtype=torch.float16)

    port.save_checkpoint(str(tmp_path / "ckpt"))
    back = OptiSpeech.load_from_checkpoint(str(tmp_path / "ckpt"), device="cpu",
                                           compute_dtype=torch.bfloat16)
    saved = torch.load(tmp_path / "ckpt" / "generator.pt")
    assert {v.dtype for v in saved.values()} == {torch.float32}
    inputs = port.prepare_input(TEXT)
    a, b = port.synthesise(inputs), back.synthesise(inputs)
    np.testing.assert_array_equal(a.wav, b.wav)
    seen = []
    hook = back.generator.decoder.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    back.synthesise(inputs)
    hook.remove()
    assert seen == [torch.bfloat16]


# -- the slice ----------------------------------------------------------------


def _wav_errors(got, expect, f32):
    """max|got - expect| / max|expect|, and the yardstick's two errors
    against the float32 wav: the port's and JAX's."""
    scale = np.abs(expect).max()
    return (np.abs(got - expect).max() / scale, np.abs(got - f32).max(),
            np.abs(expect - f32).max())


def _assert_wav(got, expect, f32, what):
    rel, port_err, jax_err = _wav_errors(got, expect, f32)
    print(f"{what}: max|port - jax| / max|jax| {rel:.3e}; against the f32 wav: "
          f"port {port_err:.3e}, jax {jax_err:.3e}")
    assert rel <= WAV_RTOL, what
    assert port_err <= YARDSTICK * jax_err, what


def _pre_ceil(port, inputs):
    """The port's bf16 durations before the factor and the ceiling,
    exp(log-duration) - clip, (B, T_text)."""
    from optispeech_tpu_torch.ops import sequence_mask

    gen = port.generator
    x, x_lengths, sids, lids = port._tensors(inputs)[:4]
    pad = ~sequence_mask(x_lengths, x.shape[1])
    with torch.no_grad():
        h = gen._encode_text(x, pad, sids, lids)
        return torch.exp(gen.duration_predictor(h, pad)) - gen.duration_predictor.clip_val


def test_synthesise_matches_jax_bf16(models):
    jbf, jf32, port = models
    inputs = jbf.prepare_input(TEXT)
    expect, f32 = jbf.synthesise(inputs), jf32.synthesise(inputs)
    got = port.synthesise(port.prepare_input(TEXT))
    np.testing.assert_array_equal(got.durations, expect.durations)
    np.testing.assert_array_equal(got.durations, f32.durations)
    np.testing.assert_array_equal(got.wav_lengths, expect.wav_lengths)
    assert got.wav.dtype == np.float32 and got.pitch.dtype == np.float32
    for k in ("pitch", "energy"):
        a, b = getattr(got, k), np.asarray(getattr(expect, k), np.float32)
        print(f"{k}: max|port - jax| {np.abs(a - b).max():.3e}, max|jax| {np.abs(b).max():.3e}")
        np.testing.assert_allclose(a, b, rtol=0, atol=PRED_ATOL, err_msg=k)
    _assert_wav(got.wav, expect.wav, f32.wav, "synthesise")


def test_synthesise_at_factor_8_follows_jax_op_by_op(models):
    """A speaker and d_factor 8: durations equal to JAX's bf16 synthesis run
    op by op (`jax.disable_jit()`, flax's order), the wav within
    `EAGER_RTOL` of it. JAX's jitted synthesis moves 4 of these 128
    durations by one frame against its own op-by-op run (its fusions keep
    float32, and the port's bf16 durations sit 0 to 2 bf16 steps from the
    ceiling's boundary there); each may move by one frame at most."""
    jbf, _, port = models
    kw = dict(speaker=2, language="en-gb", d_factor=8.0)
    inputs = jbf.prepare_input(TEXT, **kw)
    with jax.disable_jit():
        eager = jbf.synthesise(inputs)
    jitted = jbf.synthesise(inputs)
    ours = port.prepare_input(TEXT, **kw)
    got = port.synthesise(ours)
    np.testing.assert_array_equal(got.durations, eager.durations)
    np.testing.assert_array_equal(got.wav_lengths, eager.wav_lengths)
    rel = np.abs(got.wav - eager.wav).max() / np.abs(eager.wav).max()
    print(f"against JAX op by op: max|port - jax| / max|jax| {rel:.3e}")
    assert rel <= EAGER_RTOL
    moved = got.durations != jitted.durations
    d = _pre_ceil(port, ours)
    for i, j in np.argwhere(moved):
        print(f"jitted JAX moves token ({i}, {j}): {jitted.durations[i, j]} against "
              f"{got.durations[i, j]}; the port's bf16 duration {float(d[i, j])} x 8 = "
              f"{float(d[i, j]) * 8}")
    assert np.all(np.abs(got.durations - jitted.durations) <= 1)
    assert moved.mean() <= 0.05


def test_synthesise_on_device_matches_jax_bf16(models):
    jbf, jf32, port = models
    inputs = jbf.prepare_input(TEXT, d_factor=2.0)
    expect = jbf.synthesise_on_device(inputs, n_frames=256, pcm16=True)
    f32 = jf32.synthesise_on_device(inputs, n_frames=256)
    got = port.synthesise_on_device(port.prepare_input(TEXT, d_factor=2.0), n_frames=256,
                                    pcm16=True)
    for k in ("durations", "y_lengths", "wav_lengths"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(expect[k]), err_msg=k)
    assert got["wav"].dtype == torch.float32 and got["wav_pcm16"].dtype == torch.int16
    _assert_wav(got["wav"].numpy(), np.asarray(expect["wav"]), np.asarray(f32["wav"]),
                "synthesise_on_device")


def test_fused_model_matches_jax_fused_bf16(monkeypatch):
    """`--fused` in bf16: every decoder and trunk block of the port calls the
    fused wrapper (its twin on CPU tensors: no launch), and JAX's blocks run
    the Pallas kernel in interpret mode on bf16 x; durations equal, the wav
    within WAV_RTOL and the yardstick against JAX's unfused f32 wav."""
    import optispeech_tpu.ops.pallas_convnext as pc
    from optispeech_tpu.models.optispeech import OptiSpeech as JaxOptiSpeech
    from optispeech_tpu_torch.models.modules import convnext
    from optispeech_tpu_torch.models.optispeech import OptiSpeech, with_fused_blocks
    from optispeech_tpu_torch.ops import fused_convnext as fc

    cfg = bf16_config()
    g = cfg.generator
    fused = dataclasses.replace(cfg, generator=dataclasses.replace(
        g, decoder=dataclasses.replace(g.decoder, fused_pallas=True),
        vocoder=dataclasses.replace(g.vocoder, fused_pallas=True)))
    orig, calls = pc.convnext_block_fused, []

    def interp(*args, **kw):
        calls.append(args[0].dtype)
        return orig(*args, interpret=True, **kw)

    monkeypatch.setattr(pc, "convnext_block_fused", interp)
    monkeypatch.setattr(pc, "fused_supported", lambda: True)
    jbf = JaxOptiSpeech(fused, seed=2, compute_dtype=jnp.bfloat16)
    jf32 = JaxOptiSpeech(cfg, params=jbf.params, compute_dtype=jnp.float32)
    inputs = jbf.prepare_input(TEXT, d_factor=2.0)
    expect, f32 = jbf.synthesise(inputs), jf32.synthesise(inputs)
    assert calls == [jnp.bfloat16] * 4  # 2 decoder + 2 trunk blocks, traced once
    port = OptiSpeech.load_from_jax_params(with_fused_blocks(to_torch_config(cfg)),
                                           params_np(jbf.params), device="cpu",
                                           compute_dtype=torch.bfloat16)
    port_calls, wrapper = [], convnext.convnext_block_fused
    monkeypatch.setattr(convnext, "convnext_block_fused",
                        lambda x, *a, **kw: port_calls.append(x.dtype) or wrapper(x, *a, **kw))
    launches = fc.convnext_block_fused.launches
    got = port.synthesise(port.prepare_input(TEXT, d_factor=2.0))
    assert fc.convnext_block_fused.launches == launches  # CPU tensors: the twin
    assert port_calls == [torch.bfloat16] * 4
    np.testing.assert_array_equal(got.durations, expect.durations)
    np.testing.assert_array_equal(got.wav_lengths, expect.wav_lengths)
    _assert_wav(got.wav, expect.wav, f32.wav, "fused synthesise")
