"""The port's training modules against the JAX package's on the CPU, with the
same weights (JAX init -> the bridges in compat/from_jax.py) and the same
numpy inputs, at `tiny_experiment()`'s sizes with every dropout at 0.

Tolerances: float32 on both sides with other summation orders, so values
are held to atol 1e-4 (ROADMAP.md's module tolerance) and scalar losses to
rtol 1e-5, except where a test states another with its reason.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optispeech_tpu import ops as jops
from optispeech_tpu_torch import ops as tops
from test_train_step import tiny_experiment
from torch_parity import no_dropout, to_torch_config, train_batch, train_setup

torch.set_num_threads(1)

ATOL = 1e-4
RTOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    """`tiny_experiment()` with no dropout and an f0-conditioned vocoder (so
    the generator's training forward also feeds the vocoder its f0)."""
    cfg = no_dropout(tiny_experiment(pretraining_steps=0))
    g = cfg.generator
    cfg = dataclasses.replace(
        cfg, generator=dataclasses.replace(g, vocoder=dataclasses.replace(g.vocoder,
                                                                          f0_cond=True)))
    jgen, jdisc, jstate, state = train_setup(cfg)
    state.generator.train()
    return cfg, jgen, jdisc, jstate, state


def _gen_apply(setup, fn, *args):
    """`fn(generator_module, *args)` in the JAX generator's scope, jitted
    (one compile is quicker on the CPU than eager dispatch op by op)."""
    _, jgen, _, jstate, _ = setup
    return jax.jit(lambda p, *a: jgen.apply({"params": p}, *a, method=fn))(jstate.g_params, *args)


def _disc_apply(setup, fn, *args):
    _, _, jdisc, jstate, _ = setup
    return jax.jit(lambda p, *a: jdisc.apply({"params": p}, *a, method=fn))(jstate.d_params, *args)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, expect, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(expect), atol=atol)


# -- 1-4: masks, durations, segments, prior ------------------------------------

@pytest.mark.parametrize("max_length", [1, 7, 32])
def test_pad_masks(max_length):
    lengths = np.array([0, 1, 5, max_length], np.int32)
    for jfn, tfn in ((jops.make_pad_mask, tops.make_pad_mask),
                     (jops.make_non_pad_mask, tops.make_non_pad_mask)):
        np.testing.assert_array_equal(tfn(_t(lengths), max_length).numpy(),
                                      np.asarray(jfn(jnp.asarray(lengths), max_length)))


def _durations(rng, b=3, t_text=12, x_lengths=(12, 7, 3)):
    d = rng.integers(0, 6, (b, t_text)).astype(np.int32)
    d[np.arange(t_text)[None, :] >= np.asarray(x_lengths)[:, None]] = 0
    return d


@pytest.mark.parametrize("seed", [0, 1])
def test_average_by_duration(seed):
    rng = np.random.default_rng(seed)
    d = _durations(rng).astype(np.float32)
    x_lengths = np.array([12, 7, 3], np.int32)
    feats_lengths = np.array([40, 25, 9], np.int32)  # some frames cut, some tokens empty
    xs = rng.normal(size=(3, 40)).astype(np.float32)
    expect = jops.average_by_duration(jnp.asarray(d), jnp.asarray(xs), jnp.asarray(x_lengths),
                                      jnp.asarray(feats_lengths))
    got = tops.average_by_duration(_t(d), _t(xs), _t(x_lengths), _t(feats_lengths))
    _close(got, expect, atol=1e-6)


@pytest.mark.parametrize("n_frames", [8, 64])
def test_duration_to_frame_index(n_frames):
    d = _durations(np.random.default_rng(n_frames))
    expect = jops.duration_to_frame_index(jnp.asarray(d), n_frames)
    got = tops.duration_to_frame_index(_t(d), n_frames)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


def test_get_segments():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 4, 30)).astype(np.float32)
    starts = np.array([0, 11, 25], np.int32)  # the last runs past the end
    expect = jops.get_segments(jnp.asarray(x), jnp.asarray(starts), 8)
    np.testing.assert_array_equal(tops.get_segments(_t(x), _t(starts), 8).numpy(),
                                  np.asarray(expect))


def test_get_random_segments_draws_from_the_generator():
    """JAX and torch draw other numbers: hold the port to the formula
    floor(u * max(len - S, 0)) on the numbers its generator gives, and to
    the JAX crop at the starts it picked."""
    rng = np.random.default_rng(1)
    x = _t(rng.normal(size=(4, 2, 50)).astype(np.float32))
    lengths = torch.tensor([50, 30, 12, 5], dtype=torch.int32)
    seg, starts = tops.get_random_segments(torch.Generator().manual_seed(3), x, lengths, 8)
    u = torch.rand(4, generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(
        starts.numpy(), np.floor(u.numpy() * np.maximum(lengths.numpy() - 8, 0)).astype(np.int32))
    assert starts.dtype == torch.int32 and starts[3] == 0
    expect = jops.get_segments(jnp.asarray(x.numpy()), jnp.asarray(starts.numpy()), 8)
    np.testing.assert_array_equal(seg.numpy(), np.asarray(expect))


def test_host_segment_functions_match_jax():
    from optispeech_tpu.ops import segments as jseg
    from optispeech_tpu_torch.ops import segments as tseg

    mel_lengths = np.array([64, 40, 17, 3])
    wav = np.random.default_rng(0).normal(size=(4, 64 * 16)).astype(np.float32)
    js = jseg.host_sample_segment_starts(np.random.default_rng(5), mel_lengths, 16)
    ts = tseg.host_sample_segment_starts(np.random.default_rng(5), mel_lengths, 16)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tseg.host_slice_wav_segments(wav, ts, 16, 16),
                                  jseg.host_slice_wav_segments(wav, js, 16, 16))


def test_beta_binomial_log_prior():
    """lgamma of arguments up to ~T_feats in float32 on both sides: the
    valid cells (|value| up to ~60) agree to a few float32 ulps."""
    tl, fl = np.array([16, 9, 1], np.int32), np.array([64, 30, 5], np.int32)
    expect = np.asarray(jops.beta_binomial_log_prior(jnp.asarray(tl), jnp.asarray(fl), 16, 64))
    got = tops.beta_binomial_log_prior(_t(tl), _t(fl), 16, 64).numpy()
    np.testing.assert_array_equal(got == -1e9, expect == -1e9)
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-4)


# -- 6-7: forward-sum loss, spectra ---------------------------------------------

def test_forward_sum_loss_and_gradient():
    """F.ctc_loss against the JAX log-space scan; item 3 has fewer frames
    than tokens (infeasible: zero_infinity)."""
    rng = np.random.default_rng(2)
    b, t_feats, t_text = 4, 40, 12
    lp = rng.normal(size=(b, t_feats, t_text)).astype(np.float32)
    tl, fl = np.array([12, 7, 3, 10], np.int32), np.array([40, 31, 12, 6], np.int32)
    fn = lambda x: jops.forward_sum_loss(x, jnp.asarray(tl), jnp.asarray(fl))  # noqa: E731
    expect, jgrad = jax.jit(jax.value_and_grad(fn))(jnp.asarray(lp))
    x = _t(lp).requires_grad_(True)
    got = tops.forward_sum_loss(x, _t(tl), _t(fl))
    (grad,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(float(got.detach()), float(expect), rtol=RTOL)
    _close(grad, jgrad, atol=1e-6)


RESOLUTIONS = {  # (n_fft, hop, win_length, window): the flagship's STFTs
    "mrd_1024": (1024, 256, 1024, "ones"), "mrd_2048": (2048, 512, 2048, "ones"),
    "mrd_512": (512, 128, 512, "ones"), "mr_stft_1024": (1024, 120, 600, "hann"),
    "mr_stft_2048": (2048, 240, 1200, "hann"), "mr_stft_512": (512, 50, 240, "hann"),
    "mel_loss": (1024, 256, 1024, "hann"),
}


@pytest.mark.parametrize("name", list(RESOLUTIONS))
def test_stft_magnitude(name):
    n_fft, hop, win, window = RESOLUTIONS[name]
    x = (np.random.default_rng(3).normal(size=(2, 64 * 256)) * 0.1).astype(np.float32)
    expect = jops.stft_magnitude(jnp.asarray(x), n_fft, hop, win, window=window)
    got = tops.stft_magnitude(_t(x), n_fft, hop, win, window=window)
    assert got.shape == expect.shape
    # |X| up to ~50 from sums of n_fft products
    _close(got, expect, atol=1e-4 * float(jnp.abs(expect).max()))


def test_stft_reflect_pad_longer_than_the_signal():
    """The tiny configs run a 2048-point STFT on 1024 samples: the centre
    padding repeats the reflection, as jnp.pad does."""
    x = np.random.default_rng(4).normal(size=(2, 1024)).astype(np.float32)
    expect = jops.stft_magnitude(jnp.asarray(x), 2048, 240, 1200)
    _close(tops.stft_magnitude(_t(x), 2048, 240, 1200), expect, atol=1e-3)


@pytest.mark.parametrize("htk,norm", [(False, "slaney"), (True, None)])
def test_mel_filterbank(htk, norm):
    expect = jops.mel_filterbank(24000, 1024, 100, 0.0, 12000.0, htk=htk, norm=norm)
    np.testing.assert_array_equal(
        tops.mel_filterbank(24000, 1024, 100, 0.0, 12000.0, htk=htk, norm=norm).numpy(),
        np.asarray(expect))


def test_log_mel_spectrogram():
    x = (np.random.default_rng(5).normal(size=(2, 12000)) * 0.1).astype(np.float32)
    args = (24000, 1024, 256, 1024, 100, 80.0, 8000.0)
    expect = jops.log_mel_spectrogram(jnp.asarray(x), *args)
    _close(tops.log_mel_spectrogram(_t(x), *args), expect)


# -- 8-12: alignment, losses, modules in training mode, the generator ------------

def _text_and_mel(seed, cfg, b=3):
    rng = np.random.default_rng(seed)
    t_text, t_mel = cfg.data.text_bucket_size, cfg.data.mel_bucket_size
    h = rng.normal(size=(b, t_text, cfg.generator.dim)).astype(np.float32)
    mel = rng.normal(size=(b, t_mel, cfg.generator.features.n_feats)).astype(np.float32)
    tl = np.array([t_text, t_text - 5, 2], np.int32)[:b]
    fl = np.array([t_mel, t_mel - 20, 7], np.int32)[:b]
    return h, mel, tl, fl


def test_alignment_module(setup):
    cfg, *_, state = setup
    h, mel, tl, fl = _text_and_mel(6, cfg)
    pad = np.arange(h.shape[1])[None, :] >= tl[:, None]
    expect = _gen_apply(setup, lambda m, *a: m.alignment_module(*a[:4], x_masks=a[4]),
                        jnp.asarray(h), jnp.asarray(mel), jnp.asarray(tl), jnp.asarray(fl),
                        jnp.asarray(pad))
    got = state.generator.alignment_module(_t(h), _t(mel), _t(tl), _t(fl), _t(pad))
    _close(got, expect)


def test_fastspeech2_loss():
    from optispeech_tpu.models.losses import fastspeech2_loss as jloss
    from optispeech_tpu_torch.models.losses import fastspeech2_loss as tloss

    rng = np.random.default_rng(7)
    arrays = [rng.normal(size=(3, 10)).astype(np.float32) for _ in range(3)]
    arrays += [rng.integers(0, 5, (3, 10)).astype(np.float32),
               (rng.normal(size=(3, 10)) * 2).astype(np.float32),
               rng.normal(size=(3, 10)).astype(np.float32)]
    ilens = np.array([10, 6, 1], np.int32)
    expect = jloss(*map(jnp.asarray, arrays), jnp.asarray(ilens), 10)
    got = tloss(*map(_t, arrays), _t(ilens), 10)
    for g, e in zip(got, expect):
        np.testing.assert_allclose(float(g), float(e), rtol=RTOL)


def test_duration_predictor_training_forward(setup):
    cfg, *_, state = setup
    h, _, tl, _ = _text_and_mel(8, cfg)
    pad = np.arange(h.shape[1])[None, :] >= tl[:, None]
    expect = _gen_apply(setup, lambda m, h, p: m.duration_predictor(h, p, deterministic=False),
                        jnp.asarray(h), jnp.asarray(pad))
    _close(state.generator.duration_predictor(_t(h), _t(pad)), expect)


@pytest.mark.parametrize("name", ["pitch_predictor", "energy_predictor"])
def test_predictor_teacher_forced(setup, name):
    cfg, *_, state = setup
    h, _, tl, _ = _text_and_mel(9, cfg)
    pad = np.arange(h.shape[1])[None, :] >= tl[:, None]
    target = np.random.default_rng(10).normal(size=h.shape[:2]).astype(np.float32)
    jx, jp = _gen_apply(setup, lambda m, *a: getattr(m, name)(*a, deterministic=False),
                        jnp.asarray(h), jnp.asarray(pad), jnp.asarray(target))
    tx, tp = getattr(state.generator, name)(_t(h), _t(pad), _t(target))
    _close(tp, jp)
    _close(tx, jx)


def test_encoder_and_decoder_training_forward(setup):
    cfg, *_, state = setup
    h, _, tl, _ = _text_and_mel(11, cfg)
    pad = np.arange(h.shape[1])[None, :] >= tl[:, None]
    for name in ("encoder", "decoder"):
        expect = _gen_apply(setup, lambda m, h, p: getattr(m, name)(h, p, deterministic=False),
                            jnp.asarray(h), jnp.asarray(pad))
        _close(getattr(state.generator, name)(_t(h), _t(pad)), expect)


def test_wavenext_training_call_with_f0(setup):
    cfg, *_, state = setup
    rng = np.random.default_rng(12)
    seg = rng.normal(size=(2, 16, cfg.generator.dim)).astype(np.float32)
    f0 = rng.normal(size=(2, 1, 16)).astype(np.float32)
    expect = _gen_apply(setup, lambda m, s, f: m.vocoder(s, f0=f, deterministic=False),
                        jnp.asarray(seg), jnp.asarray(f0))
    _close(state.generator.vocoder(_t(seg), f0=_t(f0)), expect)


def test_drop_path_rates_ramp():
    from optispeech_tpu_torch.models.modules.convnext import ConvNeXtBackbone

    rates = [b.drop_path_rate for b in ConvNeXtBackbone(8, 16, 4, drop_path=0.3).convnext]
    np.testing.assert_allclose(rates, [0.0, 0.1, 0.2, 0.3])
    assert [b.drop_path_rate for b in ConvNeXtBackbone(8, 16, 1, drop_path=0.3).convnext] == [0.0]


def test_dropout_and_drop_path_only_in_training():
    """With the published rates: training draws from the generator (same seed,
    same output; other seed, other output), eval draws nothing."""
    from optispeech_tpu_torch.models.generator import OptiSpeechGenerator

    cfg = to_torch_config(tiny_experiment())
    gen = OptiSpeechGenerator(cfg.generator)
    rng = np.random.default_rng(13)
    x = _t(rng.integers(1, 100, (4, 16)))
    h = _t(rng.normal(size=(4, 16, cfg.generator.dim)).astype(np.float32))
    pad = torch.zeros(4, 16, dtype=torch.bool)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return torch.cat([gen.text_embedding(x, g)[0].flatten(),
                          gen.encoder(h, pad, generator=g).flatten(),
                          gen.duration_predictor(h, pad, g).flatten(),
                          gen.pitch_predictor(h, pad, h[..., 0], g)[0].flatten()])

    gen.train()
    with torch.no_grad():
        a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="torch.Generator"):
        gen.text_embedding(x)
    gen.eval()
    with torch.no_grad():
        assert torch.equal(run(0), run(1))
        d = torch.cat([gen.text_embedding(x)[0].flatten(), gen.encoder(h, pad).flatten(),
                       gen.duration_predictor(h, pad).flatten(),
                       gen.pitch_predictor(h, pad, h[..., 0])[0].flatten()])
    assert torch.equal(run(0), d)


def test_generator_training_forward(setup):
    cfg, *_, state = setup
    batch = train_batch(np.random.default_rng(14), cfg)
    args = [batch[k] for k in ("x", "x_lengths", "mel", "mel_lengths", "pitches", "energies")]
    expect = _gen_apply(setup, lambda m, *a: m(*a, deterministic=False, start_idx=a[-1]),
                        *map(jnp.asarray, args), jnp.asarray(batch["start_idx"]))
    got = state.generator(*map(_t, args), start_idx=_t(batch["start_idx"]))
    np.testing.assert_array_equal(got["durations"].numpy(), np.asarray(expect["durations"]))
    np.testing.assert_array_equal(got["start_idx"].numpy(), batch["start_idx"])
    assert got["segment_size"] == expect["segment_size"]
    _close(got["wav_hat"], expect["wav_hat"])
    for k in ("loss", "align_loss", "duration_loss", "pitch_loss", "energy_loss"):
        np.testing.assert_allclose(float(got[k]), float(expect[k]), rtol=RTOL, err_msg=k)


# -- 13: discriminators ----------------------------------------------------------

def _wavs(cfg, seed=15, b=3):
    rng = np.random.default_rng(seed)
    n = cfg.generator.segment_size * cfg.generator.features.hop_length
    return [(rng.normal(size=(b, n)) * 0.1).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("family", ["multiperioddisc", "multiresddisc"])
def test_critics_scores_and_feature_maps(setup, family):
    cfg, *_, state = setup
    wav, wav_hat = _wavs(cfg)
    expect = _disc_apply(setup, lambda m, y, g: getattr(m, family)(y, g), jnp.asarray(wav),
                         jnp.asarray(wav_hat))
    got = getattr(state.discriminator, family)(_t(wav), _t(wav_hat))
    for scores_t, scores_j in zip(got[:2], expect[:2]):
        for s_t, s_j in zip(scores_t, scores_j):
            _close(s_t, s_j)
    for fmaps_t, fmaps_j in zip(got[2:], expect[2:]):
        for per_disc_t, per_disc_j in zip(fmaps_t, fmaps_j):
            for f_t, f_j in zip(per_disc_t, per_disc_j):
                _close(f_t.permute(0, 2, 3, 1), f_j)  # NCHW -> JAX's NHWC


def test_leaky_relu_gradient_at_zero_is_jax_s():
    """The critics' leaky ReLU takes JAX's gradient at exactly 0 (1, not the
    slope): a zero stretch of waveform through a zero bias gives exact zeros."""
    from optispeech_tpu_torch.models.discriminator import critics

    x = np.array([-2.0, -0.0, 0.0, 3.0], np.float32)
    expect = jax.vmap(jax.grad(lambda v: jax.nn.leaky_relu(v, critics.LRELU_SLOPE)))(
        jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    critics._leaky_relu(t).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(expect))
    np.testing.assert_array_equal(critics._leaky_relu(t).detach().numpy(),
                                  np.asarray(jax.nn.leaky_relu(jnp.asarray(x),
                                                               critics.LRELU_SLOPE)))


def test_torch_weight_norm_init(setup):
    """g = ||v|| per output channel, as the JAX function sets the flax scales
    (`init_train_state` applies it; the bridge carried its result over)."""
    from optispeech_tpu_torch.models.discriminator import torch_weight_norm_init

    *_, state = setup
    sd = {k: v.clone() for k, v in state.discriminator.state_dict().items()}
    with torch.no_grad():
        for k, v in state.discriminator.state_dict().items():
            if k.endswith("original0"):
                v.fill_(1.0)
    torch_weight_norm_init(state.discriminator)
    for k, v in state.discriminator.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=1e-6, atol=0)


@pytest.mark.parametrize("entry", ["forward_disc", "forward_gen", "forward_val"])
def test_vocos_losses(setup, entry):
    cfg, _, jdisc, _, state = setup
    wav, wav_hat = _wavs(cfg, seed=16)
    jloss, jlog = _disc_apply(setup, getattr(type(jdisc), entry), jnp.asarray(wav),
                              jnp.asarray(wav_hat))
    tloss, tlog = getattr(state.discriminator, entry)(_t(wav), _t(wav_hat))
    assert set(tlog) == set(jlog)
    for k in jlog:
        np.testing.assert_allclose(float(tlog[k]), float(jlog[k]), rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL)
