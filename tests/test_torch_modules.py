"""Port's modules against the JAX modules on the CPU, with the same weights
(JAX init -> `state_dict_from_jax_params` -> port) and the same numpy inputs.

Tolerance atol 1e-4: both sides compute in float32; flax's LayerNorm takes
the variance as E[x^2] - E[x]^2 and torch's the centred form, and the convs
sum in other orders, so gaps of ~1e-6 per layer are expected.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import build_pair, random_tokens, small_config

torch.set_num_threads(1)

ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    return build_pair(small_config(num_speakers=3, languages=("en-us", "en-gb")))


@pytest.fixture(scope="module")
def pair_f0():
    return build_pair(small_config(f0_cond=True))


def _apply(japi, fn, *args):
    """Run `fn(generator_module, *args)` inside the JAX generator's scope."""
    return japi.generator.apply({"params": japi.params}, *args, method=fn)


def _inputs(seed, dim=32, lengths=(32, 20, 9)):
    rng = np.random.default_rng(seed)
    x, x_lengths = random_tokens(rng, lengths)
    h = rng.normal(size=(len(lengths), x.shape[1], dim)).astype(np.float32)
    pad = np.arange(x.shape[1])[None, :] >= x_lengths[:, None]
    return x, h, pad


def test_text_embedding(pair):
    japi, tapi = pair
    x, _, _ = _inputs(0)
    je, jemb = _apply(japi, lambda m, x: m.text_embedding(x), jnp.asarray(x))
    with torch.no_grad():
        te, temb = tapi.generator.text_embedding(torch.from_numpy(x).long())
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=ATOL)
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), atol=ATOL)
    assert np.all(temb.numpy()[x == 0] == 0)  # the PAD row is zeroed at use


def test_encoder_backbone_unfused(pair):
    japi, tapi = pair
    _, h, pad = _inputs(1)
    expect = _apply(japi, lambda m, h, p: m.encoder(h, p), jnp.asarray(h), jnp.asarray(pad))
    with torch.no_grad():
        got = tapi.generator.encoder(torch.from_numpy(h), torch.from_numpy(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=ATOL)


def test_duration_predictor(pair):
    japi, tapi = pair
    _, h, pad = _inputs(2)
    jh, jpad = jnp.asarray(h), jnp.asarray(pad)
    th, tpad = torch.from_numpy(h), torch.from_numpy(pad)
    expect = _apply(japi, lambda m, h, p: m.duration_predictor(h, p), jh, jpad)
    with torch.no_grad():
        got = tapi.generator.duration_predictor(th, tpad)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=ATOL)
    for factor in (1.0, 3.7):
        expect = _apply(japi, lambda m, h, p: m.duration_predictor.infer(h, p, factor), jh, jpad)
        with torch.no_grad():
            got = tapi.generator.duration_predictor.infer(th, tpad, factor)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


@pytest.mark.parametrize("name", ["pitch_predictor", "energy_predictor"])
def test_pitch_and_energy_predictor_infer(pair, name):
    japi, tapi = pair
    _, h, pad = _inputs(3)
    factor = 1.6
    jx, jp = _apply(japi, lambda m, h, p: getattr(m, name).infer(h, p, factor),
                    jnp.asarray(h), jnp.asarray(pad))
    with torch.no_grad():
        tx, tp = getattr(tapi.generator, name).infer(torch.from_numpy(h), torch.from_numpy(pad),
                                                     factor)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL)


def test_separable_predictors():
    """The `light` variants' ConvSeparable predictors (depthwise + pointwise)."""
    japi, tapi = build_pair(small_config(separable=True))
    _, h, pad = _inputs(5)
    jh, jpad = jnp.asarray(h), jnp.asarray(pad)
    th, tpad = torch.from_numpy(h), torch.from_numpy(pad)
    jd = _apply(japi, lambda m, h, p: m.duration_predictor.infer(h, p, 2.5), jh, jpad)
    jx, jp = _apply(japi, lambda m, h, p: m.pitch_predictor.infer(h, p, 1.6), jh, jpad)
    with torch.no_grad():
        td = tapi.generator.duration_predictor.infer(th, tpad, 2.5)
        tx, tp = tapi.generator.pitch_predictor.infer(th, tpad, 1.6)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL)


@pytest.mark.parametrize("f0_cond", [False, True])
def test_wavenext(pair, pair_f0, f0_cond):
    japi, tapi = pair_f0 if f0_cond else pair
    rng = np.random.default_rng(4)
    b, t = 2, 128
    y = rng.normal(size=(b, t, 32)).astype(np.float32)
    pad = np.arange(t)[None, :] >= np.array([128, 77])[:, None]
    f0 = rng.normal(size=(b, t)).astype(np.float32) if f0_cond else None
    expect = _apply(japi, lambda m, y, f0, p: m.vocoder(y, f0=f0, padding_mask=p),
                    jnp.asarray(y), None if f0 is None else jnp.asarray(f0), jnp.asarray(pad))
    with torch.no_grad():
        got = tapi.generator.vocoder(torch.from_numpy(y),
                                     None if f0 is None else torch.from_numpy(f0),
                                     torch.from_numpy(pad))
    assert got.shape == (b, t * 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=ATOL)
