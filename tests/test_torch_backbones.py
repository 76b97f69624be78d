"""The other backbone kinds (LightSpeech, Transformer, Conformer with either
conv norm, LeanSpeech) in the port, against the JAX package on the CPU with
the same weights (JAX init -> `compat/from_jax.py` -> port) and numpy
inputs from seeds.

Sizes: dim 32, 2 blocks (LightSpeech: kernel sizes 5 and 9), 64 linear
units, the test-size predictors (separable for LightSpeech, as the `light`
configs have them), trunk 48/96. One JAX model per kind, shared by the
module's tests.

Tolerances:
- each backbone alone, float32, with a padding mask: atol 1e-5, rtol 1e-4
  (tests/test_backbone_invariance.py's);
- synthesis: durations exactly equal, wav atol 1e-4
  (tests/test_torch_synthesis.py's);
- bf16 (dim 64): durations equal to JAX's bf16 encode run op by op
  (`jax.disable_jit()`), or one frame apart on at most 5% of the tokens
  (see `test_bf16_follows_jax`), the wav within 3e-2 of max|wav| of JAX's
  jitted bf16 decode (tests/test_torch_bf16.py's WAV_RTOL); the
  Conformer's layers alone bit-equal to JAX's op by op;
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import params_np, random_tokens, small_config, to_torch_config

from optispeech_tpu_torch.models.optispeech import OptiSpeech, with_fused_blocks

torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-4
WAV_ATOL = 1e-4
WAV_RTOL = 3e-2  # tests/test_torch_bf16.py's, the port against JAX's jitted bf16
MAX_MOVED = 0.05  # tests/test_torch_bf16.py's share for JAX's jitted run
TEXT = "The birch canoe slid on the smooth planks. Glue the sheet to the dark blue background."
# kind -> (backbone kind, conformer conv norm)
KINDS = {"lightspeech": ("lightspeech", "layernorm"), "transformer": ("transformer", "layernorm"),
         "conformer": ("conformer", "layernorm"), "conformer_affine": ("conformer", "affine"),
         "leanspeech": ("leanspeech", "layernorm")}


def kind_config(kind, norm="layernorm", dim=32, **kw):
    """`small_config` with both stacks of `kind` at test size."""
    cfg = small_config(dim=dim, separable=kind == "lightspeech", **kw)
    g = cfg.generator
    bb = lambda b: dataclasses.replace(  # noqa: E731
        b, kind=kind, kernel_sizes=(5, 9), num_blocks=2, linear_units=64, conv_norm=norm,
        kernel_size=5)
    return dataclasses.replace(cfg, generator=dataclasses.replace(
        g, encoder=bb(g.encoder), decoder=bb(g.decoder)))


def randomise_affine(params, seed):
    """JAX inits the affine conv norm at one and zero; give it other values
    so that its mapping is exercised."""
    rng = np.random.default_rng(seed)
    for stack in ("encoder", "decoder"):
        for name, sub in params[stack].items():
            if name.startswith("conv_module_"):
                sub["norm_scale"] = (1.0 + 0.3 * rng.normal(size=sub["norm_scale"].shape)
                                     ).astype(np.float32)
                sub["norm_bias"] = (0.3 * rng.normal(size=sub["norm_bias"].shape)
                                    ).astype(np.float32)
    return params


def build_kind_pair(name, seed=0):
    """(JAX OptiSpeech, port OptiSpeech on the CPU, JAX params as numpy) for
    one entry of KINDS, one set of weights."""
    from optispeech_tpu.models.optispeech import OptiSpeech as JaxOptiSpeech

    kind, norm = KINDS[name]
    cfg = kind_config(kind, norm)
    params = params_np(JaxOptiSpeech(cfg, seed=seed).params)
    if norm == "affine":
        params = randomise_affine(params, seed)
    japi = JaxOptiSpeech(cfg, params=jax.tree_util.tree_map(jnp.asarray, params))
    tapi = OptiSpeech.load_from_jax_params(to_torch_config(cfg), params, device="cpu")
    return japi, tapi, params


@pytest.fixture(scope="module", params=list(KINDS))
def pair(request):
    return (request.param, *build_kind_pair(request.param))


@pytest.mark.parametrize("stack", ["encoder", "decoder"])
def test_backbone_alone_matches_jax(pair, stack):
    from optispeech_tpu.models.generator import make_backbone

    name, japi, tapi, params = pair
    bb_cfg = getattr(japi.cfg.generator, stack)
    jbb = make_backbone(bb_cfg, 32, jnp.float32, stack, is_decoder=stack == "decoder")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 23, 32)).astype(np.float32)
    pad = np.arange(23)[None, :] >= np.array([23, 14, 5])[:, None]
    want = jbb.apply({"params": params[stack]}, jnp.asarray(x), jnp.asarray(pad),
                     deterministic=True)
    with torch.no_grad():
        got = getattr(tapi.generator, stack)(torch.from_numpy(x), torch.from_numpy(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("t", [1, 7, 12])
def test_rel_shift_indexes_as_transformer_xl(t):
    """out[q, k] = x[q, T-1 - (q-k)], and equal to JAX's, odd T included."""
    from optispeech_tpu.models.modules.conformer import _rel_shift as jax_rel_shift
    from optispeech_tpu_torch.models.modules.conformer import _rel_shift, rel_positional_encoding

    x = np.random.default_rng(t).normal(size=(2, 3, t, 2 * t - 1)).astype(np.float32)
    got = _rel_shift(torch.from_numpy(x)).numpy()
    q, k = np.meshgrid(np.arange(t), np.arange(t), indexing="ij")
    np.testing.assert_array_equal(got, x[:, :, q, t - 1 - (q - k)])
    np.testing.assert_array_equal(got, np.asarray(jax_rel_shift(jnp.asarray(x))))
    from optispeech_tpu.models.modules.conformer import rel_positional_encoding as jax_rel_pe

    np.testing.assert_array_equal(rel_positional_encoding(t, 32).numpy(), jax_rel_pe(t, 32))


def test_sinusoidal_encoding_equals_jax_table():
    from optispeech_tpu.models.modules.transformer import sinusoidal_encoding as jax_pe
    from optispeech_tpu_torch.models.modules.transformer import sinusoidal_encoding

    for t, dim in ((1, 32), (37, 32), (300, 256)):
        np.testing.assert_array_equal(sinusoidal_encoding(t, dim).numpy(), jax_pe(t, dim))


def test_synthesise_matches_jax(pair):
    name, japi, tapi, _ = pair
    kw = dict(d_factor=3.0, p_factor=1.3, e_factor=0.9)
    jout = japi.synthesise(japi.prepare_input(TEXT, **kw))
    inputs = tapi.prepare_input(TEXT, **kw)
    tout = tapi.synthesise(inputs)
    np.testing.assert_array_equal(tout.durations, jout.durations)
    np.testing.assert_array_equal(tout.wav_lengths, jout.wav_lengths)
    assert tout.wav.shape == jout.wav.shape
    np.testing.assert_allclose(tout.wav, jout.wav, atol=WAV_ATOL)
    np.testing.assert_allclose(tout.pitch, jout.pitch, atol=WAV_ATOL)


def test_synthesise_on_device_matches_jax(pair):
    """The fixed-cap path, batch 3 at 96 frames, against JAX's."""
    name, japi, tapi, _ = pair
    x, x_lengths = random_tokens(np.random.default_rng(4), [29, 17, 6])
    from optispeech_tpu_torch.values import InferenceInputs

    inputs = InferenceInputs(clean_text="", x=x, x_lengths=x_lengths, d_factor=2.0)
    want = japi.synthesise_on_device(inputs, n_frames=96)
    got = tapi.synthesise_on_device(inputs, n_frames=96)
    np.testing.assert_array_equal(got["durations"].numpy(), np.asarray(want["durations"]))
    np.testing.assert_allclose(got["wav"].numpy(), np.asarray(want["wav"]), atol=WAV_ATOL)


def test_fused_model_fuses_the_trunk_only(pair, monkeypatch):
    """`with_fused_blocks` on these kinds: the decoder stays as it is, the
    trunk's 2 blocks take B1 (its twin here) once each per decode, and the
    wav stays within 1e-4 of the unfused model's."""
    from optispeech_tpu_torch.models.modules import convnext

    name, japi, tapi, _ = pair
    cfg = with_fused_blocks(tapi.cfg)
    assert cfg.generator.decoder == tapi.cfg.generator.decoder
    assert cfg.generator.vocoder.fused_pallas
    fused = OptiSpeech(cfg, device="cpu", state_dict=tapi.generator.state_dict())
    calls, block = [], convnext.convnext_block_fused

    def counting(x, *args, **kw):
        calls.append(x.shape[1])
        return block(x, *args, **kw)

    monkeypatch.setattr(convnext, "convnext_block_fused", counting)
    inputs = tapi.prepare_input(TEXT, d_factor=2.0)
    got = fused.synthesise_on_device(inputs, n_frames=128)
    assert calls == [128] * tapi.cfg.generator.vocoder.num_layers
    want = tapi.synthesise_on_device(inputs, n_frames=128)
    np.testing.assert_array_equal(got["durations"].numpy(), want["durations"].numpy())
    np.testing.assert_allclose(got["wav"].numpy(), want["wav"].numpy(), atol=WAV_ATOL)


@pytest.mark.parametrize("name", list(KINDS))
def test_bf16_follows_jax(name):
    """bf16 compute, at dim 64. The token-rate stage against JAX's bf16
    `encode` run op by op: durations equal, or one frame apart on at most
    MAX_MOVED of the tokens. Each layer follows flax's order and is
    bit-equal on its own (`test_conformer_layers_bit_equal_in_bf16`), but
    a float32 result on the midpoint of two bf16 values rounds by the last
    bit of its float32 value, and XLA's CPU differs from torch's in such
    bits: its `lax.rsqrt`, which flax's LayerNorm calls, is not correctly
    rounded (it differs from 1 / sqrt on about a third of float32 inputs),
    and its reductions sum in other orders. A step so taken is carried on
    by the later layers to the duration predictor. The frame-rate stage on
    JAX's encode outputs against JAX's jitted bf16 `decode` (op by op, the
    LSTM's scan would take minutes): the wav within WAV_RTOL of max|wav|.
    Dim 64 as tests/test_torch_bf16.py: at a dim whose square root bf16
    does not hold (32) the text embedding's sqrt(dim) scale rounds to bf16
    in JAX op by op but not under jit, which the port follows."""
    from optispeech_tpu.models.optispeech import OptiSpeech as JaxOptiSpeech
    from optispeech_tpu_torch.values import InferenceInputs

    kind, norm = KINDS[name]
    cfg = kind_config(kind, norm, dim=64)
    params = params_np(JaxOptiSpeech(cfg, seed=0).params)
    if norm == "affine":
        params = randomise_affine(params, 0)
    jbf = JaxOptiSpeech(cfg, params=jax.tree_util.tree_map(jnp.asarray, params),
                        compute_dtype=jnp.bfloat16)
    port = OptiSpeech.load_from_jax_params(to_torch_config(cfg), params, device="cpu",
                                           compute_dtype=torch.bfloat16)
    x, x_lengths = random_tokens(np.random.default_rng(7), [45, 38, 21], 64)
    inputs = InferenceInputs(clean_text="", x=x, x_lengths=x_lengths, d_factor=4.0)
    tx, txl, _, _, d, p, e = port._tensors(inputs)
    with jax.disable_jit():
        jenc = jbf._encode_jit(jbf.params, jnp.asarray(x), jnp.asarray(x_lengths), None, None,
                               jnp.float32(d), jnp.float32(p), jnp.float32(e))
    with torch.no_grad():
        got = port.generator.encode(tx, txl, None, None, d, p, e)["durations"].numpy()
    want = np.asarray(jenc["durations"])
    moved = got != want
    print(f"{name}: {int(moved.sum())} of {moved.size} durations moved")
    assert np.abs(got - want).max() <= 1 and moved.mean() <= MAX_MOVED

    n_frames = 256
    y_lengths = np.minimum(np.asarray(jenc["y_lengths"]), n_frames).astype(np.int32)
    jdec = jbf._decode_jit(jbf.params, jenc["hidden"], jenc["durations"], jenc["x_mask"],
                           jnp.asarray(y_lengths), n_frames)
    with torch.no_grad():
        tdec = port.generator.decode(
            torch.from_numpy(np.asarray(jenc["hidden"].astype(jnp.float32))).bfloat16(),
            torch.from_numpy(want), torch.from_numpy(np.asarray(jenc["x_mask"])),
            torch.from_numpy(y_lengths), n_frames)
    jwav = np.asarray(jdec["wav"])
    rel = np.abs(tdec["wav"].numpy() - jwav).max() / np.abs(jwav).max()
    assert rel <= WAV_RTOL, rel


@pytest.mark.parametrize("norm", ["layernorm", "affine"])
def test_conformer_layers_bit_equal_in_bf16(norm):
    """The Conformer's conv module, relative-position attention and FFN in
    bf16, each against JAX's applied op by op on the same bf16 input: equal
    bit for bit (flax's order: GLU and swish with a rounded sigmoid, the
    scores divided by sqrt(d) in bf16, softmax's rounded steps)."""
    from optispeech_tpu.models.modules import conformer as jc
    from optispeech_tpu_torch.models.modules import conformer as tc

    _, tapi, params = build_kind_pair("conformer_affine" if norm == "affine" else "conformer")
    p = params["encoder"]
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.normal(size=(2, 13, 32)).astype(np.float32), jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).bfloat16()
    pad = np.arange(13)[None] >= np.array([13, 8])[:, None]
    layer = tc.ConformerLayer(32, 2, 64, 0.0, 0.0, 7, norm, torch.bfloat16).eval()
    layer.load_state_dict({k.split("encoders.0.", 1)[1]: v
                           for k, v in tapi.generator.state_dict().items()
                           if k.startswith("encoder.conformer.encoders.0.")})
    pe = jnp.asarray(jc.rel_positional_encoding(13, 32), jnp.bfloat16)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    with jax.disable_jit(), torch.no_grad():
        pairs = {
            "conv_module": (
                jc.ConvModule(32, 7, norm, dtype=jnp.bfloat16).apply(
                    {"params": p["conv_module_0"]}, x),
                layer.conv_module(xt)),
            "self_attn": (
                jc.RelPosSelfAttention(32, 2, dtype=jnp.bfloat16).apply(
                    {"params": p["self_attn_0"]}, x, pe, jnp.asarray(pad)),
                layer.self_attn(xt, tc.rel_positional_encoding(13, 32).bfloat16(),
                                torch.from_numpy(pad))),
            "feed_forward": (
                jc.ConvFFN(32, 64, 1, 0.0, dtype=jnp.bfloat16).apply({"params": p["ff_0"]}, x),
                layer.feed_forward(xt)),
        }
    for key, (want, got) in pairs.items():
        np.testing.assert_array_equal(got.float().numpy(), bf(want), err_msg=key)


def test_new_modules_import_no_jax():
    """The walk of tests/test_torch_isolation.py imports the new modules, and
    they leave JAX, flax and the JAX package out."""
    import subprocess
    import sys

    from test_torch_isolation import _IMPORT_ALL, REPO

    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    walked = set(out.stdout.splitlines()[1].split())
    for name in ("lightspeech", "transformer", "conformer", "leanspeech"):
        assert f"optispeech_tpu_torch.models.modules.{name}" in walked
    assert "optispeech_tpu_torch.compat.torch_import" in walked
