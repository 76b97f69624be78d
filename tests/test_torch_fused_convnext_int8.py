"""The int8 fused ConvNeXt block of the port (B2) and its A/B entry point:
the quantizers bit for bit against JAX's, the plain twin against JAX's
oracle and its Pallas kernel in interpret mode, the kernel's weight pack
read back to JAX's codes and scales, the wrapper's and the launch's
argument checks, `cli/int8_ab.py` on the CPU (one pack per arm), and, where
a card exists, the CUDA kernel bit-equal to its twin.

The JAX side is imported inside the tests that use it, so that on a machine
with a card and without JAX the kernel test still collects:
    python -m pytest --noconftest tests/test_torch_fused_convnext_int8.py -k cuda

Twin against JAX: an int8 code that lies within an ulp of a rounding
boundary can round the other way when `mean`, `exp` or the square root
differ by an ulp between XLA and PyTorch, and then its whole frame moves (by
~1e-3 of max|ref|). So the JAX package's 1e-5 (tests/test_pallas_convnext.py:69)
is held on at least 99% of the frames, and every element within 1e-2 of
max|ref|.
"""

import numpy as np
import pytest
import torch

from optispeech_tpu_torch.ops import fused_convnext as fc
from torch_card import cuda  # noqa: F401  (fixture)

torch.set_num_threads(1)

TOL = 1e-5  # atol = rtol, tests/test_pallas_convnext.py:69
FRAME_SHARE = 0.99  # frames that must agree within TOL
ELEM_REL = 1e-2  # every element, relative to max|ref|
BF16_RTOL = 2 * 2.0 ** -7  # a bfloat16 output: two roundings of the result
F32_BLOCK_REL = 0.02  # int8 block against the unquantized one, tests/test_pallas_convnext.py:74


def _block_args(rng, b, t, c, inter, dtype=torch.float32):
    """x and the nine parameters as float32 numpy-drawn tensors (the JAX
    test's scales, with a non-trivial LayerNorm)."""
    mk = lambda *s, sc=0.1: torch.from_numpy(  # noqa: E731
        (rng.normal(size=s) * sc).astype(np.float32))
    x = mk(b, t, c, sc=0.5).to(dtype)
    params = [mk(7, c), mk(c), 1.0 + mk(c), mk(c), mk(c, inter, sc=0.05), mk(inter, sc=0.02),
              mk(inter, c, sc=0.05), mk(c, sc=0.02), torch.full((c,), 0.25)]
    return x, params


def _jax(*tensors):
    import jax.numpy as jnp

    return [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) if t.dtype == torch.bfloat16
            else jnp.asarray(t.numpy()) for t in tensors]


def _assert_frames_agree(got, ref, rtol=TOL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    diff = np.abs(got - ref)
    close = diff <= TOL + rtol * np.abs(ref)
    outside = int((~close.all(axis=-1)).sum())
    frames = close.shape[0] * close.shape[1]
    rel = float(diff.max() / np.abs(ref).max())
    print(f"{outside} of {frames} frames outside atol {TOL}, rtol {rtol:.4g}; "
          f"max|diff|/max|ref| {rel:.3e}")
    assert outside <= (1 - FRAME_SHARE) * frames, (outside, frames)
    assert rel <= ELEM_REL, rel


@pytest.mark.parametrize("shape", [(128, 256), (384, 1152), (1152, 384)])
def test_quantize_weight_int8_equals_jax(shape):
    from optispeech_tpu.ops.pallas_convnext import quantize_weight_int8

    w = (np.random.default_rng(sum(shape)).normal(size=shape) * 0.05).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero output channel takes the 1e-12 floor
    q, s = fc.quantize_weight_int8(torch.from_numpy(w))
    jq, js = quantize_weight_int8(*_jax(torch.from_numpy(w)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("shape", [(512, 128), (1024, 1152)])
def test_quantize_rows_int8_equals_jax(shape):
    from optispeech_tpu.ops.pallas_convnext import _quant_rows

    h = (np.random.default_rng(shape[0]).normal(size=shape) * 2.0).astype(np.float32)
    h[5] = 0.0  # an all-zero frame takes the 1e-12 floor
    q, s = fc.quantize_rows_int8(torch.from_numpy(h))
    jq, js = _quant_rows(*_jax(torch.from_numpy(h)))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_erf_matches_jax():
    """Within 2**-23, one float32 ulp of 1.0, the scale of |erf|: the two
    differ only where exp(-x*x) does (by an ulp between XLA and PyTorch), and
    near 0 the final `1 - poly * exp(-x*x)` cancels, so the gap is not an ulp
    of the result there."""
    from optispeech_tpu.ops.pallas_convnext import _erf

    x = np.concatenate([np.linspace(-6.0, 6.0, 200001), [0.0, 1e-30, -1e-30, 30.0, -30.0]])
    x = x.astype(np.float32)
    got = fc._erf(torch.from_numpy(x)).numpy()
    expect = np.asarray(_erf(*_jax(torch.from_numpy(x))))
    assert np.abs(got - expect).max() <= 2.0 ** -23
    np.testing.assert_array_equal(got[x == 0.0], 0.0)
    np.testing.assert_array_equal(got[np.abs(x) >= 6.0], np.sign(x[np.abs(x) >= 6.0]))


@pytest.mark.parametrize("b,t,c,inter,dtype", [
    (2, 256, 128, 256, torch.float32), (2, 512, 384, 1152, torch.float32),
    (2, 256, 128, 256, torch.bfloat16)])
def test_twin_matches_jax_oracle(b, t, c, inter, dtype):
    from optispeech_tpu.ops.pallas_convnext import convnext_block_int8_oracle

    x, p = _block_args(np.random.default_rng(1234), b, t, c, inter, dtype)
    expect = convnext_block_int8_oracle(*_jax(x, *p))
    got = fc.convnext_block_int8_reference(x, *p)
    assert got.dtype == dtype and got.shape == x.shape
    _assert_frames_agree(got.float().numpy(), np.asarray(expect, np.float32),
                         TOL + (BF16_RTOL if dtype == torch.bfloat16 else 0.0))


@pytest.mark.parametrize("b,t,c,inter,t_tile", [(2, 256, 128, 256, 128),
                                                (2, 512, 384, 1152, 512)])
def test_twin_matches_jax_interpret_kernel(b, t, c, inter, t_tile):
    from optispeech_tpu.ops.pallas_convnext import convnext_block_fused_int8

    x, p = _block_args(np.random.default_rng(1234), b, t, c, inter)
    expect = convnext_block_fused_int8(*_jax(x, *p), t_tile=t_tile, interpret=True)
    launches = fc.convnext_block_fused_int8.launches
    got = fc.convnext_block_fused_int8(x, *p)  # CPU tensor: the twin
    assert fc.convnext_block_fused_int8.launches == launches
    _assert_frames_agree(got.numpy(), np.asarray(expect))


@pytest.mark.parametrize("block", ["bf16_products", "float32"])
def test_twin_stays_close_to_the_unquantized_block(block):
    """Quantization error against B1's twin (bf16 products, the JAX test's
    `_ref`) and against the plain float32 block."""
    from optispeech_tpu_torch.cli.int8_ab import unfused_block

    x, p = _block_args(np.random.default_rng(1234), 2, 256, 128, 256)
    got = fc.convnext_block_int8_reference(x, *p)
    if block == "bf16_products":
        ref = fc.convnext_block_reference(x, *p)
    else:
        names = ("dw", "dwb", "lnw", "lnb", "w1", "b1", "w2", "b2", "gamma")
        ref = unfused_block(x, dict(zip(names, p)), torch.float32)
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err < F32_BLOCK_REL, err


@pytest.mark.parametrize("b,t", [(80, 5), (11, 37), (2, 300)])
def test_twin_takes_any_t(b, t):
    """Ragged T and T shorter than the halo, against the JAX oracle (which
    takes any T; the JAX kernel asks T to be a multiple of its tile). At
    least 400 frames each, so that 1% of them is a whole frame or more."""
    from optispeech_tpu.ops.pallas_convnext import convnext_block_int8_oracle

    x, p = _block_args(np.random.default_rng(t), b, t, 256, 1024)
    expect = convnext_block_int8_oracle(*_jax(x, *p))
    got = fc.convnext_block_fused_int8(x, *p)
    assert got.shape == (b, t, 256)
    _assert_frames_agree(got.numpy(), np.asarray(expect))


@pytest.mark.parametrize("case", ["channels", "inter", "too_wide", "dtype", "weight_dtype",
                                  "shape", "contiguous", "empty"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    c, inter = 384, 1152
    x, p = _block_args(np.random.default_rng(0), 1, 9, c, inter)
    check = lambda x, p: fc._check_args(  # noqa: E731  (the wrapper's check for the card)
        x, *p, weight_dtype=torch.float32, channels=fc.INT8_CHANNELS, inter_step=fc.I_CHUNK)
    check(x, p)  # the valid set passes
    if case == "channels":
        x, p = _block_args(np.random.default_rng(0), 1, 9, 192, inter)
    elif case == "inter":
        x, p = _block_args(np.random.default_rng(0), 1, 9, c, 1000)
    elif case == "too_wide":  # wider than B2's widest instantiation (B1 takes it)
        x, p = _block_args(np.random.default_rng(0), 1, 9, 512, 2048)
    elif case == "dtype":
        x = x.double()
    elif case == "weight_dtype":  # the wrapper quantizes float32 weights itself
        p[4] = p[4].bfloat16()
    elif case == "shape":
        p[6] = p[6][:-64]
    elif case == "contiguous":
        p[4] = p[4].t().contiguous().t()
    elif case == "empty":
        x = x[:, :0]
    with pytest.raises(ValueError):
        check(x, p)


def _swizzled(e):
    """Byte offset -> its place in a 128-byte-swizzled image: the 16-byte
    group within each 128-byte row XORed with the row's index mod 8."""
    return e ^ (((e >> 7) & 7) << 4)


@pytest.mark.parametrize("c,inter", [(128, 256), (128, 320), (256, 1024), (384, 1152)])
def test_kernel_weights_int8_invert_to_jax_codes_and_scales(c, inter):
    """Every code read back from the pack by the layout B2's s8 wgmma
    descriptors name (K-major, 128 codes to a 128-byte row, W1 in 128-code
    K-blocks of 128 rows), byte by byte, equals JAX's code; the padding of
    I to a multiple of 128 (I = 320) holds zeros; the scales are JAX's."""
    from optispeech_tpu.ops.pallas_convnext import quantize_weight_int8

    rng = np.random.default_rng(c + inter)
    w1 = (rng.normal(size=(c, inter)) * 0.05).astype(np.float32)
    w2 = (rng.normal(size=(inter, c)) * 0.05).astype(np.float32)
    images, s1, s2 = fc.kernel_weights_int8(torch.from_numpy(w1), torch.from_numpy(w2))
    n = -(-inter // 128)
    assert images.dtype == torch.int8 and images.is_contiguous()
    assert tuple(images.shape) == (n, 2, c, 128)
    (jq1, js1), (jq2, js2) = (quantize_weight_int8(*_jax(torch.from_numpy(w))) for w in (w1, w2))
    np.testing.assert_array_equal(s1.numpy(), np.asarray(js1))
    np.testing.assert_array_equal(s2.numpy(), np.asarray(js2))
    flat = images.numpy().reshape(n, 2, c * 128)
    k, i = np.meshgrid(np.arange(c), np.arange(inter), indexing="ij")  # w1q[k, i]
    got1 = flat[i // 128, 0, _swizzled((k // 128) * 128 * 128 + (i % 128) * 128 + k % 128)]
    np.testing.assert_array_equal(got1, np.asarray(jq1))
    i, cc = np.meshgrid(np.arange(inter), np.arange(c), indexing="ij")  # w2q[i, c]
    got2 = flat[i // 128, 1, _swizzled(cc * 128 + i % 128)]
    np.testing.assert_array_equal(got2, np.asarray(jq2))
    if inter % 128:  # the padded half of the last chunk
        k, i = np.meshgrid(np.arange(c), np.arange(inter, n * 128), indexing="ij")
        assert not flat[n - 1, 0, _swizzled((k // 128) * 16384 + (i % 128) * 128 + k % 128)].any()
        i, cc = np.meshgrid(np.arange(inter, n * 128), np.arange(c), indexing="ij")
        assert not flat[n - 1, 1, _swizzled(cc * 128 + i % 128)].any()


@pytest.mark.parametrize("case", ["not_a_triple", "images_shape", "images_dtype",
                                  "images_contiguous", "s1_shape", "s2_dtype", "inter"])
def test_launch_rejects_a_malformed_pack(case):
    """The launch checks the pack before it touches a card."""
    c, inter = 256, 1024
    x, p = _block_args(np.random.default_rng(0), 1, 9, c, inter)
    images, s1, s2 = fc.kernel_weights_int8(p[4], p[6])
    if case == "not_a_triple":
        packed = (images, s1)
    elif case == "images_shape":
        packed = (images[:-1], s1, s2)
    elif case == "images_dtype":
        packed = (images.view(torch.uint8), s1, s2)
    elif case == "images_contiguous":
        packed = (images.transpose(2, 3).contiguous().transpose(2, 3), s1, s2)
    elif case == "s1_shape":
        packed = (images, s1[:-64], s2)
    elif case == "s2_dtype":
        packed = (images, s1, s2.double())
    else:  # b1 not a multiple of 64 wide
        packed, p[5] = (images, s1, s2), p[5][:-8]
    with pytest.raises(ValueError, match="packed"):
        fc.convnext_block_int8_launch(x, *p[:4], packed, p[5], p[7], p[8])


def test_int8_ab_packs_once_per_arm(monkeypatch):
    """The A/B's fused arms pack their weights once, however many trunk
    calls they run: the 8 blocks share their parameters, as in JAX's jit."""
    from optispeech_tpu_torch.cli import int8_ab

    packs = {"kernel_weights": 0, "kernel_weights_int8": 0}

    def counted(name, fn):
        def call(*args):
            packs[name] += 1
            return fn(*args)
        return call

    for name in packs:
        monkeypatch.setattr(fc, name, counted(name, getattr(fc, name)))
    arms = int8_ab.arms(int8_ab.make_params(torch.Generator().manual_seed(0)))
    x = torch.randn(1, 8, int8_ab.C, generator=torch.Generator().manual_seed(1)).bfloat16()
    with torch.no_grad():
        for _ in range(3):
            arms["fused_bf16"](x)
            arms["fused_int8"](x)
    assert packs == {"kernel_weights": 1, "kernel_weights_int8": 1}


def test_cpu_tensor_runs_the_twin_and_launches_nothing():
    x, p = _block_args(np.random.default_rng(3), 1, 40, 128, 256, torch.bfloat16)
    launches = fc.convnext_block_fused_int8.launches
    got = fc.convnext_block_fused_int8(x, *p)
    assert fc.convnext_block_fused_int8.launches == launches
    assert torch.equal(got, fc.convnext_block_int8_reference(x, *p)) and got.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="no kernel"):
        fc.convnext_block_fused_int8(x.to("meta"), *[q.to("meta") for q in p])


def _xla_block(x, p, dtype):
    """`scripts/int8_ab.py::xla_block` (:52-65), copied: importing the script
    turns on JAX's persistent compile cache in the user's cache directory."""
    import jax
    import jax.numpy as jnp

    xf = x.astype(dtype)
    pad = jnp.pad(xf, ((0, 0), (3, 3), (0, 0)))
    acc = sum(
        pad[:, k : k + x.shape[1], :] * p["dw"][k][None, None, :].astype(dtype)
        for k in range(7)
    )
    acc = (acc + p["dwb"].astype(dtype)).astype(jnp.float32)
    mean = acc.mean(axis=-1, keepdims=True)
    var = ((acc - mean) ** 2).mean(axis=-1, keepdims=True)
    h = ((acc - mean) * jax.lax.rsqrt(var + 1e-6) * p["lnw"] + p["lnb"]).astype(dtype)
    h1 = jax.nn.gelu(h @ p["w1"].astype(dtype) + p["b1"].astype(dtype), approximate=False)
    h2 = h1 @ p["w2"].astype(dtype) + p["b2"].astype(dtype)
    return (x + p["gamma"].astype(x.dtype) * h2.astype(x.dtype)).astype(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unfused_block_matches_the_jax_script(dtype):
    """float32: 1e-5. bfloat16: the two frameworks round the dwconv's sum,
    the products and the GELU to bfloat16 at other points, so an element may
    differ by a few bfloat16 steps of its own size: every element within two
    steps at the output's largest magnitude, 2 * 2**-7 * max|ref|."""
    import jax.numpy as jnp

    from optispeech_tpu_torch.cli.int8_ab import unfused_block

    x, p = _block_args(np.random.default_rng(5), 2, 96, 384, 1152, dtype)
    names = ("dw", "dwb", "lnw", "lnb", "w1", "b1", "w2", "b2", "gamma")
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    expect = np.asarray(_xla_block(_jax(x)[0], dict(zip(names, _jax(*p))), jdtype), np.float32)
    got = unfused_block(x, dict(zip(names, p)), dtype)
    assert got.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), expect, atol=TOL, rtol=TOL)
    else:
        assert np.abs(got.float().numpy() - expect).max() <= BF16_RTOL * np.abs(expect).max()


def test_int8_ab_main_on_the_cpu(capsys):
    from optispeech_tpu_torch.cli import int8_ab

    res = int8_ab.main(["--batch", "1", "--t", "64", "--device", "cpu"])
    out = capsys.readouterr().out
    for arm in ("xla_bf16", "fused_bf16", "fused_int8", "oracle_f32"):
        assert f"\n{arm} " in out and res[arm]["device_ms"] is None
        assert res[arm]["calls"] == 51 + (arm == "oracle_f32")  # warm-up + 5 x 10, the reference
        assert res[arm]["corr"] > 0.999
    assert "device      n/a ms" in out and "int8 speedup vs fused_bf16 (wall)" in out
    assert res["fused_int8"]["rel_err"] < F32_BLOCK_REL
    assert res["oracle_f32"]["rel_err"] == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,inter", [(256, 1024), (384, 1152)])
@pytest.mark.parametrize("t", [1000, 5])
def test_kernel_matches_twin_on_cuda(cuda, dtype, c, inter, t):
    """On the card the kernel repeats the twin's every rounding: bit-equal
    wherever the card's expf is PyTorch's, and held to the frame criterion."""
    x, p = _block_args(np.random.default_rng(t + c), 2, t, c, inter, dtype)
    x, p = x.to(cuda), [q.to(cuda) for q in p]
    launches = fc.convnext_block_fused_int8.launches
    got = fc.convnext_block_fused_int8(x, *p)
    torch.cuda.synchronize()
    assert fc.convnext_block_fused_int8.launches == launches + 1
    ref = fc.convnext_block_int8_reference(x, *p)
    assert got.dtype == dtype and got.shape == x.shape
    _assert_frames_agree(got.float().cpu().numpy(), ref.float().cpu().numpy(),
                         TOL + (BF16_RTOL if dtype == torch.bfloat16 else 0.0))
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,inter", [(128, 512), (256, 1024), (384, 1152)])
@pytest.mark.parametrize("t", [1, 63, 65, 127, 129])
def test_kernel_bit_equal_to_twin_on_cuda_at_tile_edges(cuda, dtype, c, inter, t):
    """B = 1, T on either side of the 64-frame tile, every width, on a pack
    made once (as the A/B keeps it): bit-equal to the twin."""
    x, p = _block_args(np.random.default_rng(t + c), 1, t, c, inter, dtype)
    x, p = x.to(cuda), [q.to(cuda) for q in p]
    packed = fc.kernel_weights_int8(p[4], p[6])
    launches = fc.convnext_block_fused_int8.launches
    got = fc.convnext_block_fused_int8(x, *p, packed=packed)
    torch.cuda.synchronize()
    assert fc.convnext_block_fused_int8.launches == launches + 1
    ref = fc.convnext_block_int8_reference(x, *p)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, ref)
