"""Fused ConvNeXt block of the port: its plain twin and its GELU against the
JAX Pallas kernel (interpret mode on the CPU), the fused backbones of both
packages, the shape rule that picks the fused or the unfused block, a fused
model at a width outside the flagship's against JAX's, the kernel's weight
pack, the wide path's host plan and image layout, the wrapper's argument
checks, and, where a card exists, the CUDA kernels against their twin.

The JAX side is imported inside the tests that use it, so that on a machine
with a card and without JAX the kernel test still collects:
    python -m pytest --noconftest tests/test_torch_fused_convnext.py -k cuda
"""

import numpy as np
import pytest
import torch
from hypothesis import assume, given, settings
from hypothesis import strategies as st

from optispeech_tpu_torch.ops import fused_convnext as fc
from torch_card import cuda  # noqa: F401  (fixture)

torch.set_num_threads(1)

# bf16 operands with f32 accumulation against f32 (or against each other
# with other summation orders): the JAX package's own tolerance,
# tests/test_pallas_convnext.py:42
ATOL = 3e-3
# bf16 output: one rounding of the result is up to 2**-8 of its magnitude;
# allow two
BF16_RTOL = 2 * 2.0 ** -7


def _block_args(rng, b, t, c, inter, dtype=torch.float32):
    mk = lambda *s, sc=0.1: torch.from_numpy(  # noqa: E731
        (rng.normal(size=s) * sc).astype(np.float32))
    x = mk(b, t, c, sc=0.5).to(dtype)
    params = [mk(7, c), mk(c), 1.0 + mk(c), mk(c), mk(c, inter, sc=0.05), mk(inter, sc=0.02),
              mk(inter, c, sc=0.05), mk(c, sc=0.02), torch.full((c,), 0.25)]
    return x, params


@pytest.mark.parametrize("t_tile", [128, 256])
def test_twin_matches_jax_interpret_kernel(t_tile):
    import jax.numpy as jnp

    from optispeech_tpu.ops.pallas_convnext import convnext_block_fused as jax_block

    x, params = _block_args(np.random.default_rng(1234), 2, 256, 128, 256)
    expect = jax_block(jnp.asarray(x.numpy()), *[jnp.asarray(p.numpy()) for p in params],
                       t_tile=t_tile, interpret=True)
    launches = fc.convnext_block_fused.launches
    got = fc.convnext_block_fused(x, *params)  # CPU tensor: the twin
    assert fc.convnext_block_fused.launches == launches
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=ATOL)


def test_twin_gelu_is_the_jax_kernels():
    """`gelu_erf` against `_block_kernel`'s expression (pallas_convnext.py:74)
    on [-8, 8], within one float32 ulp of |x|: the two differ only where
    exp(-x*x) does (by an ulp between XLA and PyTorch), and where erf nears
    -1 the sum 1 + erf cancels, so the gap there is 0.5 |x| times an ulp of
    1.0, not an ulp of the result."""
    import jax.numpy as jnp

    from optispeech_tpu.ops.pallas_convnext import _erf

    x = np.concatenate([np.linspace(-8.0, 8.0, 400001), [0.0, 1e-30, -1e-30]]).astype(np.float32)
    xj = jnp.asarray(x)
    expect = np.asarray(0.5 * xj * (1.0 + _erf(xj * np.float32(1.0 / np.sqrt(2.0)))))
    got = fc.gelu_erf(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert (np.abs(got - expect) <= np.spacing(np.abs(x))).all()
    np.testing.assert_array_equal(got[x == 0.0], 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,inter", [(256, 1024), (384, 1152)])
def test_twin_matches_jax_interpret_kernel_at_model_widths(c, inter, dtype):
    """The decoder's and the trunk's widths, one 128-frame tile."""
    import jax.numpy as jnp

    from optispeech_tpu.ops.pallas_convnext import convnext_block_fused as jax_block

    x, params = _block_args(np.random.default_rng(c + inter), 1, 128, c, inter, dtype)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    expect = jax_block(xj, *[jnp.asarray(p.numpy()) for p in params], t_tile=128, interpret=True)
    got = fc.convnext_block_fused(x, *params)
    assert got.dtype == dtype and got.shape == x.shape
    expect = np.asarray(expect, np.float32)
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
    np.testing.assert_allclose(got.float().numpy(), expect, atol=ATOL, rtol=rtol)


def _swizzled(e):
    """Element offset -> its place in a 128-byte-swizzled image: the 8-element
    group within each 64-element row XORed with the row's index mod 8."""
    return e ^ (((e >> 6) & 7) << 3)


@pytest.mark.parametrize("c,inter", [(128, 256), (256, 1024), (384, 1152), (96, 200),
                                     (97, 291)])
def test_kernel_weights_invert_to_w1_and_w2(c, inter):
    """Every weight read back from the pack by the layout the kernel's
    descriptors name, element by element, equals its bf16 value; where C or
    I is no multiple of 64, the pack is padded to the next with zeros."""
    rng = np.random.default_rng(c)
    w1 = torch.from_numpy(rng.normal(size=(c, inter)).astype(np.float32))
    w2 = torch.from_numpy(rng.normal(size=(inter, c)).astype(np.float32))
    packed = fc.kernel_weights(w1, w2)
    pc, pi = -(-c // 64) * 64, -(-inter // 64) * 64
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert tuple(packed.shape) == (pi // 64, 2, pc, 64)
    flat = packed.float().numpy().reshape(pi // 64, 2, pc * 64)
    w1p = np.zeros((pc, pi), np.float32)
    w1p[:c, :inter] = w1.bfloat16().float().numpy()
    w2p = np.zeros((pi, pc), np.float32)
    w2p[:inter, :c] = w2.bfloat16().float().numpy()
    k, i = np.meshgrid(np.arange(pc), np.arange(pi), indexing="ij")  # w1[k, i]
    got1 = flat[i // 64, 0, _swizzled(((k // 64) * 64 + i % 64) * 64 + k % 64)]
    np.testing.assert_array_equal(got1, w1p)
    i, cc = np.meshgrid(np.arange(pi), np.arange(pc), indexing="ij")  # w2[i, c]
    got2 = flat[i // 64, 1, _swizzled(cc * 64 + i % 64)]
    np.testing.assert_array_equal(got2, w2p)


def test_fused_params_repack_after_an_in_place_write():
    from optispeech_tpu_torch.models.modules.convnext import ConvNeXtBlock

    torch.manual_seed(0)
    block = ConvNeXtBlock(128, 256, layer_scale_init_value=0.25)
    packed = block.fused_params()[-1]
    assert block.fused_params()[-1] is packed  # kept while nothing changes
    with torch.no_grad():
        block.pwconv1.weight.mul_(2.0)
    repacked = block.fused_params()[-1]
    assert repacked is not packed
    w1 = block.pwconv1.weight.detach().t().bfloat16()
    w2 = block.pwconv2.weight.detach().t().bfloat16()
    assert torch.equal(repacked, fc.kernel_weights(w1, w2))
    assert not torch.equal(repacked, packed)


@pytest.fixture(scope="module")
def decoder_pair():
    from torch_parity import build_pair, small_config

    return build_pair(small_config(dim=128, inter=256, voc_dim=128, voc_inter=256))


@pytest.mark.parametrize("masked", [False, True])
def test_fused_backbone_matches_jax_fused_backbone(decoder_pair, monkeypatch, masked):
    """The port's fused decoder against JAX's, whose blocks run the Pallas
    kernel in interpret mode (the same patch as
    tests/test_pallas_convnext.py::test_backbone_fused_flag_matches_standard_path)."""
    import jax.numpy as jnp

    import optispeech_tpu.ops.pallas_convnext as pc

    orig = pc.convnext_block_fused
    calls = []

    def interp(*args, **kw):
        calls.append(1)
        return orig(*args, interpret=True, **kw)

    monkeypatch.setattr(pc, "convnext_block_fused", interp)
    monkeypatch.setattr(pc, "fused_supported", lambda: True)

    japi, tapi = decoder_pair
    rng = np.random.default_rng(7)
    y = rng.normal(size=(2, 128, 128)).astype(np.float32)
    pad = np.zeros((2, 128), bool)
    if masked:
        pad[:, 100:] = True
    expect = japi.generator.apply(
        {"params": japi.params}, jnp.asarray(y), jnp.asarray(pad),
        method=lambda m, y, p: m.decoder(y, p, fused=True),
    )
    assert len(calls) == 2  # both JAX blocks went through the kernel
    with torch.no_grad():
        got = tapi.generator.decoder(torch.from_numpy(y), torch.from_numpy(pad), fused=True)
        unfused = tapi.generator.decoder(torch.from_numpy(y), torch.from_numpy(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), atol=ATOL)


@pytest.mark.parametrize("c", [32, 96, 160, 192, 256, 384, 500, 512, 576, 1024, 2048, 4096])
@pytest.mark.parametrize("inter", [64, 1000, 1152, 4096])
def test_kernel_takes_by_shape(c, inter):
    """The rule that sends a block to the fused path is JAX's:
    `pick_tile(T, C, I) is not None`, at every T, tiled or not; it reads
    the shape only, so the CPU makes the card's choice."""
    from optispeech_tpu.ops.pallas_convnext import pick_tile

    for t in (1, 63, 64, 65, 128, 256, 1000, 1792, 2048):
        assert fc.kernel_takes(t, c, inter) is (pick_tile(t, c, inter) is not None), (t, c, inter)


@pytest.mark.parametrize("c,inter,t,fused", [(192, 768, 128, True), (96, 1000, 128, True),
                                             (192, 768, 70, False), (1024, 4096, 128, False)])
def test_block_takes_the_kernel_or_the_unfused_path_by_shape(monkeypatch, c, inter, t, fused):
    """`ConvNeXtBlock(fused=True)` calls the kernel's wrapper only where
    JAX's rule tiles (T, C, I) (a T that no tile divides, or a block whose
    smallest tile overflows JAX's VMEM estimate, does not), and otherwise
    returns the unfused block's output."""
    from optispeech_tpu_torch.models.modules import convnext

    torch.manual_seed(c + inter)
    block = convnext.ConvNeXtBlock(c, inter, layer_scale_init_value=0.25).eval()
    calls = []
    wrapper = convnext.convnext_block_fused
    monkeypatch.setattr(convnext, "convnext_block_fused",
                        lambda *a, **kw: calls.append(1) or wrapper(*a, **kw))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, t, c)).astype(np.float32))
    with torch.no_grad():
        got, unfused = block(x, fused=True), block(x)
    assert len(calls) == int(fused)
    if fused:
        np.testing.assert_allclose(got.numpy(), unfused.numpy(), atol=ATOL)
    else:
        assert torch.equal(got, unfused)


def test_fused_model_at_dim_192_matches_jax_fused_model(monkeypatch):
    """A fused model at `generator.dim: 192` (decoder 192/1024, trunk
    384/1152, 2 blocks each) synthesises as JAX's fused model does, whose
    blocks run the Pallas kernel in interpret mode: durations equal, wav
    within 1e-4, and every block of both took the fused path."""
    import dataclasses

    import optispeech_tpu.ops.pallas_convnext as pc
    from torch_parity import full_width_config, params_np, to_torch_config

    from optispeech_tpu.models.optispeech import OptiSpeech as JaxOptiSpeech
    from optispeech_tpu_torch.models.modules import convnext
    from optispeech_tpu_torch.models.optispeech import OptiSpeech, with_fused_blocks

    cfg = full_width_config(layers=2)
    g = cfg.generator
    g = dataclasses.replace(g, dim=192, decoder=dataclasses.replace(g.decoder, fused_pallas=True),
                            vocoder=dataclasses.replace(g.vocoder, fused_pallas=True))
    cfg = dataclasses.replace(cfg, generator=g)
    orig, calls = pc.convnext_block_fused, []

    def interp(*args, **kw):
        calls.append(args[0].shape[-1])
        return orig(*args, interpret=True, **kw)

    monkeypatch.setattr(pc, "convnext_block_fused", interp)
    monkeypatch.setattr(pc, "fused_supported", lambda: True)
    japi = JaxOptiSpeech(cfg, seed=0)
    text = "The birch canoe slid on the smooth planks."
    jout = japi.synthesise(japi.prepare_input(text, d_factor=2.0))
    assert sorted(set(calls)) == [192, 384] and len(calls) == 4  # 2 decoder + 2 trunk blocks
    tcfg = with_fused_blocks(to_torch_config(cfg))
    tapi = OptiSpeech.load_from_jax_params(tcfg, params_np(japi.params), device="cpu")
    port_calls, wrapper = [], convnext.convnext_block_fused
    monkeypatch.setattr(convnext, "convnext_block_fused",
                        lambda x, *a, **kw: port_calls.append(x.shape[-1]) or wrapper(x, *a, **kw))
    launches = fc.convnext_block_fused.launches
    tout = tapi.synthesise(tapi.prepare_input(text, d_factor=2.0))
    assert fc.convnext_block_fused.launches == launches  # CPU tensors: the twin
    assert sorted(port_calls) == sorted(calls)  # the shape rule gave every block the kernel
    np.testing.assert_array_equal(tout.durations, jout.durations)
    np.testing.assert_array_equal(tout.wav_lengths, jout.wav_lengths)
    print(f"wav max|port - jax| {np.abs(tout.wav - jout.wav).max():.3e}, "
          f"max|wav| {np.abs(jout.wav).max():.3e}")
    np.testing.assert_allclose(tout.wav, jout.wav, atol=1e-4)


@pytest.mark.parametrize("case", ["channels", "inter", "dtype", "weight_dtype", "shape",
                                  "contiguous", "empty", "packed_shape", "packed_dtype",
                                  "packed_contiguous"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    c, inter = 256, 1024
    x, p = _block_args(np.random.default_rng(0), 1, 9, c, inter)
    p[4], p[6] = p[4].bfloat16(), p[6].bfloat16()
    fc._check_args(x, *p)  # the valid set passes
    packed = fc.kernel_weights(p[4], p[6])
    fc._check_packed(x, packed, p[5])
    if case.startswith("packed"):  # the launch checks the pack before it touches a card
        if case == "packed_shape":
            packed = packed[:-1]
        elif case == "packed_dtype":
            packed = packed.float()
        else:
            packed = packed.transpose(2, 3).contiguous().transpose(2, 3)
        with pytest.raises(ValueError, match="packed"):
            fc.convnext_block_launch(x, *p[:4], packed, p[5], p[7], p[8])
        return
    if case == "channels":  # C = 576 (the wide path) passes; C = 0 does not
        x, p = _block_args(np.random.default_rng(0), 1, 9, 576, inter)
        p[4], p[6] = p[4].bfloat16(), p[6].bfloat16()
        fc._check_args(x, *p)
        fc._check_packed(x, fc.kernel_weights(p[4], p[6]), p[5])
        x, p = _block_args(np.random.default_rng(0), 1, 9, 0, inter)
        p[4], p[6] = p[4].bfloat16(), p[6].bfloat16()
    elif case == "inter":  # no intermediate channels
        x, p = _block_args(np.random.default_rng(0), 1, 9, c, 0)
        p[4], p[6] = p[4].bfloat16(), p[6].bfloat16()
    elif case == "dtype":
        x = x.double()
    elif case == "weight_dtype":
        p[4] = p[4].float()
    elif case == "shape":
        p[0] = p[0][:5]
    elif case == "contiguous":
        p[6] = p[6].t().contiguous().t()
    elif case == "empty":
        x = x[:, :0]
    with pytest.raises(ValueError):
        fc._check_args(x, *p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,inter", [(256, 1024), (384, 1152)])
@pytest.mark.parametrize("t", [1000, 5])
def test_kernel_matches_twin_on_cuda(cuda, dtype, c, inter, t):
    x, p = _block_args(np.random.default_rng(t + c), 2, t, c, inter, dtype)
    x = x.to(cuda)
    p = [q.to(cuda) for q in p]
    p[4], p[6] = p[4].bfloat16(), p[6].bfloat16()
    launches = fc.convnext_block_fused.launches
    got = fc.convnext_block_fused(x, *p)
    torch.cuda.synchronize()
    assert fc.convnext_block_fused.launches == launches + 1
    ref = fc.convnext_block_reference(x, *p)
    assert got.dtype == dtype and got.shape == x.shape
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got.float(), ref.float(), atol=ATOL, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,inter,b,t", [
    (384, 1152, 1, 1), (384, 1152, 1, 63), (384, 1152, 1, 65), (256, 1024, 2, 127),
    (256, 1024, 2, 129), (128, 512, 1, 200), (128, 512, 3, 65),
    (384, 1152, 48, 1792),  # 1344 tiles: ten per SM
])
def test_kernel_matches_twin_on_cuda_at_tile_edges(cuda, dtype, c, inter, b, t):
    """T one frame either side of the 64-frame tile, B = 1, C = 128, and a
    grid that outnumbers the SMs many times over; the pack made once, as the
    model keeps it."""
    x, p = _block_args(np.random.default_rng(b * t + c), b, t, c, inter, dtype)
    x = x.to(cuda)
    p = [q.to(cuda) for q in p]
    p[4], p[6] = p[4].bfloat16(), p[6].bfloat16()
    packed = fc.kernel_weights(p[4], p[6])
    launches = fc.convnext_block_fused.launches
    got = fc.convnext_block_fused(x, *p, packed=packed)
    torch.cuda.synchronize()
    assert fc.convnext_block_fused.launches == launches + 1
    ref = fc.convnext_block_reference(x, *p)
    assert got.dtype == dtype and got.shape == x.shape
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got.float(), ref.float(), atol=ATOL, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,inter", [(192, 1024), (512, 2048), (96, 384), (97, 291),
                                     (500, 1000), (512, 3072)])
@pytest.mark.parametrize("t", [1, 65, 1000])
def test_kernel_matches_twin_on_cuda_at_new_widths(cuda, dtype, c, inter, t):
    """C = 192 (a width whose LayerNorm masks lanes), C = 512 (the widest,
    two weight slots; with I = 3072 the longest second product the rule
    fuses at that width), and C = 96, 97 and 500, which the kernel pads to
    a multiple of 64 (97 with an odd I: rows that are not 16-byte aligned),
    within chip_smoke.py phase 3's tolerance."""
    x, p = _block_args(np.random.default_rng(t + c), 2, t, c, inter, dtype)
    x = x.to(cuda)
    p = [q.to(cuda) for q in p]
    p[4], p[6] = p[4].bfloat16(), p[6].bfloat16()
    launches = fc.convnext_block_fused.launches
    got = fc.convnext_block_fused(x, *p)
    torch.cuda.synchronize()
    assert fc.convnext_block_fused.launches == launches + 1
    ref = fc.convnext_block_reference(x, *p)
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got.float(), ref.float(), atol=ATOL, rtol=rtol)


# the largest C that JAX's rule tiles at T = 64 with I = 64: the wide path's
# small-I extreme (chip_smoke.py phase 3)
WIDEST_AT_I64 = max(c for c in range(12000, 12400) if fc.kernel_takes(64, c, 64))


def test_widest_block_at_i64_is_the_wide_paths_extreme():
    assert WIDEST_AT_I64 == 12272 and not fc.kernel_takes(64, WIDEST_AT_I64 + 1, 64)
    assert WIDEST_AT_I64 <= fc.WIDE_MAX_CHANNELS


@pytest.fixture(scope="module")
def hypothesis_home(tmp_path_factory):
    """Hypothesis's own files (its cache of the constants it reads from the
    source) in a temporary directory, not in the checkout."""
    from hypothesis import configuration

    configuration.set_hypothesis_home_dir(tmp_path_factory.mktemp("hypothesis"))
    yield
    configuration.set_hypothesis_home_dir(None)


@settings(max_examples=300, deadline=None, database=None)
@given(data=st.data())
def test_wrapper_takes_every_shape_the_rule_accepts(hypothesis_home, data):
    """Wherever `kernel_takes(T, C, I)` holds, the wrapper's argument check
    passes (on meta tensors: shapes, types and layout only), so a fused
    model never meets a block the card refuses."""
    tile = data.draw(st.sampled_from(fc.JAX_TILES))
    t = tile * data.draw(st.integers(1, 4))
    c = data.draw(st.integers(1, 16384))
    inter = data.draw(st.integers(1, max(1, fc.JAX_VMEM_BYTES // (4 * c))))
    assume(fc.kernel_takes(t, c, inter))
    meta = dict(device="meta")
    x = torch.empty(1, t, c, **meta)
    params = [torch.empty(7, c, **meta), torch.empty(c, **meta), torch.empty(c, **meta),
              torch.empty(c, **meta), torch.empty(c, inter, dtype=torch.bfloat16, **meta),
              torch.empty(inter, **meta), torch.empty(inter, c, dtype=torch.bfloat16, **meta),
              torch.empty(c, **meta), torch.empty(c, **meta)]
    assert fc._check_args(x, *params) == (1, t, c, inter)


def _units(plan, tiles, k_blocks, k_splits, k_per_split):
    """(row block, column tile, first and end K block) of each work unit, in
    unit order, as csrc/convnext_block_wide.cu's `tile_of` decodes it: the
    split fastest, then the column tile, then the row block."""
    rows, cols = tiles
    for unit in range(rows * cols * k_splits):
        split, mn = unit % k_splits, unit // k_splits
        k0 = split * k_per_split
        yield mn // cols, mn % cols, k0, min(k_blocks, k0 + k_per_split)


@settings(max_examples=200, deadline=None, database=None)
@given(data=st.data())
def test_wide_plan_covers_every_tile_and_k_block_once(hypothesis_home, data):
    """Wherever `kernel_takes(T, C, I)` holds, for B items and any SM count:
    the wide path's two products cover every (row tile, 64-column chunk, K
    block) of their outputs exactly once across their work units, no split
    of product 1 is empty, the tiles hold every row tile and column, and
    each scratch holds its image (h and u: a row tile of C' or I' columns
    each; the partial sums: one float32 plane per split)."""
    tile = data.draw(st.sampled_from(fc.JAX_TILES))
    t = tile * data.draw(st.integers(1, 2)) - data.draw(st.integers(0, 63))
    c = data.draw(st.integers(1, 16384))
    inter = data.draw(st.integers(1, max(1, fc.JAX_VMEM_BYTES // (4 * c))))
    assume(fc.kernel_takes(tile * (-(-t // tile)), c, inter))
    b = data.draw(st.integers(1, 3))
    sms = data.draw(st.sampled_from([fc.H100_SMS, 114, 16]))
    plan = fc.wide_plan(b, t, c, inter, sms)
    cp, ip = fc.padded_width(c), fc.padded_width(inter)
    row_tiles = b * -(-t // 64)
    assert plan["row_tiles"] == row_tiles
    assert plan["k_blocks1"] * 64 == cp and plan["k_blocks2"] * 64 == ip
    splits, per = plan["k_splits"], plan["k_per_split"]
    assert (splits - 1) * per < plan["k_blocks1"] <= splits * per
    for tiles, k_blocks, n_cols, s, kps in ((plan["tiles1"], plan["k_blocks1"], ip, splits, per),
                                            (plan["tiles2"], plan["k_blocks2"], cp, 1,
                                             plan["k_blocks2"])):
        assert 2 * tiles[0] >= row_tiles > 2 * (tiles[0] - 1)
        assert tiles[1] * fc.WIDE_TILE_COLS >= n_cols > (tiles[1] - 1) * fc.WIDE_TILE_COLS
        seen = np.zeros((tiles[0], tiles[1], k_blocks), np.int64)
        for m, n, k0, k1 in _units(plan, tiles, k_blocks, s, kps):
            assert k1 > k0
            seen[m, n, k0:k1] += 1
        assert (seen == 1).all()
    assert plan["h_elems"] == row_tiles * 64 * cp and plan["u_elems"] == row_tiles * 64 * ip
    assert plan["partial_elems"] == (splits * row_tiles * 64 * ip if splits > 1 else 0)
    if 2 * plan["tiles1"][0] * plan["tiles1"][1] > sms:
        assert splits == 1


@pytest.mark.parametrize("rows,cols", [(64, 64), (192, 128), (128, 1088)])
def test_image_layout_inverts_and_is_the_kernels(rows, cols):
    """`to_image` lays a (rows, cols) matrix out as the wide path's kernels
    keep h and u, element by element (tile (r, k) at (r * K + k) * 4096, the
    16-byte group g of row i at g ^ (i % 8)); `from_image` reads it back."""
    rng = np.random.default_rng(rows + cols)
    a = torch.from_numpy(rng.normal(size=(rows, cols)).astype(np.float32)).bfloat16()
    image = fc.to_image(a)
    assert image.shape == (rows * cols,) and image.dtype == torch.bfloat16
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    index = ((r // 64) * (cols // 64) + c // 64) * 4096 + _swizzled((r % 64) * 64 + c % 64)
    np.testing.assert_array_equal(image.float().numpy()[index], a.float().numpy())
    assert torch.equal(fc.from_image(image, rows, cols), a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_twin_matches_jax_interpret_kernel_above_512_channels(dtype):
    """C = 576 / I = 1152, one 64-frame tile: a width only the wide path
    takes, against JAX's Pallas block in interpret mode."""
    import jax.numpy as jnp

    from optispeech_tpu.ops.pallas_convnext import convnext_block_fused as jax_block

    x, params = _block_args(np.random.default_rng(576), 1, 64, 576, 1152, dtype)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    expect = jax_block(xj, *[jnp.asarray(p.numpy()) for p in params], t_tile=64, interpret=True)
    launches = fc.convnext_block_fused.launches
    got = fc.convnext_block_fused(x, *params)  # CPU tensor: the twin
    assert fc.convnext_block_fused.launches == launches
    assert got.dtype == dtype and got.shape == x.shape
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
    np.testing.assert_allclose(got.float().numpy(), np.asarray(expect, np.float32), atol=ATOL,
                               rtol=rtol)


def test_fused_model_at_dim_576_matches_jax_fused_model(monkeypatch):
    """The slice-1 model at `generator.dim: 576` (2 blocks, narrow I: the
    decoder at 576/128), fused, synthesises as JAX's fused model does, whose
    blocks run the Pallas kernel in interpret mode: durations equal, wav
    within 1e-4, and every fused block of both took the kernel, the 576-wide
    ones included."""
    import dataclasses

    import optispeech_tpu.ops.pallas_convnext as pc
    from torch_parity import params_np, small_config, to_torch_config

    from optispeech_tpu.models.optispeech import OptiSpeech as JaxOptiSpeech
    from optispeech_tpu_torch.models.modules import convnext
    from optispeech_tpu_torch.models.optispeech import OptiSpeech, with_fused_blocks

    cfg = small_config(dim=576, inter=128, voc_dim=64, voc_inter=128, layers=2)
    g = cfg.generator
    g = dataclasses.replace(g, decoder=dataclasses.replace(g.decoder, fused_pallas=True),
                            vocoder=dataclasses.replace(g.vocoder, fused_pallas=True))
    cfg = dataclasses.replace(cfg, generator=g)
    orig, calls = pc.convnext_block_fused, []

    def interp(*args, **kw):
        calls.append(args[0].shape[-1])
        return orig(*args, interpret=True, **kw)

    monkeypatch.setattr(pc, "convnext_block_fused", interp)
    monkeypatch.setattr(pc, "fused_supported", lambda: True)
    japi = JaxOptiSpeech(cfg, seed=0)
    text = "The birch canoe slid on the smooth planks."
    jout = japi.synthesise(japi.prepare_input(text, d_factor=2.0))
    assert sorted(set(calls)) == [64, 576] and len(calls) == 4  # 2 decoder + 2 trunk blocks
    tcfg = with_fused_blocks(to_torch_config(cfg))
    tapi = OptiSpeech.load_from_jax_params(tcfg, params_np(japi.params), device="cpu")
    port_calls, wrapper = [], convnext.convnext_block_fused
    monkeypatch.setattr(convnext, "convnext_block_fused",
                        lambda x, *a, **kw: port_calls.append(x.shape[-1]) or wrapper(x, *a, **kw))
    tout = tapi.synthesise(tapi.prepare_input(text, d_factor=2.0))
    assert sorted(port_calls) == sorted(calls)
    np.testing.assert_array_equal(tout.durations, jout.durations)
    np.testing.assert_array_equal(tout.wav_lengths, jout.wav_lengths)
    np.testing.assert_allclose(tout.wav, jout.wav, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,inter,b,t", [
    (576, 1152, 2, 1000), (576, 1152, 1, 1), (576, 1152, 3, 65), (768, 3072, 2, 1792),
    (768, 3072, 1, 63), (1000, 200, 2, 128), (WIDEST_AT_I64, 64, 2, 64), (4096, 64, 1, 65),
    (1088, 4160, 1, 129), (577, 1000, 2, 100),
])
def test_kernel_matches_twin_on_cuda_above_512_channels(cuda, dtype, c, inter, b, t):
    """The wide path (csrc/convnext_block_wide.cu) at chip_smoke.py phase 3's
    widths (C = 576 / I = 1152, 768 / 3072 and the small-I extreme), a C
    that is no multiple of 64 or 128 and T either side of a tile, within
    phase 3's tolerance of the twin. (4096, 64, 1, 65) and (1088, 4160, 1,
    129) split product 1's depth (`wide_plan`); the latter's last column
    tile is ragged in both products (I' = 4160 and C' = 1088 are no
    multiples of 128) over an odd count of row tiles; C = 577 has rows that
    are not pair-aligned."""
    x, p = _block_args(np.random.default_rng(t + c), b, t, c, inter, dtype)
    x = x.to(cuda)
    p = [q.to(cuda) for q in p]
    p[4], p[6] = p[4].bfloat16(), p[6].bfloat16()
    launches = fc.convnext_block_fused.launches
    got = fc.convnext_block_fused(x, *p)
    torch.cuda.synchronize()
    assert fc.convnext_block_fused.launches == launches + 1
    ref = fc.convnext_block_reference(x, *p)
    assert got.dtype == dtype and got.shape == x.shape
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got.float(), ref.float(), atol=ATOL, rtol=rtol)


@pytest.mark.parametrize("c,t", [(576, 65), (1000, 128), (WIDEST_AT_I64, 64)])
def test_wide_layernorm_h_equals_the_twins_on_cuda(cuda, c, t):
    """The wide path's first kernel writes bf16 h, read back from its
    swizzled scratch image, equal element for element to the twin's
    (`_dwconv_layernorm`, sums by halves), and zeros past C and past T."""
    x, p = _block_args(np.random.default_rng(c), 2, t, c, 64)
    x = x.to(cuda)
    p = [q.to(cuda) for q in p]
    p[4], p[6] = p[4].bfloat16(), p[6].bfloat16()
    b, cp, tiles = 2, fc.padded_width(c), -(-t // 64)
    plan = fc.wide_plan(b, t, c, 64, torch.cuda.get_device_properties(cuda).multi_processor_count)
    h_img = torch.full((plan["h_elems"],), float("nan"), dtype=torch.bfloat16, device=cuda)
    u_img = torch.empty(plan["u_elems"], dtype=torch.bfloat16, device=cuda)
    partials = torch.empty(max(1, plan["partial_elems"]), device=cuda)
    out = torch.empty_like(x)
    packed = fc.kernel_weights(p[4], p[6])
    dw, dwb, lnw, lnb, _, b1, _, b2, gamma = p
    err = fc._library("convnext_block_wide").convnext_block_wide_launch(
        *(q.data_ptr() for q in (x, out, dw, dwb, lnw, lnb, packed, b1, b2, gamma, h_img, u_img,
                                 partials)),
        b, t, c, 64, plan["k_splits"], plan["k_per_split"], 0, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    h = fc.from_image(h_img, b * tiles * 64, cp).view(b, tiles * 64, cp)
    assert torch.equal(h[:, :t, :c], fc._dwconv_layernorm(x, *p[:4]).bfloat16())
    assert not h[:, :t, c:].any() and not h[:, t:].any()
