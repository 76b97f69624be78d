"""Fused ConvNeXt block of the port: its plain twin against the JAX Pallas
kernel (interpret mode on the CPU), the fused backbones of both packages,
the wrapper's argument checks, and, where a card exists, the CUDA kernel
against its twin.

The JAX side is imported inside the tests that use it, so that on a machine
with a card and without JAX the kernel test still collects:
    python -m pytest --noconftest tests/test_torch_fused_convnext.py -k cuda
"""

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("case", ["channels", "inter", "dtype", "weight_dtype", "shape",
                                  "contiguous", "empty"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    c, inter = 256, 1024
    x, p = _block_args(np.random.default_rng(0), 1, 9, c, inter)
    p[4], p[6] = p[4].bfloat16(), p[6].bfloat16()
    fc._check_args(x, *p)  # the valid set passes
    if case == "channels":
        x, p = _block_args(np.random.default_rng(0), 1, 9, 192, inter)
        p[4], p[6] = p[4].bfloat16(), p[6].bfloat16()
    elif case == "inter":
        x, p = _block_args(np.random.default_rng(0), 1, 9, c, 1000)
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
