"""MAS of the port (ops/mas.py): its plain twin against the JAX scan
(`optispeech_tpu/ops/mas.py::viterbi_decode`) and the Pallas wavefront
kernel in interpret mode, the kernel path's bin loss on the CPU, and, where a
card exists, the CUDA kernel against its twin.

Tolerances are the JAX package's own (tests/test_pallas_mas.py:49-54):
durations exactly equal, bin loss rtol 1e-5, its gradient atol 1e-6.

The JAX side is imported inside the tests that use it, so that on a machine
with a card and without JAX the kernel test still collects:
    python -m pytest --noconftest tests/test_torch_mas.py -k cuda
"""

import numpy as np
import pytest
import torch

from optispeech_tpu_torch.ops import mas
from torch_card import cuda  # noqa: F401  (fixture)

torch.set_num_threads(1)

# (b, t_feats, t_text, text_lengths, feats_lengths): the shapes of
# tests/test_pallas_mas.py:38-71 (with tl=1), then items shorter in frames
# than in tokens and a single-frame item
CASES = {
    "tl1": (4, 40, 24, [24, 7, 13, 1], [40, 17, 25, 3]),
    "odd": (2, 43, 23, [23, 9], [43, 29]),
    "short": (3, 20, 70, [70, 40, 5], [10, 1, 3]),
    # tl = 1, fl = 1, tl = T and T_text no multiple of 32 (a lane's tokens
    # cross no 32-token chunk: K = 2 tokens a lane at T = 45)
    "edges": (4, 37, 45, [1, 45, 45, 17], [1, 37, 1, 30]),
}


def _inputs(case, seed=1234):
    b, t_feats, t_text, tl, fl = CASES[case]
    rng = np.random.default_rng(seed)
    lp = np.log(rng.dirichlet(np.ones(t_text), size=(b, t_feats)) + 1e-8).astype(np.float32)
    return lp, np.asarray(tl, np.int32), np.asarray(fl, np.int32)


def _jax(fn, lp, tl, fl, **kw):
    import jax
    import jax.numpy as jnp

    args = (jnp.asarray(tl), jnp.asarray(fl))
    ds, bl = fn(jnp.asarray(lp), *args, **kw)
    grad = jax.grad(lambda x: fn(x, *args, **kw)[1])(jnp.asarray(lp))
    return np.asarray(ds), float(bl), np.asarray(grad)


def _port(fn, lp, tl, fl):
    x = torch.from_numpy(lp).requires_grad_(True)
    ds, bl = fn(x, torch.from_numpy(tl), torch.from_numpy(fl))
    (grad,) = torch.autograd.grad(bl, x)
    return ds.numpy(), float(bl.detach()), grad.numpy()


def _assert_same(got, expect):
    np.testing.assert_array_equal(got[0], expect[0])
    np.testing.assert_allclose(got[1], expect[1], rtol=1e-5)
    np.testing.assert_allclose(got[2], expect[2], atol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_jax_scan(case):
    from optispeech_tpu.ops.mas import viterbi_decode as jax_scan

    lp, tl, fl = _inputs(case)
    _assert_same(_port(mas.viterbi_decode_reference, lp, tl, fl), _jax(jax_scan, lp, tl, fl))


@pytest.mark.parametrize("case", ["tl1", "odd", "edges"])
def test_twin_matches_jax_wavefront_kernel(case):
    from optispeech_tpu.ops.pallas_mas_wavefront import viterbi_decode_wavefront

    lp, tl, fl = _inputs(case)
    expect = _jax(viterbi_decode_wavefront, lp, tl, fl, interpret=True)
    _assert_same(_port(mas.viterbi_decode_reference, lp, tl, fl), expect)


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_path_bin_loss_matches_jax(case):
    """The CUDA path takes its bin loss from the kernel's durations
    (cumsum + searchsorted + gather); here it runs on the twin's durations."""
    from optispeech_tpu.ops.mas import viterbi_decode as jax_scan

    lp, tl, fl = _inputs(case)
    ds = mas.viterbi_decode_reference(torch.from_numpy(lp), torch.from_numpy(tl),
                                      torch.from_numpy(fl))[0]

    def from_durations(x, tl, fl):
        return ds, mas.bin_loss_from_durations(x, ds, tl, fl)

    _assert_same(_port(from_durations, lp, tl, fl), _jax(jax_scan, lp, tl, fl))


def test_wrapper_runs_the_twin_on_the_cpu():
    lp, tl, fl = _inputs("odd")
    launches = mas.viterbi_decode.launches
    got = _port(mas.viterbi_decode, lp, tl, fl)
    assert mas.viterbi_decode.launches == launches
    _assert_same(got, _port(mas.viterbi_decode_reference, lp, tl, fl))


@pytest.mark.parametrize("t_text,per_lane", [(1, 1), (32, 1), (33, 2), (192, 6), (2048, 64),
                                             (384, 12), (500, 16), (513, 20), (1500, 48)])
def test_tokens_per_lane(t_text, per_lane):
    """Contiguous tokens a lane holds: ceil(T / 32), or the next
    instantiated width above 16."""
    assert mas.tokens_per_lane(t_text) == per_lane


@pytest.mark.parametrize("b,t_feats,per_lane,expect", [
    (1, 768, 6, 154 * 32 * 4),  # 5 frames to a 32-bit word
    (128, 768, 1, 128 * 24 * 32 * 4),  # 32 frames to a word
    (2, 43, 12, 2 * 22 * 32 * 4),  # 2 frames to a word, the last row half full
    (3, 10, 48, 3 * 10 * 32 * 8),  # one frame to a 64-bit word
])
def test_decision_bytes(b, t_feats, per_lane, expect):
    assert mas.decision_bytes(b, t_feats, per_lane) == expect


def test_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="T_text <= 2048"):
        mas.tokens_per_lane(2049)
    lp = torch.zeros(2, 5, 3)
    with pytest.raises(ValueError, match="text_lengths"):
        mas.mas_durations(lp, torch.ones(3, dtype=torch.int32), torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="non-empty"):
        mas.mas_durations(lp[:, :0], torch.ones(2), torch.ones(2))


@pytest.mark.parametrize("shape", [(128, 768, 192), (2, 43, 23), (4, 40, 24), (3, 20, 300),
                                   (2, 50, 2000)])
def test_kernel_matches_twin_on_cuda(cuda, shape):
    b, t_feats, t_text = shape
    rng = np.random.default_rng(sum(shape))
    lp = np.log(rng.dirichlet(np.ones(t_text), size=(b, t_feats)) + 1e-8).astype(np.float32)
    tl = rng.integers(max(1, t_text // 2), t_text + 1, b)
    fl = rng.integers(max(1, t_feats // 2), t_feats + 1, b)
    tl[0], fl[0] = 1, 3  # one token
    fl[-1] = min(fl[-1], max(1, tl[-1] // 2))  # fewer frames than tokens
    lp, tl, fl = (torch.from_numpy(a).to(cuda) for a in (lp, tl, fl))
    launches = mas.viterbi_decode.launches
    x = lp.clone().requires_grad_(True)
    ds, bl = mas.viterbi_decode(x, tl, fl)
    (grad,) = torch.autograd.grad(bl, x)
    torch.cuda.synchronize()
    assert mas.viterbi_decode.launches == launches + 1
    y = lp.clone().requires_grad_(True)
    ds_ref, bl_ref = mas.viterbi_decode_reference(y, tl, fl)
    (grad_ref,) = torch.autograd.grad(bl_ref, y)
    assert torch.equal(ds, ds_ref)
    torch.testing.assert_close(bl, bl_ref, rtol=1e-5, atol=0)
    torch.testing.assert_close(grad, grad_ref, atol=1e-6, rtol=0)


def _card_case(b, t_feats, t_text, device, seed):
    rng = np.random.default_rng(seed)
    lp = np.log(rng.dirichlet(np.ones(t_text), size=(b, t_feats)) + 1e-8).astype(np.float32)
    tl = rng.integers(max(1, t_text // 2), t_text + 1, b)
    fl = rng.integers(max(1, t_feats // 2), t_feats + 1, b)
    tl[0] = t_text  # tl = T
    fl[-1] = 1  # one frame
    if b > 2:
        tl[1], fl[1] = 1, t_feats  # one token, every frame
    return [torch.from_numpy(np.asarray(a)).to(device) for a in (lp, tl, fl)]


@pytest.mark.parametrize("b", [1, 128, 133])
@pytest.mark.parametrize("t_text", [1, 31, 33, 192, 384])
def test_kernel_matches_twin_on_cuda_by_text_width(cuda, b, t_text):
    """B3 exactly equal to its twin at every tokens-per-lane shape the
    training path meets (1, 2, 6, 12 tokens a lane), B above the SMs."""
    lp, tl, fl = _card_case(b, 300, t_text, cuda, seed=b + t_text)
    launches = mas.viterbi_decode.launches
    ds = mas.mas_durations(lp, tl, fl)
    torch.cuda.synchronize()
    assert mas.viterbi_decode.launches == launches + 1
    assert torch.equal(ds, mas.viterbi_decode_reference(lp, tl, fl)[0])
