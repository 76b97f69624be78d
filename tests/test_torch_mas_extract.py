"""The port's duration extraction (ops/mas.py::viterbi_decode_extract, the
kernel that replaces `optispeech_tpu/ops/pallas_mas.py::viterbi_decode_pallas`):
its plain twin against the Pallas kernel in interpret mode and the JAX scan,
against the wavefront twin, and where a card exists the CUDA kernel against
its twin.

Tolerances are the JAX package's (tests/test_pallas_mas.py:29-30): durations
exactly equal, bin loss rtol 1e-5.

The JAX side is imported inside the tests that use it, so that on a machine
with a card and without JAX the kernel tests still collect:
    python -m pytest --noconftest tests/test_torch_mas_extract.py -k cuda
"""

import numpy as np
import pytest
import torch

from optispeech_tpu_torch.ops import mas
from torch_card import cuda  # noqa: F401  (fixture)

torch.set_num_threads(1)

BIN_RTOL = 1e-5

# (b, t_feats, t_text, text_lengths, feats_lengths): the shapes of
# tests/test_pallas_mas.py:12-30 and :74-90 (43 frames: not a multiple of
# 8), then a one-token item beside an item with fl == T_feats and a
# single-frame item, and items with fewer frames than tokens
CASES = {
    "pallas": (3, 40, 10, [10, 6, 8], [40, 22, 31]),
    "frames43": (2, 43, 12, [12, 7], [43, 29]),
    "one_token": (3, 20, 9, [1, 9, 4], [3, 20, 1]),
    "short": (3, 20, 70, [70, 40, 5], [10, 1, 3]),
    # tl = 1, fl = 1, tl = T and T_text no multiple of 32
    "edges": (4, 37, 45, [1, 45, 45, 17], [1, 37, 1, 30]),
}


def _inputs(case, seed=7):
    b, t_feats, t_text, tl, fl = CASES[case]
    rng = np.random.default_rng(seed)
    lp = np.log(rng.dirichlet(np.ones(t_text), size=(b, t_feats)) + 1e-8).astype(np.float32)
    return lp, np.asarray(tl, np.int32), np.asarray(fl, np.int32)


def _port(fn, lp, tl, fl):
    ds, bl = fn(torch.from_numpy(lp), torch.from_numpy(tl), torch.from_numpy(fl))
    return ds.numpy(), float(bl)


def _jax(fn, lp, tl, fl, **kw):
    import jax.numpy as jnp

    ds, bl = fn(jnp.asarray(lp), jnp.asarray(tl), jnp.asarray(fl), **kw)
    return np.asarray(ds), float(bl)


def _assert_same(got, expect):
    np.testing.assert_array_equal(got[0], expect[0])
    np.testing.assert_allclose(got[1], expect[1], rtol=BIN_RTOL)


@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_jax_pallas_kernel(case):
    from optispeech_tpu.ops.pallas_mas import viterbi_decode_pallas

    lp, tl, fl = _inputs(case)
    _assert_same(_port(mas.viterbi_decode_extract_reference, lp, tl, fl),
                 _jax(viterbi_decode_pallas, lp, tl, fl, interpret=True))


@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_jax_scan(case):
    from optispeech_tpu.ops.mas import viterbi_decode as jax_scan

    lp, tl, fl = _inputs(case)
    _assert_same(_port(mas.viterbi_decode_extract_reference, lp, tl, fl),
                 _jax(jax_scan, lp, tl, fl))


@pytest.mark.parametrize("case", list(CASES))
def test_twin_durations_equal_the_wavefront_twin(case):
    lp, tl, fl = _inputs(case, seed=11)
    got = _port(mas.viterbi_decode_extract_reference, lp, tl, fl)
    expect = _port(mas.viterbi_decode_reference, lp, tl, fl)
    np.testing.assert_array_equal(got[0], expect[0])
    np.testing.assert_allclose(got[1], expect[1], rtol=BIN_RTOL)


def test_binsum_adds_each_token_from_its_last_frame_down():
    """binsum[i] is the float32 sum of token i's log-probs over its valid
    frames, added from the highest frame down (the TPU kernel's order)."""
    lp, tl, fl = _inputs("frames43")
    ds, binsum = mas.extract_reference(*(torch.from_numpy(a) for a in (lp, tl, fl)))
    for b in range(lp.shape[0]):
        ends = np.cumsum(ds[b].numpy()).astype(int)
        for i in range(int(tl[b])):
            acc = np.float32(0.0)
            for j in range(ends[i] - 1, ends[i] - int(ds[b, i]) - 1, -1):
                acc = np.float32(acc + lp[b, j, i])
            assert binsum[b, i].item() == acc, (b, i)
        assert not binsum[b, int(tl[b]):].any()
    assert ds.sum(dim=1).tolist() == fl.tolist()


def test_extraction_has_no_gradient():
    lp, tl, fl = _inputs("pallas")
    x = torch.from_numpy(lp).requires_grad_(True)
    ds, bl = mas.viterbi_decode_extract(x, torch.from_numpy(tl), torch.from_numpy(fl))
    assert not ds.requires_grad and not bl.requires_grad


def test_wrapper_runs_the_twin_on_the_cpu():
    lp, tl, fl = _inputs("frames43")
    launches = mas.viterbi_decode_extract.launches
    got = _port(mas.viterbi_decode_extract, lp, tl, fl)
    assert mas.viterbi_decode_extract.launches == launches
    _assert_same(got, _port(mas.viterbi_decode_extract_reference, lp, tl, fl))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    lp = torch.zeros(2, 5, 3)
    with pytest.raises(ValueError, match="feats_lengths"):
        mas.mas_extract(lp, torch.ones(2, dtype=torch.int32), torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="T_text <= 2048"):
        mas.mas_extract(torch.zeros(1, 2, 2049), torch.ones(1), torch.ones(1))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        mas.viterbi_decode_extract(lp.to("meta"), torch.ones(2).to("meta"),
                                   torch.ones(2).to("meta"))


def _card_inputs(shape, device):
    b, t_feats, t_text = shape
    rng = np.random.default_rng(sum(shape))
    lp = np.log(rng.dirichlet(np.ones(t_text), size=(b, t_feats)) + 1e-8).astype(np.float32)
    tl = rng.integers(max(1, t_text // 2), t_text + 1, b)
    fl = rng.integers(max(1, t_feats // 2), t_feats + 1, b)
    tl[0], fl[0] = 1, 3  # one token
    fl[-1] = t_feats  # every frame valid
    return (torch.from_numpy(np.asarray(a)).to(device) for a in (lp, tl, fl))


@pytest.mark.parametrize("shape", [(128, 768, 192), (2, 43, 12), (3, 40, 10), (3, 20, 300),
                                   (2, 50, 2000)])
def test_kernel_matches_twin_on_cuda(cuda, shape):
    lp, tl, fl = _card_inputs(shape, cuda)
    launches = mas.viterbi_decode_extract.launches
    ds, binsum = mas.mas_extract(lp, tl, fl)
    bl = mas.viterbi_decode_extract(lp, tl, fl)[1]
    torch.cuda.synchronize()
    assert mas.viterbi_decode_extract.launches == launches + 2
    ds_ref, binsum_ref = mas.extract_reference(lp, tl, fl)
    assert torch.equal(ds, ds_ref)
    torch.testing.assert_close(binsum, binsum_ref, rtol=BIN_RTOL, atol=0)
    torch.testing.assert_close(bl, mas.bin_loss_from_binsum(binsum_ref, fl, shape[1]),
                               rtol=BIN_RTOL, atol=0)


def test_kernel_durations_equal_the_wavefront_kernel_on_cuda(cuda):
    lp, tl, fl = _card_inputs((128, 768, 192), cuda)
    ds = mas.viterbi_decode_extract(lp, tl, fl)[0]
    assert torch.equal(ds, mas.mas_durations(lp, tl, fl))


@pytest.mark.parametrize("b", [1, 128, 133])
@pytest.mark.parametrize("t_text", [1, 31, 33, 192, 384])
def test_kernel_matches_twin_on_cuda_by_text_width(cuda, b, t_text):
    """B4 exactly equal to its twin, binsum bit for bit, and its durations
    equal to B3's, at every tokens-per-lane shape the training path meets."""
    from test_torch_mas import _card_case

    lp, tl, fl = _card_case(b, 300, t_text, cuda, seed=b * t_text)
    ds, binsum = mas.mas_extract(lp, tl, fl)
    wavefront = mas.mas_durations(lp, tl, fl)
    torch.cuda.synchronize()
    ds_ref, binsum_ref = mas.extract_reference(lp, tl, fl)
    assert torch.equal(ds, ds_ref)
    assert torch.equal(binsum, binsum_ref)
    assert torch.equal(ds, wavefront)


@pytest.mark.parametrize("shape", [(2, 37, 45), (1, 50, 33), (3, 20, 1), (2, 64, 10)])
def test_kernels_read_the_tensors_last_rows_on_cuda(cuda, shape):
    """The last item with every frame and token valid and T no multiple of
    4: the stage that holds lp's last row, whose window rounded to 16 bytes
    would pass the tensor's end, is read from device memory, and both
    kernels still equal their twins."""
    b, t_feats, t_text = shape
    rng = np.random.default_rng(sum(shape))
    lp = np.log(rng.dirichlet(np.ones(t_text), size=(b, t_feats)) + 1e-8).astype(np.float32)
    tl = rng.integers(1, t_text + 1, b)
    fl = rng.integers(1, t_feats + 1, b)
    tl[-1], fl[-1] = t_text, t_feats
    lp, tl, fl = (torch.from_numpy(np.asarray(a)).to(cuda) for a in (lp, tl, fl))
    ds, binsum = mas.mas_extract(lp, tl, fl)
    wavefront = mas.mas_durations(lp, tl, fl)
    torch.cuda.synchronize()
    ds_ref, binsum_ref = mas.extract_reference(lp, tl, fl)
    assert torch.equal(ds, ds_ref) and torch.equal(wavefront, ds_ref)
    assert torch.equal(binsum, binsum_ref)
