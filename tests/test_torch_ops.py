"""Port's sequence ops against `optispeech_tpu.ops` on the CPU (atol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optispeech_tpu import ops as jops
from optispeech_tpu_torch import ops as tops

torch.set_num_threads(1)

ATOL = 1e-5


@pytest.mark.parametrize("max_length", [1, 7, 32])
def test_sequence_mask(max_length):
    lengths = np.array([0, 1, 5, max_length], np.int32)
    expect = np.asarray(jops.sequence_mask(jnp.asarray(lengths), max_length))
    got = tops.sequence_mask(torch.from_numpy(lengths), max_length).numpy()
    np.testing.assert_array_equal(got, expect)


def _durations(rng, b, t_text, x_lengths):
    d = rng.integers(0, 6, (b, t_text)).astype(np.int32)
    d[np.arange(t_text)[None, :] >= x_lengths[:, None]] = 0
    return d


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gaussian_upsample_padded_frames_and_tokens(seed):
    rng = np.random.default_rng(seed)
    b, t_text, c, n_frames = 3, 12, 8, 64
    x_lengths = np.array([12, 7, 3], np.int32)
    d = _durations(rng, b, t_text, x_lengths)
    y_lengths = d.sum(1).astype(np.int32)
    hs = rng.normal(size=(b, t_text, c)).astype(np.float32)
    x_mask = np.arange(t_text)[None, :] < x_lengths[:, None]
    y_mask = np.arange(n_frames)[None, :] < y_lengths[:, None]
    assert (~y_mask).any() and (~x_mask).any()  # both kinds of padding present

    expect = jops.gaussian_upsample(jnp.asarray(hs), jnp.asarray(d.astype(np.float32)),
                                    jnp.asarray(y_mask), jnp.asarray(x_mask))
    got = tops.gaussian_upsample(torch.from_numpy(hs), torch.from_numpy(d).float(),
                                 torch.from_numpy(y_mask), torch.from_numpy(x_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=ATOL)
    # padded frames sit at position 0 (t * h_masks) and still get values
    assert np.abs(got.numpy()[~y_mask]).max() > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_expand_by_duration(seed):
    rng = np.random.default_rng(seed)
    b, t_text, c, n_frames = 2, 10, 3, 48
    d = _durations(rng, b, t_text, np.array([10, 6], np.int32))
    x = rng.normal(size=(b, t_text, c)).astype(np.float32)
    e_out, e_len = jops.expand_by_duration(jnp.asarray(x), jnp.asarray(d), n_frames)
    t_out, t_len = tops.expand_by_duration(torch.from_numpy(x), torch.from_numpy(d), n_frames)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(e_out), atol=ATOL)
    np.testing.assert_array_equal(t_len.numpy(), np.asarray(e_len))
    assert t_len.dtype == torch.int32
