"""A synthesis call with no host-device sync (`OptiSpeech.synthesise_on_device`).

On the CPU: `_tensors`, which stages the inputs in one pinned buffer moved by
one non-blocking copy, gives what the blocking per-array copies gave; the
text positions, whose frequencies now take a Python scalar base, equal the
old formula bit for bit and give the scale the same gradient; a call equals
`synthesise_fixed` on inputs moved the old way. On the card (skipped here):
the call raises nothing under CUDA's sync debug mode "error", its
`synthesise` span counts 0 syncs, and calls issued back to back with no
sync between them give what each gives alone.

These tests import no JAX:
    python -m pytest --noconftest tests/test_torch_sync_free.py -k card
"""

import dataclasses

import numpy as np
import pytest
import torch

from optispeech_tpu_torch.config import ExperimentConfig
from optispeech_tpu_torch.models.modules.core import (DEFAULT_MAX_SOURCE_POSITIONS,
                                                      ScaledSinusoidalEmbedding)
from optispeech_tpu_torch.models.optispeech import OptiSpeech, with_fused_blocks
from optispeech_tpu_torch.utils import tracing
from optispeech_tpu_torch.values import InferenceInputs
from torch_card import cuda  # noqa: F401  (fixture)

torch.set_num_threads(1)


def flagship(layers: int, dim: int = 256, inner: int = 1024, voc_dim: int = 384,
             voc_inner: int = 1152) -> ExperimentConfig:
    """The flagship's configuration with `layers` blocks per stack; the
    widths default to the flagship's and are cut for the CPU tests."""
    cfg = ExperimentConfig()
    g = cfg.generator
    stack = lambda b, i: dataclasses.replace(b, num_layers=layers, intermediate_dim=i)  # noqa: E731
    g = dataclasses.replace(g, dim=dim, encoder=stack(g.encoder, inner),
                            decoder=stack(g.decoder, inner),
                            vocoder=dataclasses.replace(stack(g.vocoder, voc_inner), dim=voc_dim))
    return dataclasses.replace(cfg, generator=g)


def batch(rng, lengths, speakers: bool = False, d_factor: float = 1.0) -> InferenceInputs:
    kw = {}
    if speakers:
        kw = dict(sids=rng.integers(0, 3, len(lengths)), lids=rng.integers(0, 2, len(lengths)))
    return InferenceInputs.from_ids_and_lengths(
        ids=[rng.integers(3, 150, n).tolist() for n in lengths], lengths=lengths,
        clean_text="x", d_factor=d_factor, p_factor=1.1, e_factor=0.9, **kw)


def blocking_tensors(model: OptiSpeech, inputs: InferenceInputs):
    """The inputs moved as `_tensors` moved them before: one blocking copy
    of each array from pageable memory."""
    inputs = inputs.as_numpy()
    b, t_text = inputs.x.shape
    width = -(-t_text // model.text_bucket) * model.text_bucket
    x = np.zeros((b, width), np.int64)
    x[:, :t_text] = inputs.x
    dev = lambda a: None if a is None else torch.as_tensor(  # noqa: E731
        np.asarray(a, np.int64), device=model.device)
    return (dev(x), dev(inputs.x_lengths).to(torch.int32), dev(inputs.sids), dev(inputs.lids),
            float(inputs.d_factor), float(inputs.p_factor), float(inputs.e_factor))


@pytest.fixture(scope="module")
def small():
    return OptiSpeech(flagship(1, 32, 64, 48, 96), seed=5, device="cpu")


# -- on the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("speakers", [False, True])
@pytest.mark.parametrize("lengths", [[5], [31, 7, 32], [33, 12], [70, 1, 64, 9]])
def test_tensors_equal_the_blocking_copies(small, lengths, speakers):
    inputs = batch(np.random.default_rng(len(lengths)), lengths, speakers)
    got, want = small._tensors(inputs), blocking_tensors(small, inputs)
    assert (got[2] is None) == (got[3] is None) == (not speakers)
    for g, w in zip(got, want):
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and g.shape == w.shape and g.device == w.device
            assert torch.equal(g, w)
        else:
            assert g == w and type(g) is type(w)


def old_positions(module: ScaledSinusoidalEmbedding, seq_len: int) -> torch.Tensor:
    """The positions as computed before, with the base a float32 tensor."""
    half = module.dim // 2
    freq_seq = torch.arange(half, dtype=torch.float32) / half
    inv_freq = torch.pow(torch.tensor(module.theta, dtype=torch.float32), -freq_seq)
    emb = torch.arange(seq_len, dtype=torch.float32)[:, None] * inv_freq[None, :]
    return torch.cat([emb.sin(), emb.cos()], dim=-1) * module.scale


@pytest.mark.parametrize("theta", [10000.0, DEFAULT_MAX_SOURCE_POSITIONS])
@pytest.mark.parametrize("dim", [32, 256])
def test_positions_bit_equal_with_the_same_scale_gradient(theta, dim):
    module = ScaledSinusoidalEmbedding(dim, theta=theta)
    with torch.no_grad():
        module.scale.fill_(0.37)
    for seq_len in (1, 17, 256, 1792):
        new = module(seq_len)
        (g_new,) = torch.autograd.grad(new.square().sum(), module.scale)
        old = old_positions(module, seq_len)
        (g_old,) = torch.autograd.grad(old.square().sum(), module.scale)
        assert new.dtype == old.dtype == torch.float32
        assert torch.equal(new, old), seq_len
        assert torch.equal(g_new, g_old), seq_len


def test_synthesise_on_device_equals_the_blocking_path(small):
    inputs = batch(np.random.default_rng(7), [30, 12, 21], d_factor=1.5)
    out = small.synthesise_on_device(inputs, 96, pcm16=True)
    with torch.inference_mode():
        want = small.generator.synthesise_fixed(*blocking_tensors(small, inputs), n_frames=96)
    for k, v in want.items():
        assert torch.equal(out[k], v), k


# -- on the card --------------------------------------------------------------

@pytest.fixture
def card_model(cuda):  # noqa: F811
    """The flagship's widths, 2 blocks per stack, B1 on the decoder and the
    trunk (as the offline cells run it), warmed up at the shape used."""
    model = OptiSpeech(with_fused_blocks(flagship(2)), seed=11, device=cuda)
    rng = np.random.default_rng(3)
    calls = [batch(rng, rng.integers(90, 128, 8).tolist(), d_factor=3.0) for _ in range(4)]
    for inputs in calls:
        model.synthesise_on_device(inputs, 640, pcm16=True)
    torch.cuda.synchronize()
    return model, calls


def test_no_sync_under_the_sync_debug_mode_on_the_card(card_model):
    model, calls = card_model
    torch.cuda.set_sync_debug_mode("error")
    try:
        for inputs in calls:
            model.synthesise_on_device(inputs, 640, pcm16=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_the_synthesise_span_counts_no_sync_on_the_card(card_model):
    model, calls = card_model
    tracing.clear()
    try:
        with tracing.enable():
            for inputs in calls:
                model.synthesise_on_device(inputs, 640, pcm16=True)
            torch.cuda.synchronize()
        spans = [r for r in tracing.snapshot().spans if r.name == "synthesise"]
    finally:
        tracing.clear()
    assert [r.syncs for r in spans] == [0] * len(calls)


def test_calls_back_to_back_equal_each_alone_on_the_card(card_model):
    model, calls = card_model
    alone = []
    for inputs in calls:
        out = model.synthesise_on_device(inputs, 640, pcm16=True)
        alone.append({k: v.cpu() for k, v in out.items()})  # a sync after each call
    outs = [model.synthesise_on_device(inputs, 640, pcm16=True) for inputs in calls]
    torch.cuda.synchronize()
    for want, out in zip(alone, outs):
        for k, v in want.items():
            assert torch.equal(out[k].cpu(), v), k
