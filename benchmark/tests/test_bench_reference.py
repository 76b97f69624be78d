"""The plain reference against the program, at test widths on the CPU, with
the same seeded weights: the unfused program in float32 equals it to
rounding; the fused program's blocks (their bf16 products) stay close."""

import dataclasses

import numpy as np
import pytest
import torch

import tiny
from harness import common
from harness.weights import seeded_state_dict
from reference.generator import Generator

CONFIGS = ("convnext", "conformer")


def _models(name, fused):
    from optispeech_tpu_torch.models.optispeech import OptiSpeech

    cfg = tiny.tiny_config(name)
    ref = Generator(cfg["config"]["generator"]).eval()
    state = seeded_state_dict(ref, 1234, "cpu")
    pcfg = common.program_config(cfg)
    if not fused:
        g = pcfg.generator
        pcfg = dataclasses.replace(pcfg, generator=dataclasses.replace(
            g, decoder=dataclasses.replace(g.decoder, fused_pallas=False),
            vocoder=dataclasses.replace(g.vocoder, fused_pallas=False)))
    return ref, OptiSpeech(pcfg, device="cpu", state_dict=state)


def _inputs(rows=3, width=40, seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(width // 2, width + 1, rows)
    x = rng.integers(3, 150, (rows, width))
    x[np.arange(width)[None, :] >= lengths[:, None]] = 0
    return torch.as_tensor(x), torch.as_tensor(lengths)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("fused", [False, True])
def test_reference_matches_program(name, fused):
    ref, prog = _models(name, fused)
    x, xl = _inputs()
    d, p, e, n_frames = 3.0, 1.2, 0.9, 160
    with torch.no_grad():
        out = prog.generator.synthesise_fixed(x, xl.to(torch.int32), None, None, d, p, e,
                                              n_frames=n_frames)
        enc = ref.encode(x, xl, d, p, e)
        y_len = torch.clamp(enc["durations"].sum(1), max=n_frames)
        wav = ref.decode(enc["hidden"], enc["durations"], enc["x_mask"], y_len, n_frames)
    assert torch.equal(out["durations"], enc["durations"])
    torch.testing.assert_close(out["pitch"], enc["pitch"], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out["energy"], enc["energy"], rtol=1e-5, atol=1e-6)
    # float32 against float32: rounding; the fused blocks' bf16 products:
    # within 1% of the waveform's scale
    tol = 1e-2 if fused else 1e-5
    assert (out["wav"] - wav).abs().max() <= tol * wav.abs().max()


def test_seeded_weights_repeat_and_differ():
    g = tiny.tiny_config("conformer")["config"]["generator"]
    a = seeded_state_dict(Generator(g), 7, "cpu")
    b = seeded_state_dict(Generator(g), 7, "cpu")
    c = seeded_state_dict(Generator(g), 2 ** 31 + 3, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    # the distributions: layer scale kept, LayerNorm one, biases zero, a
    # truncated-normal block weight within two of its 0.02 deviations
    assert torch.all(a["vocoder.backbone.convnext.0.gamma"] == 1.0 / g["vocoder"]["num_layers"])
    assert torch.all(a["vocoder.norm.weight"] == 1.0) and torch.all(a["vocoder.embed.bias"] == 0)
    w = a["vocoder.backbone.convnext.0.pwconv1.weight"]
    assert w.abs().max() <= 0.04 and 0.01 < float(w.std()) < 0.02
