"""A configuration whose vocoder the plain reference lacks, taken with new
files only: it names its own reference file (`"reference": "<file>"`), and
the harness builds that file's generator, draws its weights from the seed
(transposed convolutions and `weight_init` included), runs the reference's
parts that the cells call, compares through it and traces it, at test
widths on the CPU. The file here is `tests/reference/toy_vocoder.py`: the
flagship's reference with a HiFi-GAN-like vocoder."""

import hashlib
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

import tiny
from harness import common
from harness.compare import Rows, compare
from harness.synthesis import frame_rate_blocks, install_spans, raw_durations, synthesis_flops
from harness.trace import Spans, analyse
from harness.weights import TRUNC_STD, seeded_state_dict

TESTS = Path(__file__).resolve().parent
if str(TESTS) not in sys.path:  # tests/reference/: a second portion of `reference`
    sys.path.insert(0, str(TESTS))

TOY_VOCODER = {"f0_cond": False, "upsample_initial_channel": 32, "upsample_rates": [8, 8, 4],
               "upsample_kernel_sizes": [16, 16, 8], "resblock_kernel_sizes": [3, 5],
               "resblock_dilation_sizes": [[1, 3], [1, 3]]}
# sha256 of the tiny seeded state dicts of the two modelled configurations at
# seeds 7 and 2**31 + 3 (torch 2.13 on the CPU), as drawn before transposed
# convolutions and `weight_init` were taken: the same seed, the same weights
PINNED = {
    ("convnext", 7): "b49269531f50256270320349a07c0a78d36d52be7c7207f98dac01cd8fbbae1b",
    ("convnext", 2 ** 31 + 3): "295cff320596af9aaaad4a894d6a74548fe62ed1db790e25a219264a22669e04",
    ("conformer", 7): "234bd58c613a5f007ec5339a1a05cad7a3bfb09806acca064ae6779430e6af46",
    ("conformer", 2 ** 31 + 3): "54bc776e07f68b3a1344c377fac2b4508086699e9f4782a572e4cafb1a259ffa",
}


def toy_config(base="convnext"):
    cfg = tiny.tiny_config(base)
    cfg["reference"] = "toy_vocoder.py"
    cfg["config"]["generator"]["vocoder"] = dict(TOY_VOCODER)
    return cfg


def digest(state: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(state):
        t = state[k].detach().cpu().contiguous()
        h.update(f"{k}|{t.dtype}|{tuple(t.shape)}|".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def _inputs(rows=3, width=24, seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(width // 2, width + 1, rows)
    ids = rng.integers(3, 150, (rows, width))
    ids[np.arange(width)[None, :] >= lengths[:, None]] = 0
    return ids, lengths


@pytest.mark.parametrize("name,seed", sorted(PINNED))
def test_modelled_configurations_draw_the_pinned_weights(name, seed):
    cfg = tiny.tiny_config(name)
    assert "reference" not in cfg  # the default, reference/generator.py
    ref = common.reference_generator(cfg, "cpu")
    assert type(ref).__module__ == "reference.generator"
    assert digest(seeded_state_dict(ref, seed, "cpu")) == PINNED[(name, seed)]


def test_the_loader_takes_a_file_name_only():
    for bad in ("../generator.py", "generator", "sub/generator.py", "/tmp/x.py"):
        with pytest.raises(ValueError):
            common.reference_generator({**tiny.tiny_config("convnext"), "reference": bad}, "cpu")


def test_toy_reference_is_built_and_runs():
    cfg = toy_config()
    ref = common.reference_generator(cfg, "cpu").eval()
    assert type(ref).__module__ == "reference.toy_vocoder"
    assert any(isinstance(m, nn.ConvTranspose1d) for m in ref.modules())
    seeded_state_dict(ref, 11, "cpu")
    ids, lengths = _inputs()
    raw = raw_durations(ref, ids, lengths, "cpu")
    assert raw.shape == ids.shape and np.all(raw[ids == 0] == 0) and np.all(raw[ids != 0] > 0)
    n_frames = 48
    with torch.no_grad():
        enc = ref.encode(torch.as_tensor(ids), torch.as_tensor(lengths), 1.0, 1.0, 1.0)
        y_len = torch.clamp(enc["durations"].sum(1), max=n_frames)
        wav = ref.decode(enc["hidden"], enc["durations"], enc["x_mask"], y_len, n_frames)
    assert wav.shape == (len(lengths), n_frames * ref.hop) and torch.isfinite(wav).all()
    f = synthesis_flops(ref, ids.shape[1], n_frames, "cpu")
    # the vocoder's first transposed conv alone: 2 x in x out x kernel a frame
    v = TOY_VOCODER
    first_up = 2 * v["upsample_initial_channel"] * (v["upsample_initial_channel"] // 2) \
        * v["upsample_kernel_sizes"][0]
    assert f["per_frame"] > first_up and f["per_token"] > 0


def test_toy_reference_is_compared():
    """The comparison through the toy: its own answers read 0, a row's audio
    reversed reads far off."""
    ref = common.reference_generator(toy_config(), "cpu").eval()
    seeded_state_dict(ref, 12, "cpu")
    ids, lengths = _inputs(rows=2)
    n_frames = 64
    with torch.no_grad():
        enc = ref.encode(torch.as_tensor(ids), torch.as_tensor(lengths), 1.0, 1.0, 1.0)
        y_len = torch.clamp(enc["durations"].sum(1), max=n_frames)
        wav = ref.decode(enc["hidden"], enc["durations"], enc["x_mask"], y_len, n_frames)
    audio = [np.round(wav[j, :int(y_len[j]) * ref.hop].numpy() * 32767).astype(np.int16)
             for j in range(len(lengths))]

    def rows(answers):
        return Rows(ids=ids, lengths=lengths, factors=(1.0, 1.0, 1.0), n_frames=n_frames,
                    durations=enc["durations"].numpy(), pitch=enc["pitch"].numpy(),
                    energy=enc["energy"].numpy(), audio=answers, wire="pcm16")

    same = compare(ref, [rows(audio)], "cpu")
    assert same["dur_mismatch_pct"] == 0 and same["wav_gap"] < 1e-3
    assert same["pitch_gap"] < 1e-6 and same["energy_gap"] < 1e-6
    altered = compare(ref, [rows([audio[0][::-1].copy(), audio[1]])], "cpu")
    assert altered["wav_gap"] > 0.1


def test_toy_weights_repeat_differ_and_follow_weight_init():
    ref = common.reference_generator(toy_config(), "cpu")
    a = seeded_state_dict(ref, 7, "cpu")
    a = {k: v.clone() for k, v in a.items()}
    b = seeded_state_dict(common.reference_generator(toy_config(), "cpu"), 7, "cpu")
    c = seeded_state_dict(common.reference_generator(toy_config(), "cpu"), 2 ** 31 + 3, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    drawn = [k for k in a if k.endswith("weight") and float(a[k].std()) > 0]
    assert drawn and not any(torch.equal(a[k], c[k]) for k in drawn)
    voc = ref.vocoder
    for i, up in enumerate(voc.ups):  # LeCun normal, fan-in = in_channels x kernel_size
        w, std = a[f"vocoder.ups.{i}.weight"], math.sqrt(1.0 / (up.in_channels
                                                                  * up.kernel_size[0]))
        assert float(w.std()) == pytest.approx(std, rel=0.15)
        assert float(w.abs().max()) <= 2 * std / TRUNC_STD + 1e-7
        assert torch.all(a[f"vocoder.ups.{i}.bias"] == 0)
    # ResBlock's class attribute: normal, std 0.01, untruncated
    res = torch.cat([a[k].flatten() for k in a if ".resblocks." in k and k.endswith("weight")])
    assert float(res.std()) == pytest.approx(0.01, rel=0.05)
    assert float(res.abs().max()) > 0.02
    assert all(torch.all(a[k] == 0) for k in a if ".resblocks." in k and k.endswith("bias"))
    # an instance's attribute, on a container, reaches the layers inside it
    voc.ups.weight_init = ("normal", 0.05)
    d = seeded_state_dict(ref, 7, "cpu")
    ups = torch.cat([d[f"vocoder.ups.{i}.weight"].flatten() for i in range(len(voc.ups))])
    assert float(ups.std()) == pytest.approx(0.05, rel=0.05)
    voc.ups.weight_init = ("laplace", 1.0)
    with pytest.raises(ValueError):
        seeded_state_dict(ref, 7, "cpu")


@pytest.mark.parametrize("base", ["convnext", "conformer"])
def test_spans_of_a_generator_without_a_convnext_trunk(base):
    """`decode` and `decoder` hooked as for WaveNeXt; `b1` only on the
    decoder's ConvNeXt blocks, where the decoder is a ConvNeXt stack; a
    traced decode through the toy reads those spans."""
    from torch.profiler import ProfilerActivity, profile

    cfg = toy_config(base)
    g = cfg["config"]["generator"]
    ref = common.reference_generator(cfg, "cpu").eval()
    seeded_state_dict(ref, 3, "cpu")
    blocks = frame_rate_blocks(ref, g)
    assert len(blocks) == (g["decoder"]["num_layers"] if base == "convnext" else 0)
    spans = Spans()
    install_spans(spans, ref, g)
    ids, lengths = _inputs(rows=2)
    n_frames = 32
    with torch.no_grad():
        enc = ref.encode(torch.as_tensor(ids), torch.as_tensor(lengths), 1.0, 1.0, 1.0)
        y_len = torch.clamp(enc["durations"].sum(1), max=n_frames)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            ref.decode(enc["hidden"], enc["durations"], enc["x_mask"], y_len, n_frames)
    spans.remove()
    assert "decode" not in ref.__dict__  # the method wrapper removed
    events = prof.profiler.kineto_results.events()
    t = analyse(events, min(e.start_ns() for e in events), max(e.end_ns() for e in events))
    calls = {k: v for k, v in t.span_calls.items() if not k.startswith("optispeech/")}
    assert calls == {"decode": 1, "decoder": 1, **({"b1": len(blocks)} if blocks else {})}
    assert len(spans.shapes.get("b1", [])) == len(blocks)
    if not blocks:  # nothing to read: the metric is left out, not 0
        t.span_shapes = dict(spans.shapes)
        assert common.load_module("metrics", "b1.roofline_pct").read(t) is None
