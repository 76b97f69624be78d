"""The roofline, mfu and FLOP arithmetic against hand counts at tiny widths."""

import pytest
import torch

import tiny
from harness import common, roofline
from harness.synthesis import synthesis_flops
from harness.trace import TraceData
from reference.generator import Generator


def _trace(**kw):
    base = dict(window_s=2.0, busy_s=1.5, span_device_s={}, span_calls={}, span_shapes={},
                kernels={}, idle_gaps={})
    base.update(kw)
    return TraceData(**base)


def test_convnext_block_work_by_hand():
    b, t, c, i = 2, 5, 8, 16
    ops, nbytes = roofline.convnext_block_work(b, t, c, i)
    # two products of b*t*c*i multiply-adds, and the 7-tap depthwise conv
    assert ops == 2 * (b * t * c * i) * 2 + 2 * 7 * b * t * c
    # x in and out in float32; w1, w2 in bf16; dw (7c), dwb, lnw, lnb, b2, gamma (5c), b1 (i) in f32
    assert nbytes == 2 * b * t * c * 4 + 2 * c * i * 2 + 4 * (7 * c + 5 * c + i)
    big = roofline.convnext_block_bound_s(32, 1792, 384, 1152)
    assert big == pytest.approx(roofline.convnext_block_work(32, 1792, 384, 1152)[0]
                                / roofline.BF16_FLOPS)
    small = roofline.convnext_block_bound_s(1, 1, 4, 4)
    assert small == pytest.approx(roofline.convnext_block_work(1, 1, 4, 4)[1]
                                  / roofline.HBM_BYTES_PER_S)


def test_b1_roofline_reader():
    shapes = [(2, 5, 8, 16, 4)] * 3
    bound = 3 * roofline.convnext_block_bound_s(2, 5, 8, 16)
    read = common.load_module("metrics", "b1.roofline_pct").read
    assert read(_trace(span_shapes={"b1": shapes}, span_device_s={"b1": 4 * bound})) == \
        pytest.approx(25.0)
    assert read(_trace()) is None


def test_idle_and_span_readers():
    t = _trace(span_device_s={"decode": 0.3, "decoder": 0.1}, span_calls={"decode": 10,
                                                                        "decoder": 10})
    assert common.load_module("metrics", "device_idle_pct.synth").read(t) == pytest.approx(25.0)
    assert common.load_module("metrics", "generator.decode_ms").read(t) == pytest.approx(30.0)
    assert common.load_module("metrics", "decoder.device_ms").read(t) == pytest.approx(10.0)
    assert common.load_module("metrics", "generator.decode_ms").read(_trace()) is None
    c = _trace(counters={"batches": 4, "rows": 10, "synthesise_s": 0.2})
    assert common.load_module("metrics", "batcher.rows_per_batch").read(c) == pytest.approx(2.5)
    assert common.load_module("metrics", "batcher.synth_ms").read(c) == pytest.approx(50.0)


def test_synth_mfu_reader():
    t = _trace(work={"tokens": 100, "frames": 400, "calls": 2, "wall_s": 0.5},
               flops=lambda: {"per_token": 1e9, "per_frame": 2e9})
    expect = 100.0 * (100 * 1e9 + 400 * 2e9) / 0.5 / roofline.BF16_FLOPS
    assert common.load_module("metrics", "synth_mfu").read(t) == pytest.approx(expect)


def _hand_decode_flops(g, tt, tf):
    """Matrix-product and convolution FLOPs of one row's decode (2 a MAC)."""
    c, v = g["dim"], g["vocoder"]
    n_fft, hop = g["features"]["n_fft"], g["features"]["hop_length"]

    def convnext(width, inter, layers):
        return layers * (2 * 7 * width * tf + 2 * 2 * width * inter * tf)

    flops = 2 * tf * tt * c  # the Gaussian upsampling's product
    d = g["decoder"]
    flops += convnext(c, d["intermediate_dim"], d["num_layers"])
    flops += 2 * tf * v["dim"] * c * 7  # the vocoder's embedding conv
    flops += convnext(v["dim"], v["intermediate_dim"], v["num_layers"])
    flops += 2 * tf * v["dim"] * (n_fft + 2) + 2 * tf * (n_fft + 2) * hop
    return flops


def _hand_encode_flops(g, tt):
    c = g["dim"]
    e = g["encoder"]
    flops = e["num_layers"] * (2 * 7 * c * tt + 2 * 2 * c * e["intermediate_dim"] * tt)
    for name in ("duration_predictor", "pitch_predictor", "energy_predictor"):
        p = g[name]
        i, k = p["intermediate_dim"], p["kernel_size"]
        flops += 2 * tt * c * i * k + (p["num_layers"] - 1) * 2 * tt * i * i * k + 2 * tt * i
        if name != "duration_predictor":
            flops += 2 * tt * c * p["embed_kernel_size"]  # the value's embedding conv
    return flops


def test_synthesis_flops_by_hand():
    g = tiny.tiny_config("convnext")["config"]["generator"]
    ref = Generator(g).eval()
    tt, tf = 32, 128
    f = synthesis_flops(ref, tt, tf, "cpu")
    assert f["per_frame"] * tf == pytest.approx(_hand_decode_flops(g, tt, tf))
    assert f["per_token"] * tt == pytest.approx(_hand_encode_flops(g, tt))


def test_count_flops_counts_products():
    a, b = torch.randn(3, 5), torch.randn(5, 7)
    assert roofline.count_flops(lambda: a @ b) == 2 * 3 * 5 * 7
