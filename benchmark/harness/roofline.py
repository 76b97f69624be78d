"""Peaks of the card and the work of the kernels and calls the metrics judge.

The peaks are NVIDIA's published dense rates for one H100 SXM (80 GB HBM3)
at its full 700 W; a card set below that limit reads lower shares.

A fused ConvNeXt block (B1) on a (B, T, C) input with intermediate width I
does two products of 2 * B * T * C * I operations each in bf16, on the
tensor cores; its depthwise conv (14 * B * T * C) is counted with them. It
reads x (float32) and its weights (w1, w2 in bf16, the rest float32) once
and writes its output (float32) once. Its least time is the larger of
operations over the bf16 peak and bytes over the memory bandwidth.
"""

BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def convnext_block_work(b: int, t: int, c: int, i: int, x_bytes: int = 4) -> tuple[int, int]:
    """(operations, bytes) of one fused ConvNeXt block call."""
    ops = 2 * 2 * b * t * c * i + 2 * 7 * b * t * c
    weights = 2 * c * i * 2 + 4 * (7 * c + 5 * c + i)
    return ops, 2 * b * t * c * x_bytes + weights


def convnext_block_bound_s(b: int, t: int, c: int, i: int, x_bytes: int = 4) -> float:
    ops, nbytes = convnext_block_work(b, t, c, i, x_bytes)
    return max(ops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def count_flops(fn) -> int:
    """Matrix-product and convolution operations that `fn()` dispatches, as
    torch.utils.flop_counter counts them (2 per multiply-add)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())
