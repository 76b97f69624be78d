"""The whole synthesis call's share of the bf16 dense peak: the FLOPs of
the valid tokens and frames the traced window completed (per token and per
frame as counted on the plain reference at one row) over the window's wall."""

from harness.roofline import BF16_FLOPS


def read(t):
    work = t.work
    if not work.get("calls") or t.flops is None:
        return None
    f = t.flops()
    total = work["tokens"] * f["per_token"] + work["frames"] * f["per_frame"]
    return 100.0 * total / work["wall_s"] / BF16_FLOPS
