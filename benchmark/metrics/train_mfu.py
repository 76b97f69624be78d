"""The training step's share of the TF32 dense peak, at which the cell's
convolutions run: the step's FLOPs (G's forward and backward, both critic
turns; counted with torch's FLOP counter on the plain reference) times the
steps of the traced window, over the window's wall."""

from harness.roofline import TF32_FLOPS


def read(t):
    work = t.work
    if not work.get("steps") or t.flops is None:
        return None
    return 100.0 * t.flops() * work["steps"] / work["wall_s"] / TF32_FLOPS
