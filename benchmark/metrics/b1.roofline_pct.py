"""B1's share of its roofline: the least time of the frame-rate ConvNeXt
blocks' work (`harness.roofline`, at each call's shape) over the device time
of the kernels launched inside those blocks' calls (the `b1` span)."""

from harness.roofline import convnext_block_bound_s


def read(t):
    shapes, device_s = t.span_shapes.get("b1"), t.span_device_s.get("b1")
    if not shapes or not device_s:
        return None
    return 100.0 * sum(convnext_block_bound_s(*s) for s in shapes) / device_s
