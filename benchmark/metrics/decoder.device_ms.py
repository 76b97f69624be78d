"""Device ms per call of the kernels launched inside the decoder backbone's
forward (ConvNeXt blocks, or Conformer layers with their attention)."""


def read(t):
    calls = t.span_calls.get("decoder")
    return 1e3 * t.span_device_s.get("decoder", 0.0) / calls if calls else None
