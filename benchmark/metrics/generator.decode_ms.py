"""Device ms per call of the kernels launched inside the generator's
`decode` (the frame-rate stage: upsampling, decoder, vocoder)."""


def read(t):
    calls = t.span_calls.get("decode")
    return 1e3 * t.span_device_s.get("decode", 0.0) / calls if calls else None
