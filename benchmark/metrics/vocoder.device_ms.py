"""Device ms per call of the kernels launched inside the program's own
`vocoder` span (`optispeech/vocoder`, around the vocoder's call in the
generator's `decode`): WaveNeXt's embedding, trunk and head, or whichever
vocoder the configuration builds."""

SPAN = "optispeech/vocoder"


def read(t):
    calls = t.span_calls.get(SPAN)
    return 1e3 * t.span_device_s.get(SPAN, 0.0) / calls if calls else None
