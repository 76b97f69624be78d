"""Stream ms per call of the generator's `decode`, from the program's own
`decode` spans (`harness.program_spans`): timing events on the stream at the
span's start and end, so the device's idle time inside the stage is counted;
its excess over `generator.decode_ms` (kernel time) is that idle time."""

from harness.program_spans import mean_stream_ms


def read(t):
    return mean_stream_ms("decode")
