"""Host ms per call of the generator's `decode` (the frame-rate stage), from
the program's own `decode` spans (`harness.program_spans`): the host's cost
of launching the stage, which paces the call where it is above the stage's
device time (`generator.decode_ms`)."""

from harness.program_spans import mean_host_ms


def read(t):
    return mean_host_ms("decode")
