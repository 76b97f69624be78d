"""Host ms per call of the generator's `encode` (the token-rate stage), from
the program's own `encode` spans (`harness.program_spans`): the host's time
to issue it, device waits inside included."""

from harness.program_spans import mean_host_ms


def read(t):
    return mean_host_ms("encode")
