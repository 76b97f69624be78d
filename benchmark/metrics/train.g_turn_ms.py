"""Stream ms per step of the generator's turn (G's forward, D's adversarial
losses, G's gradient), from the program's own `train/g_turn` spans
(`harness.program_spans`): timing events on the stream, the device's idle
time inside the turn included."""

from harness.program_spans import mean_stream_ms


def read(t):
    return mean_stream_ms("train/g_turn")
