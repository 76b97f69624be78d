"""Stream ms per step of the discriminator's turn (its losses on the G turn's
waveforms and its gradient), from the program's own `train/d_turn` spans
(`harness.program_spans`): timing events on the stream, the device's idle
time inside the turn included."""

from harness.program_spans import mean_stream_ms


def read(t):
    return mean_stream_ms("train/d_turn")
