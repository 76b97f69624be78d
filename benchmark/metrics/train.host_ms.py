"""Host ms per GAN step, from the program's own `train/step` spans
(`harness.program_spans`): the host's time to issue a step, its device waits
included; against `train_step_ms` it says how far the host runs ahead."""

from harness.program_spans import mean_host_ms


def read(t):
    return mean_host_ms("train/step")
