"""Device-to-host syncs per GAN step, from the program's own `train/step`
spans (`harness.program_spans`): the syncs that CUDA's sync debug mode
reports inside a step (`.item()`, `.cpu()`, blocking copies), over the
steps. It does not see syncs made inside cuDNN or a ctypes launch."""

from harness.program_spans import by_name


def read(t):
    steps = by_name().get("train/step")
    return steps.syncs / steps.calls if steps else None
