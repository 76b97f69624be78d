"""Faults planted in the program under test, for the check that the
comparison catches them (`readings.py --fault`, and the CPU tests):

- unchanged_state: a training step leaves the parameters as they were;
- half_batch: a training step runs on half of its batch, the means taken
  over the rest;
- altered_answer: one row's audio is altered where the generator makes it.
"""

import contextlib


def _unchanged_state():
    from optispeech_tpu_torch.training import state

    return [(state.Optimizer, "_apply", lambda self, grads, norm: None)]


def _half_batch():
    from optispeech_tpu_torch.training import step

    make = step.make_train_step

    def halved(cfg, mesh=None):
        inner = make(cfg, mesh)
        return lambda state, batch: inner(state, {k: v[:len(v) // 2] for k, v in batch.items()})

    return [(step, "make_train_step", halved)]


def _altered_answer():
    import torch

    from optispeech_tpu_torch.models.generator import OptiSpeechGenerator

    decode = OptiSpeechGenerator.decode

    def altered(self, *args, **kwargs):
        out = decode(self, *args, **kwargs)
        out["wav"] = out["wav"].clone()
        out["wav"][0] = torch.flip(out["wav"][0], [0])
        return out

    return [(OptiSpeechGenerator, "decode", altered)]


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "altered_answer": _altered_answer}


@contextlib.contextmanager
def planted(name: str):
    patches = FAULTS[name]()
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, value in patches:
        setattr(obj, attr, value)
    try:
        yield
    finally:
        for obj, attr, value in saved:
            setattr(obj, attr, value)
