"""Device choice for the port's entry points."""

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as given, else the card; without a card and without an
    explicit device, raise rather than run somewhere else unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
