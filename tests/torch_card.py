"""The card fixture of the port's kernel tests. It imports no JAX, so that on
a machine with a card and without JAX the card-only tests still collect:
    python -m pytest --noconftest tests/test_torch_fused_convnext.py tests/test_torch_mas.py -k cuda
"""

import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")
