"""Fused ConvNeXt block: the CUDA kernel and its plain twin.

Port of `optispeech_tpu/ops/pallas_convnext.py::convnext_block_fused`. One
call computes a whole inference ConvNeXt block on x (B, T, C):
dwconv(k=7) + bias -> LayerNorm (f32, eps 1e-6) -> Dense C->I (bf16
operands, f32 accumulation) + bias -> exact GELU -> Dense I->C (the same) +
bias -> x + gamma * h. Parameters take the JAX function's layout: dw (7, C),
w1 (C, I), w2 (I, C).

- `convnext_block_fused` is the wrapper. For a CUDA tensor it launches the
  kernel in `csrc/convnext_block.cu` or raises; for a CPU tensor it runs
  the twin. `convnext_block_fused.launches` counts kernel launches.
- `convnext_block_reference` is the twin: plain PyTorch, f32 throughout,
  with the two products on bf16-rounded operands and f32 accumulation.
- The kernel is built with nvcc into `build/` beside the package at first
  use and loaded with ctypes (`ops/_build.py`).
"""

import ctypes
import functools

import torch

from . import _build

HALO = 3  # k=7 depthwise conv, symmetric
CHANNELS = (128, 256, 384)  # the kernel's template instantiations
I_CHUNK = 64  # the kernel walks I in chunks of this width


def convnext_block_reference(x, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma):
    """Plain PyTorch twin of the kernel, same contract and arithmetic."""
    t = x.shape[1]
    xf = x.float()
    pad = torch.nn.functional.pad(xf, (0, 0, HALO, HALO))
    acc = torch.zeros_like(xf)
    for k in range(7):
        acc = acc + pad[:, k:k + t, :] * dw[k].float()
    acc = acc + dwb.float()
    mean = acc.mean(dim=-1, keepdim=True)
    centred = acc - mean
    var = (centred * centred).mean(dim=-1, keepdim=True)
    h = centred * torch.rsqrt(var + 1e-6) * lnw.float() + lnb.float()
    h1 = _bf16_matmul(h, w1) + b1.float()
    h1 = torch.nn.functional.gelu(h1, approximate="none")
    h2 = _bf16_matmul(h1, w2) + b2.float()
    return (xf + gamma.float() * h2).to(x.dtype)


def _bf16_matmul(a, w):
    """a @ w on bf16-rounded operands with f32 accumulation (a bf16 @ bf16
    product in torch would return bf16 and round the sum too)."""
    return a.bfloat16().float() @ w.bfloat16().float()


def convnext_block_fused(x, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma):
    """Apply one ConvNeXt block; the kernel on the card, the twin on the CPU.

    Args:
        x: (B, T, C) float32 or bfloat16, any T >= 1.
        dw: (7, C) depthwise kernel; dwb, lnw, lnb, b2, gamma: (C,).
        w1: (C, I); b1: (I,); w2: (I, C). On the card w1 and w2 must be
            bfloat16 and every other parameter float32, all contiguous.

    Returns (B, T, C) in x's dtype.
    """
    if x.device.type == "cpu":
        return convnext_block_reference(x, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma)
    if x.device.type != "cuda":
        raise ValueError(f"convnext_block_fused: no kernel for device {x.device}")
    b, t, c, inter = _check_args(x, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _library().convnext_block_fused_launch(
            x.data_ptr(), out.data_ptr(), dw.data_ptr(), dwb.data_ptr(), lnw.data_ptr(),
            lnb.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            gamma.data_ptr(), b, t, c, inter, int(x.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"convnext_block_fused: kernel launch failed with cudaError {err}")
    convnext_block_fused.launches += 1
    return out


convnext_block_fused.launches = 0


def _check_args(x, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma):
    if x.dim() != 3 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be (B, T, C) float32 or bfloat16, got {tuple(x.shape)} {x.dtype}")
    b, t, c = x.shape
    inter = w1.shape[-1]
    if b < 1 or t < 1:
        raise ValueError(f"x must not be empty, got {tuple(x.shape)}")
    if c not in CHANNELS:
        raise ValueError(f"the kernel takes C in {CHANNELS}, got {c}")
    if inter % I_CHUNK:
        raise ValueError(f"the kernel takes I a multiple of {I_CHUNK}, got {inter}")
    expect = {
        "dw": (dw, (7, c), torch.float32), "dwb": (dwb, (c,), torch.float32),
        "lnw": (lnw, (c,), torch.float32), "lnb": (lnb, (c,), torch.float32),
        "w1": (w1, (c, inter), torch.bfloat16), "b1": (b1, (inter,), torch.float32),
        "w2": (w2, (inter, c), torch.bfloat16), "b2": (b2, (c,), torch.float32),
        "gamma": (gamma, (c,), torch.float32),
    }
    for name, (tensor, shape, dtype) in {"x": (x, tuple(x.shape), x.dtype), **expect}.items():
        if tensor.device != x.device:
            raise ValueError(f"{name} is on {tensor.device}, x on {x.device}")
        if tuple(tensor.shape) != shape or tensor.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got {tuple(tensor.shape)} {tensor.dtype}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return b, t, c, inter


# -- load ---------------------------------------------------------------------

@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("convnext_block")
    fn = lib.convnext_block_fused_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
