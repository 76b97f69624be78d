"""Fused ConvNeXt blocks: the CUDA kernels and their plain twins.

Ports of `optispeech_tpu/ops/pallas_convnext.py`. One call computes a whole
inference ConvNeXt block on x (B, T, C): dwconv(k=7) + bias -> LayerNorm
(f32, eps 1e-6) -> Dense C->I + bias -> GELU -> Dense I->C + bias ->
x + gamma * h. Parameters take the JAX functions' layout: dw (7, C),
w1 (C, I), w2 (I, C). Both blocks compute the GELU as the JAX kernels do,
0.5 * u * (1 + erf(u / sqrt 2)) with the Abramowitz-Stegun erf (`_erf`,
`gelu_erf`), not the exact one.

- `convnext_block_fused` (B1, `csrc/convnext_block.cu`): both products on
  bf16 operands with f32 accumulation. The kernel takes its weights packed
  once (`kernel_weights`) and is launched by `convnext_block_launch`; the
  wrapper packs per call unless given the pack. Its twin is
  `convnext_block_reference`.
- `convnext_block_fused_int8` (B2, `csrc/convnext_block_int8.cu`): both
  products int8 x int8 -> int32, with dynamic per-frame activation scales
  (`quantize_rows_int8`) and per-output-channel weight scales
  (`quantize_weight_int8`, applied in the wrapper). Its twin is
  `convnext_block_int8_reference`.
- Each wrapper launches its kernel for a CUDA tensor or raises, and runs its
  twin for a CPU tensor; `<wrapper>.launches` counts kernel launches.
- The kernels are built with nvcc into `build/` beside the package at first
  use and loaded with ctypes (`ops/_build.py`).
"""

import ctypes
import functools
import math

import torch

from . import _build

HALO = 3  # k=7 depthwise conv, symmetric
CHANNELS = (128, 256, 384)  # the kernel's template instantiations
I_CHUNK = 64  # the kernel walks I in chunks of this width
INV_SQRT2 = 1.0 / math.sqrt(2.0)


def _div(num, den):
    """num / den, rounded once. Written as a division of two tensors on the
    same device: `number / tensor` is a reciprocal times the number, and on
    the card `tensor / number` is the tensor times the number's reciprocal."""
    if not torch.is_tensor(num):
        num = torch.full((), num, dtype=den.dtype, device=den.device)
    if not torch.is_tensor(den):
        den = torch.full((), den, dtype=num.dtype, device=num.device)
    return torch.div(num, den)


def _erf(x):
    """Abramowitz-Stegun 7.1.26 (|err| <= 1.5e-7), the operations in the order
    of `optispeech_tpu/ops/pallas_convnext.py::_erf`, which both JAX kernels'
    GELU uses in place of the exact erf."""
    a1, a2, a3 = 0.254829592, -0.284496736, 1.421413741
    a4, a5, p = -1.453152027, 1.061405429, 0.3275911
    s = torch.sign(x)
    ax = torch.abs(x)
    t = _div(1.0, 1.0 + p * ax)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    return s * (1.0 - poly * torch.exp(-ax * ax))


def gelu_erf(u):
    """The JAX kernels' GELU, `0.5 * u * (1 + _erf(u / sqrt 2))` in their
    order of operations (pallas_convnext.py:74)."""
    return 0.5 * u * (1.0 + _erf(u * INV_SQRT2))


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
    h1 = gelu_erf(_bf16_matmul(h, w1) + b1.float())
    h2 = _bf16_matmul(h1, w2) + b2.float()
    return (xf + gamma.float() * h2).to(x.dtype)


def _bf16_matmul(a, w):
    """a @ w on bf16-rounded operands with f32 accumulation (a bf16 @ bf16
    product in torch would return bf16 and round the sum too)."""
    return a.bfloat16().float() @ w.bfloat16().float()


def convnext_block_fused(x, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma, *, packed=None):
    """Apply one ConvNeXt block; the kernel on the card, the twin on the CPU.

    Args:
        x: (B, T, C) float32 or bfloat16, any T >= 1.
        dw: (7, C) depthwise kernel; dwb, lnw, lnb, b2, gamma: (C,).
        w1: (C, I); b1: (I,); w2: (I, C). On the card w1 and w2 must be
            bfloat16 and every other parameter float32, all contiguous.
        packed: `kernel_weights(w1, w2)`, if the caller keeps it; otherwise
            the weights are packed on each call on the card. Ignored on the CPU.

    Returns (B, T, C) in x's dtype.
    """
    if x.device.type == "cpu":
        return convnext_block_reference(x, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma)
    if x.device.type != "cuda":
        raise ValueError(f"convnext_block_fused: no kernel for device {x.device}")
    _check_args(x, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma)
    if packed is None:
        packed = kernel_weights(w1, w2)
    return convnext_block_launch(x, dw, dwb, lnw, lnb, packed, b1, b2, gamma)


convnext_block_fused.launches = 0

SWIZZLE_GROUPS = 8  # 16-byte groups in one 128-byte row of a kernel operand


def kernel_weights(w1, w2):
    """B1's weights as the kernel copies them into shared memory:
    (I / 64, 2, C, 64) bfloat16, for each 64-wide chunk j of I the image of
    the W1 chunk w1[:, 64j : 64j + 64] and then that of the W2 chunk
    w2[64j : 64j + 64, :].

    Each image is C rows of 64 bf16 (128 bytes), K-major, as the kernel's
    wgmma descriptors read it: row 64 kb + n of the W1 image holds
    w1[64 kb : 64 kb + 64, 64 j + n] (the depth C in blocks of 64), row c of
    the W2 image holds w2[64 j : 64 j + 64, c]. In row r the 16-byte group g
    is stored at g ^ (r % 8) (the 128-byte swizzle). One bulk copy moves a
    whole image into a slot of the kernel's ring."""
    c, inter = w1.shape
    n = inter // I_CHUNK
    w1b, w2b = w1.detach().to(torch.bfloat16), w2.detach().to(torch.bfloat16)
    img1 = w1b.reshape(c // I_CHUNK, I_CHUNK, n, I_CHUNK).permute(2, 0, 3, 1).reshape(n, c, I_CHUNK)
    img2 = w2b.reshape(n, I_CHUNK, c).permute(0, 2, 1)
    groups = torch.stack([img1, img2], dim=1).reshape(n, 2, c, SWIZZLE_GROUPS, -1)
    rows = torch.arange(c, device=w1.device)[:, None] % SWIZZLE_GROUPS
    logical = torch.arange(SWIZZLE_GROUPS, device=w1.device)[None, :] ^ rows  # (C, 8)
    index = logical[None, None, :, :, None].expand_as(groups)
    return groups.gather(3, index).reshape(n, 2, c, I_CHUNK).contiguous()


def _check_packed(x, packed, b1):
    c, inter = x.shape[-1], b1.shape[0]
    shape = (inter // I_CHUNK, 2, c, I_CHUNK)
    if packed.dtype != torch.bfloat16 or tuple(packed.shape) != shape or inter % I_CHUNK:
        raise ValueError(f"packed must be kernel_weights' {shape} bfloat16, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    if packed.device != x.device or not packed.is_contiguous():
        raise ValueError("packed must be contiguous and on x's device")


def convnext_block_launch(x, dw, dwb, lnw, lnb, packed, b1, b2, gamma):
    """Launch B1 on weights from `kernel_weights`; the caller has checked x
    and the float32 parameters (the wrapper does)."""
    _check_packed(x, packed, b1)
    if x.device.type != "cuda":
        raise ValueError(f"convnext_block_launch: no kernel for device {x.device}")
    b, t, c = x.shape
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _library().convnext_block_fused_launch(
            x.data_ptr(), out.data_ptr(), dw.data_ptr(), dwb.data_ptr(), lnw.data_ptr(),
            lnb.data_ptr(), packed.data_ptr(), b1.data_ptr(), b2.data_ptr(), gamma.data_ptr(),
            b, t, c, b1.shape[0], int(x.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"convnext_block_fused: kernel launch failed with cudaError {err}")
    convnext_block_fused.launches += 1
    return out


def kernel_layout(channels: int) -> dict:
    """B1's dynamic shared memory per block and weight slots at `channels`,
    as the built kernel reports them."""
    lib = _library()
    return {"smem_bytes": lib.convnext_block_smem_bytes(channels),
            "stages": lib.convnext_block_stages(channels)}


def _check_args(x, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma, weight_dtype=torch.bfloat16,
                max_inter=None):
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
    if max_inter is not None and inter > max_inter:
        raise ValueError(f"the kernel takes I up to {max_inter}, got {inter}")
    expect = {
        "dw": (dw, (7, c), torch.float32), "dwb": (dwb, (c,), torch.float32),
        "lnw": (lnw, (c,), torch.float32), "lnb": (lnb, (c,), torch.float32),
        "w1": (w1, (c, inter), weight_dtype), "b1": (b1, (inter,), torch.float32),
        "w2": (w2, (inter, c), weight_dtype), "b2": (b2, (c,), torch.float32),
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


# -- int8 block (B2) -----------------------------------------------------------

INT8_MAX_INTER = 1408  # the kernel keeps a (32, I) float32 tile in shared memory
INV_127 = 1.0 / 127.0  # a Python float: float32 where it meets a float32 tensor


def quantize_weight_int8(w):
    """Per-output-channel symmetric int8 quantization of a (in, out) weight:
    (int8 codes, (out,) float32 scale) with w ~= q * scale, bit for bit the
    JAX function's (a division by the scale, not a product by its reciprocal)."""
    s = torch.clamp(w.abs().amax(dim=0), min=1e-12) * INV_127
    return torch.round(w / s[None, :]).to(torch.int8), s


def quantize_rows_int8(h):
    """Dynamic per-row (per-frame) symmetric int8 quantization over the last
    axis: (int8 codes, float32 scale with a trailing axis of 1), h ~= q * scale."""
    amax = torch.clamp(h.abs().amax(dim=-1, keepdim=True), min=1e-12)
    return torch.round(h * _div(127.0, amax)).to(torch.int8), amax * INV_127


def _int_matmul(a, b):
    """int8 @ int8 -> int32, exact on every device: float64 holds every
    partial sum exactly (|sum| < 2**31 << 2**53)."""
    return (a.double() @ b.double()).to(torch.int32)


def _tree_sum(v):
    """Sum over the last axis by halves, v[:n/2] + v[n/2:2(n/2)], the odd last
    element carried: a fixed order that the kernel repeats, so the two agree
    bit for bit on the card."""
    while v.shape[-1] > 1:
        n = v.shape[-1]
        half = n // 2
        s = v[..., :half] + v[..., half:2 * half]
        v = torch.cat([s, v[..., n - 1:]], dim=-1) if n % 2 else s
    return v


def convnext_block_int8_reference(x, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma):
    """Plain PyTorch twin of the int8 kernel: the JAX oracle
    `convnext_block_int8_oracle`, line by line, in float32 and int32.

    Two steps have an order of their own, which the kernel repeats: the
    LayerNorm's row sums go by halves (`_tree_sum`, where JAX's `mean`
    reduces in XLA's order), and its 1/sqrt is a division by a rounded
    square root (where JAX calls `rsqrt`). Each moves h by an ulp at most.
    """
    t, c = x.shape[1], x.shape[2]
    xf = x.float()
    pad = torch.nn.functional.pad(xf, (0, 0, HALO, HALO))
    acc = torch.zeros_like(xf)
    for k in range(7):
        acc = acc + pad[:, k:k + t, :] * dw[k]
    acc = acc + dwb
    mean = _div(_tree_sum(acc), float(c))
    centred = acc - mean
    var = _div(_tree_sum(centred * centred), float(c))
    h = centred * _div(1.0, torch.sqrt(var + 1e-6)) * lnw + lnb

    def qmat(h, w, b):
        wq, ws = quantize_weight_int8(w)
        hq, hs = quantize_rows_int8(h)
        y = _int_matmul(hq, wq)
        return y.float() * hs * ws + b

    h2 = qmat(gelu_erf(qmat(h, w1, b1)), w2, b2)
    return (xf + gamma * h2).to(x.dtype)


def convnext_block_fused_int8(x, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma):
    """Apply one int8 ConvNeXt block; the kernel on the card, the twin on the CPU.

    Args as `convnext_block_fused`, but w1 (C, I) and w2 (I, C) in float32, as
    the JAX function takes them: they are quantized here, per output channel,
    on every call (as the JAX wrapper does in its graph). On the card every
    parameter is float32 and contiguous, and I a multiple of 64 up to
    INT8_MAX_INTER.

    Returns (B, T, C) in x's dtype.
    """
    if x.device.type == "cpu":
        return convnext_block_int8_reference(x, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma)
    if x.device.type != "cuda":
        raise ValueError(f"convnext_block_fused_int8: no kernel for device {x.device}")
    _check_args(x, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma, weight_dtype=torch.float32,
                max_inter=INT8_MAX_INTER)
    w1t, s1, w2t, s2 = kernel_weights_int8(w1, w2)
    return convnext_block_int8_launch(x, dw, dwb, lnw, lnb, w1t, s1, b1, w2t, s2, b2, gamma)


convnext_block_fused_int8.launches = 0


def kernel_weights_int8(w1, w2):
    """The int8 kernel's weights: the codes of w1 (C, I) and w2 (I, C),
    transposed to (I, C) and (C, I) so that each product's depth is
    contiguous, and their per-output-channel scales (I,) and (C,)."""
    w1q, s1 = quantize_weight_int8(w1)
    w2q, s2 = quantize_weight_int8(w2)
    return w1q.t().contiguous(), s1, w2q.t().contiguous(), s2


def convnext_block_int8_launch(x, dw, dwb, lnw, lnb, w1t, s1, b1, w2t, s2, b2, gamma):
    """Launch the int8 kernel on weights from `kernel_weights_int8`; the
    caller has checked x and the float32 parameters (the wrapper does)."""
    b, t, c = x.shape
    inter = w1t.shape[0]
    if w1t.dtype != torch.int8 or w2t.dtype != torch.int8 or tuple(w1t.shape) != (inter, c) \
            or tuple(w2t.shape) != (c, inter) or not (w1t.is_contiguous() and w2t.is_contiguous()):
        raise ValueError("w1t and w2t must be contiguous int8 (I, C) and (C, I)")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _library("convnext_block_int8").convnext_block_int8_launch(
            x.data_ptr(), out.data_ptr(), dw.data_ptr(), dwb.data_ptr(), lnw.data_ptr(),
            lnb.data_ptr(), w1t.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
            s2.data_ptr(), b2.data_ptr(), gamma.data_ptr(), b, t, c, inter,
            int(x.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"convnext_block_fused_int8: kernel launch failed with cudaError {err}")
    convnext_block_fused_int8.launches += 1
    return out


# -- load ---------------------------------------------------------------------

_ENTRY_POINTS = {  # library -> (C function, number of pointer and int arguments)
    "convnext_block": ("convnext_block_fused_launch", 10, 5),
    "convnext_block_int8": ("convnext_block_int8_launch", 13, 5),
}


@functools.cache
def _library(name: str = "convnext_block") -> ctypes.CDLL:
    lib = _build.load(name)
    fn_name, n_ptr, n_int = _ENTRY_POINTS[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
