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
  `convnext_block_reference`. It takes any C up to `MAX_CHANNELS` and any
  I: the pack pads both to multiples of 64 with zeros. Wider blocks, up to
  `WIDE_MAX_CHANNELS`, launch its wide path (`csrc/convnext_block_wide.cu`)
  on the same pack. `kernel_takes(T, C, I)` is JAX's `pick_tile(T, C, I)
  is not None`: a model runs the block fused where it holds and unfused
  where it does not, as JAX does; the wrapper takes every shape it accepts.
- `convnext_block_fused_int8` (B2, `csrc/convnext_block_int8.cu`): both
  products int8 x int8 -> int32, with dynamic per-frame activation scales
  (`quantize_rows_int8`) and per-output-channel weight scales
  (`quantize_weight_int8`). The kernel takes the codes packed once with
  their scales (`kernel_weights_int8`) and is launched by
  `convnext_block_int8_launch`; the wrapper packs per call unless given the
  pack. Its twin is `convnext_block_int8_reference`.
- Each wrapper launches its kernel for a CUDA tensor or raises, and runs its
  twin for a CPU tensor; `<wrapper>.launches` counts kernel launches
  (`convnext_block_fused.wide_launches` those of B1's wide path).
- The kernels are built with nvcc into `build/` beside the package at first
  use and loaded with ctypes (`ops/_build.py`).
"""

import ctypes
import functools
import math

import torch

from . import _build

HALO = 3  # k=7 depthwise conv, symmetric
MAX_CHANNELS = 512  # convnext_block.cu takes C up to this width (its accumulator and shared memory)
# convnext_block_wide.cu takes the wider blocks up to this width (its LayerNorm
# keeps C float32 in shared memory); JAX's rule tiles none wider than 16,298
WIDE_MAX_CHANNELS = 16384
CHANNELS = range(1, WIDE_MAX_CHANNELS + 1)
I_CHUNK = 64  # B1 walks I in chunks of this width
PADDED_CHANNELS = tuple(range(I_CHUNK, MAX_CHANNELS + 1, I_CHUNK))  # B1's instantiations
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


def _dwconv_layernorm(x, dw, dwb, lnw, lnb):
    """dwconv (taps k = 0..6, then the bias) and LayerNorm in float32, the
    LayerNorm's row sums by halves (`_tree_sum`) and its 1/sqrt a division
    by a rounded square root: a fixed order that a kernel can repeat, so that
    on the card the kernel's h can equal the twin's bit for bit."""
    t, c = x.shape[1], x.shape[2]
    xf = x.float()
    pad = torch.nn.functional.pad(xf, (0, 0, HALO, HALO))
    acc = torch.zeros_like(xf)
    for k in range(7):
        acc = acc + pad[:, k:k + t, :] * dw[k].float()
    acc = acc + dwb.float()
    mean = _div(_tree_sum(acc), float(c))
    centred = acc - mean
    var = _div(_tree_sum(centred * centred), float(c))
    return centred * _div(1.0, torch.sqrt(var + 1e-6)) * lnw.float() + lnb.float()


def convnext_block_reference(x, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma):
    """Plain PyTorch twin of the kernel, same contract and arithmetic; its
    dwconv and LayerNorm are `_dwconv_layernorm`'s, which both of B1's
    kernels repeat bit for bit."""
    xf = x.float()
    h = _dwconv_layernorm(x, dw, dwb, lnw, lnb)
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
        w1: (C, I); b1: (I,); w2: (I, C). On the card C is at most
            WIDE_MAX_CHANNELS (above MAX_CHANNELS the wide path runs), w1
            and w2 are bfloat16 and every other parameter float32, all
            contiguous.
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
convnext_block_fused.wide_launches = 0  # of those, the wide path's (C > MAX_CHANNELS)


# JAX's tile rule (optispeech_tpu/ops/pallas_convnext.py::pick_tile): the
# frame tiles it tries, and the VMEM its estimate may reach
JAX_TILES = (896, 768, 640, 512, 448, 384, 256, 128, 64)
JAX_VMEM_BYTES = 12 * 1024 * 1024


def kernel_takes(frames: int, channels: int, inter: int) -> bool:
    """Whether a model runs a block of T = `frames`, C = `channels` and
    I = `inter` fused: JAX's `pick_tile(T, C, I) is not None`, its rule in
    `optispeech_tpu/models/modules/convnext.py:50-52`. Decided by the shape
    alone, the same on every device. B1 itself takes any T and any I, and C
    up to WIDE_MAX_CHANNELS, which holds every C this rule accepts."""
    return any(frames % tile == 0 and frames >= tile
               and tile * (3 * channels + inter) * 4 + 4 * channels * inter <= JAX_VMEM_BYTES
               for tile in JAX_TILES)


def padded_width(n: int) -> int:
    """n rounded up to a multiple of I_CHUNK: the widths B1's pack holds."""
    return -(-n // I_CHUNK) * I_CHUNK


SWIZZLE_GROUPS = 8  # 16-byte groups in one 128-byte row of a kernel operand


def _swizzled_images(w1, w2, chunk):
    """(I / chunk, 2, C, chunk) images of w1 (C, I) and w2 (I, C), `chunk`
    elements being one 128-byte row: for each chunk j of I, the W1 image
    (row chunk * kb + n holds w1[chunk kb : chunk kb + chunk, chunk j + n],
    the depth C in blocks of `chunk`) and then the W2 image (row c holds
    w2[chunk j : chunk j + chunk, c]), K-major, as the kernels' wgmma
    descriptors read them. In row r the 16-byte group g is stored at
    g ^ (r % 8) (the 128-byte swizzle)."""
    c, inter = w1.shape
    n = inter // chunk
    img1 = w1.reshape(c // chunk, chunk, n, chunk).permute(2, 0, 3, 1).reshape(n, c, chunk)
    img2 = w2.reshape(n, chunk, c).permute(0, 2, 1)
    groups = torch.stack([img1, img2], dim=1).reshape(n, 2, c, SWIZZLE_GROUPS, -1)
    rows = torch.arange(c, device=w1.device)[:, None] % SWIZZLE_GROUPS
    logical = torch.arange(SWIZZLE_GROUPS, device=w1.device)[None, :] ^ rows  # (C, 8)
    index = logical[None, None, :, :, None].expand_as(groups)
    return groups.gather(3, index).reshape(n, 2, c, chunk).contiguous()


def kernel_weights(w1, w2):
    """B1's weights as the kernel copies them into shared memory:
    (I' / 64, 2, C', 64) bfloat16, where C' and I' are C and I rounded up to
    multiples of 64 (`padded_width`) and the added rows and columns of w1 and
    w2 are zeros; for each 64-wide chunk j of I' the image of the W1 chunk
    w1[:, 64j : 64j + 64] and then that of the W2 chunk w2[64j : 64j + 64, :].

    Each image is C rows of 64 bf16 (128 bytes), K-major, as the kernel's
    wgmma descriptors read it: row 64 kb + n of the W1 image holds
    w1[64 kb : 64 kb + 64, 64 j + n] (the depth C in blocks of 64), row c of
    the W2 image holds w2[64 j : 64 j + 64, c]. In row r the 16-byte group g
    is stored at g ^ (r % 8) (the 128-byte swizzle). One bulk copy moves a
    whole image into a slot of the kernel's ring. Zero weights past C and I
    add nothing: the kernel's h is zero past C and gelu(0 + 0) = 0 past I."""
    c, inter = w1.shape
    pc, pi = padded_width(c) - c, padded_width(inter) - inter
    w1 = torch.nn.functional.pad(w1.detach().to(torch.bfloat16), (0, pi, 0, pc))
    w2 = torch.nn.functional.pad(w2.detach().to(torch.bfloat16), (0, pc, 0, pi))
    return _swizzled_images(w1, w2, I_CHUNK)


def _check_tensor(name, tensor, shape, dtype, x):
    if not torch.is_tensor(tensor) or tuple(tensor.shape) != shape or tensor.dtype != dtype:
        got = (tuple(tensor.shape), tensor.dtype) if torch.is_tensor(tensor) else type(tensor)
        raise ValueError(f"{name} must be {shape} {dtype}, got {got}")
    if tensor.device != x.device or not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous and on x's device")


def _check_packed(x, packed, b1):
    c, inter = padded_width(x.shape[-1]), padded_width(b1.shape[0])
    _check_tensor("packed (kernel_weights)", packed, (inter // I_CHUNK, 2, c, I_CHUNK),
                  torch.bfloat16, x)


def convnext_block_launch(x, dw, dwb, lnw, lnb, packed, b1, b2, gamma):
    """Launch B1 on weights from `kernel_weights`; the caller has checked x
    and the float32 parameters (the wrapper does). Above MAX_CHANNELS it
    launches the wide path (`convnext_block_wide_launch`) on the same pack."""
    if x.shape[-1] > MAX_CHANNELS:
        return convnext_block_wide_launch(x, dw, dwb, lnw, lnb, packed, b1, b2, gamma)
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
            b, t, c, b1.shape[0], int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"convnext_block_fused: kernel launch failed with cudaError {err}")
    convnext_block_fused.launches += 1
    return out


# -- B1's wide path (csrc/convnext_block_wide.cu) --------------------------------

IMAGE_TILE = 64  # an image tile of h or u: 64 frames x 64 channels of bf16, 128-byte rows (8 KB)
WIDE_TILE_COLS = 128  # output columns of a product tile (its rows: two row tiles)
WIDE_MIN_SPLIT_BLOCKS = 4  # K blocks that a split of product 1 takes at least
H100_SMS = 132  # streaming multiprocessors of an H100 SXM


def wide_plan(batch: int, frames: int, channels: int, inter: int, sms: int = H100_SMS) -> dict:
    """How the wide path cuts one call, decided on the host from the shape.

    The LayerNorm kernel writes h into an image of `row_tiles` 64-frame row
    tiles (B x ceil(T / 64)), C' / 64 tiles of 64 channels each; product 1
    (h @ W1, then b1 and the GELU) writes u into an image of I' / 64 tiles a
    row tile; product 2 (u @ W2, then the residual) writes out. Each product
    cuts its output into tiles of two row tiles x WIDE_TILE_COLS columns
    (`tiles1`, `tiles2`: (row, column) counts) and its depth into 64-deep
    K blocks (`k_blocks1` = C' / 64, `k_blocks2` = I' / 64). Where product
    1's tiles
    would fill fewer than half of the `sms` multiprocessors, its K blocks
    are cut into `k_splits` runs of `k_per_split` (the last may be shorter,
    none is empty, each at least WIDE_MIN_SPLIT_BLOCKS long where K allows),
    whose float32 partial sums a fourth kernel adds in split order before
    b1 and the GELU. `h_elems` and `u_elems` are the images' bf16 elements,
    `partial_elems` the float32 elements of the partial sums (0 without a
    split)."""
    c_pad, i_pad = padded_width(channels), padded_width(inter)
    row_tiles = batch * -(-frames // IMAGE_TILE)
    row_blocks = -(-row_tiles // 2)
    tiles1 = (row_blocks, -(-i_pad // WIDE_TILE_COLS))
    tiles2 = (row_blocks, -(-c_pad // WIDE_TILE_COLS))
    k_blocks1, k_blocks2 = c_pad // IMAGE_TILE, i_pad // IMAGE_TILE
    splits = 1
    if 2 * tiles1[0] * tiles1[1] <= sms:
        splits = max(1, min(sms // (tiles1[0] * tiles1[1]), k_blocks1 // WIDE_MIN_SPLIT_BLOCKS))
    k_per_split = -(-k_blocks1 // splits)
    splits = -(-k_blocks1 // k_per_split)
    rows = row_tiles * IMAGE_TILE
    return {"row_tiles": row_tiles, "tiles1": tiles1, "tiles2": tiles2,
            "k_blocks1": k_blocks1, "k_blocks2": k_blocks2,
            "k_splits": splits, "k_per_split": k_per_split,
            "h_elems": rows * c_pad, "u_elems": rows * i_pad,
            "partial_elems": splits * rows * i_pad if splits > 1 else 0}


def _swizzle_rows(t):
    """t (..., 64 rows, 8 groups, 8) with each row's 16-byte group g moved to
    g ^ (row % 8), the 128-byte swizzle; its own inverse."""
    rows = torch.arange(IMAGE_TILE, device=t.device)[:, None] % SWIZZLE_GROUPS
    index = torch.arange(SWIZZLE_GROUPS, device=t.device)[None, :] ^ rows
    return t.gather(-2, index[..., None].expand_as(t))


def to_image(a):
    """(R * 64, K * 64) -> the flat swizzled image in which the wide path's
    kernels keep h and u: tile (r, k), the 64 x 64 block at rows 64 r and
    columns 64 k, at element (r * K + k) * 4096, its row i at 64 i, the
    16-byte group g of row i at g ^ (i % 8)."""
    r, k = a.shape[0] // IMAGE_TILE, a.shape[1] // IMAGE_TILE
    t = a.reshape(r, IMAGE_TILE, k, SWIZZLE_GROUPS, -1).permute(0, 2, 1, 3, 4)
    return _swizzle_rows(t).reshape(-1)


def from_image(image, rows: int, cols: int):
    """The (rows, cols) matrix that `to_image` laid out as `image`; rows and
    cols are multiples of 64."""
    r, k = rows // IMAGE_TILE, cols // IMAGE_TILE
    t = _swizzle_rows(image[:rows * cols].reshape(r, k, IMAGE_TILE, SWIZZLE_GROUPS, -1))
    return t.permute(0, 2, 1, 3, 4).reshape(rows, cols)


def convnext_block_wide_launch(x, dw, dwb, lnw, lnb, packed, b1, b2, gamma):
    """Launch B1's wide path on weights from `kernel_weights`, with its
    scratch (`wide_plan`) from torch.empty; it takes any C up to
    WIDE_MAX_CHANNELS. `convnext_block_launch` calls it above MAX_CHANNELS;
    chip_smoke.py also times it at narrower widths."""
    _check_packed(x, packed, b1)
    if x.device.type != "cuda":
        raise ValueError(f"convnext_block_wide_launch: no kernel for device {x.device}")
    b, t, c = x.shape
    inter = b1.shape[0]
    plan = wide_plan(b, t, c, inter, torch.cuda.get_device_properties(x.device).multi_processor_count)
    out = torch.empty_like(x)
    h_img = torch.empty(plan["h_elems"], dtype=torch.bfloat16, device=x.device)
    u_img = torch.empty(plan["u_elems"], dtype=torch.bfloat16, device=x.device)
    partials = (torch.empty(plan["partial_elems"], dtype=torch.float32, device=x.device)
                if plan["partial_elems"] else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _library("convnext_block_wide").convnext_block_wide_launch(
            x.data_ptr(), out.data_ptr(), dw.data_ptr(), dwb.data_ptr(), lnw.data_ptr(),
            lnb.data_ptr(), packed.data_ptr(), b1.data_ptr(), b2.data_ptr(), gamma.data_ptr(),
            h_img.data_ptr(), u_img.data_ptr(), None if partials is None else partials.data_ptr(),
            b, t, c, inter, plan["k_splits"], plan["k_per_split"], int(x.dtype == torch.bfloat16),
            stream)
    if err != 0:
        raise RuntimeError(f"convnext_block_fused: wide-path launch failed with cudaError {err}")
    convnext_block_fused.launches += 1
    convnext_block_fused.wide_launches += 1
    return out


def kernel_layout(channels: int) -> dict:
    """B1's dynamic shared memory per block and weight slots at `channels`
    (padded to a multiple of 64), as the built kernel reports them."""
    lib = _library()
    return {"smem_bytes": lib.convnext_block_smem_bytes(channels),
            "stages": lib.convnext_block_stages(channels)}


def _check_args(x, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma, weight_dtype=torch.bfloat16,
                channels=CHANNELS, inter_step=1):
    """Raise unless the kernel takes these arguments: C in `channels`, I a
    positive multiple of `inter_step`, and the dtypes, shapes and layout of
    the wrapper's contract, all on x's device."""
    if x.dim() != 3 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be (B, T, C) float32 or bfloat16, got {tuple(x.shape)} {x.dtype}")
    b, t, c = x.shape
    inter = w1.shape[-1]
    if b < 1 or t < 1:
        raise ValueError(f"x must not be empty, got {tuple(x.shape)}")
    if c not in channels:
        raise ValueError(f"the kernel takes C in {channels}, got {c}")
    if inter < inter_step or inter % inter_step:
        raise ValueError(f"the kernel takes I a positive multiple of {inter_step}, got {inter}")
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

INT8_CHANNELS = (128, 256, 384)  # B2's template instantiations
INT8_I_CHUNK = 128  # B2 walks I in chunks of this width (one 128-byte row of codes)
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
    square root (where JAX calls `rsqrt`): `_dwconv_layernorm`, shared with
    the bf16 twin. Each moves h by an ulp at most.
    """
    xf = x.float()
    h = _dwconv_layernorm(x, dw, dwb, lnw, lnb)

    def qmat(h, w, b):
        wq, ws = quantize_weight_int8(w)
        hq, hs = quantize_rows_int8(h)
        y = _int_matmul(hq, wq)
        return y.float() * hs * ws + b

    h2 = qmat(gelu_erf(qmat(h, w1, b1)), w2, b2)
    return (xf + gamma * h2).to(x.dtype)


def convnext_block_fused_int8(x, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma, *, packed=None):
    """Apply one int8 ConvNeXt block; the kernel on the card, the twin on the CPU.

    Args as `convnext_block_fused`, but w1 (C, I) and w2 (I, C) in float32, as
    the JAX function takes them; they are quantized per output channel.
    packed: `kernel_weights_int8(w1, w2)`, if the caller keeps it (the codes
        and scales of the same weights); otherwise the weights are quantized
        and packed on each call on the card, as the JAX wrapper quantizes
        them in its graph. Ignored on the CPU.
    On the card every parameter is float32 and contiguous, C is one of
    INT8_CHANNELS and I a multiple of 64.

    Returns (B, T, C) in x's dtype.
    """
    if x.device.type == "cpu":
        return convnext_block_int8_reference(x, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma)
    if x.device.type != "cuda":
        raise ValueError(f"convnext_block_fused_int8: no kernel for device {x.device}")
    _check_args(x, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma, weight_dtype=torch.float32,
                channels=INT8_CHANNELS, inter_step=I_CHUNK)
    if packed is None:
        packed = kernel_weights_int8(w1, w2)
    return convnext_block_int8_launch(x, dw, dwb, lnw, lnb, packed, b1, b2, gamma)


convnext_block_fused_int8.launches = 0


def kernel_weights_int8(w1, w2):
    """B2's weights as the kernel reads them: (images, s1, s2).

    The codes of w1 (C, I) and w2 (I, C) (`quantize_weight_int8`, per output
    channel) with I padded with zero codes to a multiple of 128, as
    `_swizzled_images` lays them out for 128 int8 to a row:
    (ceil(I / 128), 2, C, 128) int8, the W1 chunk then the W2 chunk of each
    128-wide chunk of I. s1 (I,) and s2 (C,) are their float32 scales."""
    w1q, s1 = quantize_weight_int8(w1.detach())
    w2q, s2 = quantize_weight_int8(w2.detach())
    c, inter = w1q.shape
    pad = -inter % INT8_I_CHUNK
    w1q = torch.cat([w1q, w1q.new_zeros(c, pad)], dim=1)
    w2q = torch.cat([w2q, w2q.new_zeros(pad, c)], dim=0)
    return _swizzled_images(w1q, w2q, INT8_I_CHUNK), s1.contiguous(), s2.contiguous()


def convnext_block_int8_launch(x, dw, dwb, lnw, lnb, packed, b1, b2, gamma):
    """Launch B2 on weights from `kernel_weights_int8`; the caller has
    checked x and the float32 parameters (the wrapper does)."""
    b, t, c = x.shape
    inter = b1.shape[0]
    if not isinstance(packed, (tuple, list)) or len(packed) != 3:
        raise ValueError("packed must be kernel_weights_int8's (images, s1, s2)")
    images, s1, s2 = packed
    if inter < I_CHUNK or inter % I_CHUNK:
        raise ValueError(f"packed: I must be a multiple of {I_CHUNK}, got {inter}")
    n = -(-inter // INT8_I_CHUNK)
    _check_tensor("packed images (kernel_weights_int8)", images, (n, 2, c, INT8_I_CHUNK),
                  torch.int8, x)
    _check_tensor("packed s1", s1, (inter,), torch.float32, x)
    _check_tensor("packed s2", s2, (c,), torch.float32, x)
    if x.device.type != "cuda":
        raise ValueError(f"convnext_block_int8_launch: no kernel for device {x.device}")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _library("convnext_block_int8").convnext_block_int8_launch(
            x.data_ptr(), out.data_ptr(), dw.data_ptr(), dwb.data_ptr(), lnw.data_ptr(),
            lnb.data_ptr(), images.data_ptr(), s1.data_ptr(), b1.data_ptr(), s2.data_ptr(),
            b2.data_ptr(), gamma.data_ptr(), b, t, c, inter, int(x.dtype == torch.bfloat16),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"convnext_block_fused_int8: kernel launch failed with cudaError {err}")
    convnext_block_fused_int8.launches += 1
    return out


def kernel_layout_int8(channels: int) -> dict:
    """B2's dynamic shared memory per block and weight slots at `channels`,
    as the built kernel reports them."""
    lib = _library("convnext_block_int8")
    return {"smem_bytes": lib.convnext_block_int8_smem_bytes(channels),
            "stages": lib.convnext_block_int8_stages(channels)}


# -- load ---------------------------------------------------------------------

_ENTRY_POINTS = {  # library -> (C function, number of pointer and int arguments)
    "convnext_block": ("convnext_block_fused_launch", 10, 5),
    "convnext_block_wide": ("convnext_block_wide_launch", 13, 7),
    "convnext_block_int8": ("convnext_block_int8_launch", 12, 5),
}


@functools.cache
def _library(name: str = "convnext_block") -> ctypes.CDLL:
    lib = _build.load(name)
    fn_name, n_ptr, n_int = _ENTRY_POINTS[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
