#!/usr/bin/env python3
"""How far B1's wide path (csrc/convnext_block_wide.cu) is from its twin,
and where the distance comes from.

    python3 scripts/b1_wide_error.py

At chip_smoke.py phase 3's inputs (B = 32, x float32, weights at its
scales), for C / I / T = 768 / 3072 / 1792, 576 / 1152 / 1792 and 12272 /
64 / 64, prints:
- max |kernel - twin| (ops/fused_convnext.py::convnext_block_reference);
- max |twin - exact| and max |kernel - exact|, where "exact" is the twin
  with both products summed in float64 (the same bf16 roundings of h and
  u): how far each float32 implementation is from the sums it stands for;
- the bf16 h that the wide path's LayerNorm kernel writes, unswizzled from
  its scratch image, against the twin's (mismatches; 0 expected), and the
  twin's h against one from a LayerNorm in PyTorch's own order (`mean`,
  `rsqrt`): the flips that a LayerNorm summed in another order makes;
- at C = 512 / I = 3072, the narrow kernel (convnext_block.cu) beside the
  wide path on the same inputs.
Needs a card; prints the card's name and power limit first.
"""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from optispeech_tpu_torch.ops import fused_convnext as fc  # noqa: E402

CASES = ((768, 3072, 1792), (576, 1152, 1792), (12272, 64, 64), (512, 3072, 1792))


def exact(x, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma):
    """The twin with both products summed in float64."""
    h = fc._dwconv_layernorm(x, dw, dwb, lnw, lnb)
    mm = lambda a, w: (a.bfloat16().double() @ w.bfloat16().double()).float()  # noqa: E731
    h1 = fc.gelu_erf(mm(h, w1) + b1.float())
    return (x.float() + gamma.float() * (mm(h1, w2) + b2.float())).to(x.dtype)


def torch_order_h(x, dw, dwb, lnw, lnb):
    """dwconv + LayerNorm with PyTorch's `mean` and `rsqrt`."""
    t = x.shape[1]
    pad = torch.nn.functional.pad(x.float(), (0, 0, fc.HALO, fc.HALO))
    acc = torch.zeros_like(x.float())
    for k in range(7):
        acc = acc + pad[:, k:k + t, :] * dw[k]
    acc = acc + dwb
    mean = acc.mean(dim=-1, keepdim=True)
    centred = acc - mean
    var = (centred * centred).mean(dim=-1, keepdim=True)
    return centred * torch.rsqrt(var + 1e-6) * lnw + lnb


def wide(x, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma):
    """The wide path through its library at any C: (out, h image as (B, T, C) bf16)."""
    b, t, c = x.shape
    cp, tiles = fc.padded_width(c), -(-t // 64)
    plan = fc.wide_plan(b, t, c, b1.shape[0], torch.cuda.get_device_properties(0).multi_processor_count)
    packed = fc.kernel_weights(w1, w2)
    out = torch.empty_like(x)
    h_img = torch.zeros(plan["h_elems"], dtype=torch.bfloat16, device=x.device)
    u_img = torch.empty(plan["u_elems"], dtype=torch.bfloat16, device=x.device)
    partials = torch.empty(max(1, plan["partial_elems"]), device=x.device)
    err = fc._library("convnext_block_wide").convnext_block_wide_launch(
        *(q.data_ptr() for q in (x, out, dw, dwb, lnw, lnb, packed, b1, b2, gamma, h_img, u_img,
                                 partials)),
        b, t, c, b1.shape[0], plan["k_splits"], plan["k_per_split"], 0,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"launch failed with cudaError {err}"
    h = fc.from_image(h_img, b * tiles * 64, cp).view(b, tiles * 64, cp)[:, :t, :c]
    return out, h


def main() -> int:
    if not torch.cuda.is_available():
        print("b1_wide_error: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    for c, inter, t in CASES:
        x, p = cs.block_inputs(torch.Generator().manual_seed(0), 32, t, c, inter, torch.float32,
                               "cuda")
        twin = fc.convnext_block_reference(x, *p)
        ref = exact(x, *p)
        got, h = wide(x, *p)
        h_twin = fc._dwconv_layernorm(x, *p[:4]).bfloat16()
        flips = (torch_order_h(x, *p[:4]).bfloat16() != h_twin).any(-1)
        line = (f"C={c} I={inter} B=32 T={t}: max|wide - twin| {float((got - twin).abs().max()):.3e}, "
                f"max|twin - exact| {float((twin - ref).abs().max()):.3e}, max|wide - exact| "
                f"{float((got - ref).abs().max()):.3e}; wide h != twin h in "
                f"{int((h != h_twin).sum())} elements; a LayerNorm in PyTorch's order flips h in "
                f"{int(flips.sum())} of {flips.numel()} frames")
        if c <= fc.MAX_CHANNELS:
            narrow = fc.convnext_block_fused(x, *p)
            line += (f"; narrow kernel: max|narrow - twin| {float((narrow - twin).abs().max()):.3e}, "
                     f"max|narrow - exact| {float((narrow - ref).abs().max()):.3e}")
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
