"""1-D ConvNeXt backbone: the encoder, the decoder and the WaveNeXt trunk.

Port of `optispeech_tpu/models/modules/convnext.py`. (B, T, C) in and out.
In eval mode with `fused`, each block whose shape JAX would tile
(`ops.fused_convnext.kernel_takes`, its `pick_tile` rule) runs as one call
of `ops.fused_convnext.convnext_block_fused`, B1's registered op: the CUDA
kernel on the card, its twin on the CPU; any other block runs unfused,
unless the caller passes `any_length=True` (the streaming windows, whose
length JAX's rule does not tile: B1 takes any T). A block whose FFN is
split over a tensor-parallel mesh (`parallel/tp.py`) runs unfused: the
kernel takes the whole intermediate width. In training
mode the blocks run unfused, with drop path drawn from the caller's
`torch.Generator`, as in JAX (fused only when deterministic). Submodule
names follow the reference's torch keys (`convnext.{i}.dwconv.weight`,
`final_layer_norm.weight`).

`dtype` is the compute dtype (`core.py`). In bfloat16 the unfused block
runs in bf16 in flax's order; the fused block takes x in bf16 and returns
bf16, as JAX's kernel returns x's dtype, with the same parameters as in
float32.
"""

from typing import Optional

import torch
from torch import nn

from ...ops.fused_convnext import convnext_block_fused, kernel_takes, kernel_weights
from ...parallel.tp import is_sharded
from .core import Conv1d, LayerNorm, Linear, conv_btc, gelu


def drop_path(x: torch.Tensor, drop_prob: float, generator: torch.Generator) -> torch.Tensor:
    """Per-sample stochastic depth: keep each item's branch with probability
    1 - drop_prob and scale it by 1 / (1 - drop_prob)."""
    keep = 1.0 - drop_prob
    mask = (torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), generator=generator,
                       device=x.device) < keep).to(x.dtype)
    if keep > 0.0:
        mask = mask / keep
    return x * mask


class ConvNeXtBlock(nn.Module):
    """dwconv(k=7) -> LN -> Linear(C->I) -> exact GELU -> Linear(I->C)
    -> layer scale -> drop path -> residual."""

    def __init__(self, dim: int, intermediate_dim: int,
                 layer_scale_init_value: Optional[float] = None, drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.dwconv = Conv1d(dim, dim, 7, padding=3, groups=dim, dtype=dtype)
        self.norm = LayerNorm(dim, 1e-6, dtype)
        self.pwconv1 = Linear(dim, intermediate_dim, dtype=dtype)
        self.pwconv2 = Linear(intermediate_dim, dim, dtype=dtype)
        if layer_scale_init_value is not None and layer_scale_init_value > 0:
            self.gamma = nn.Parameter(torch.full((dim,), float(layer_scale_init_value)))
        else:
            self.gamma = None
        self._fused_cache = None
        # set only while an exported graph is traced (export/exporter.py)
        self.given_fused_params = None

    def forward(self, x, fused: bool = False, generator: Optional[torch.Generator] = None,
                any_length: bool = False):
        if fused and self.gamma is not None and not is_sharded(self.pwconv1.weight) and (
                any_length or kernel_takes(x.shape[1], self.pwconv1.in_features,
                                           self.pwconv1.out_features)):
            *params, packed = self.fused_params()
            return convnext_block_fused(x, *params, packed=packed)
        h = conv_btc(self.dwconv, x)
        h = self.pwconv2(gelu(self.pwconv1(self.norm(h))))
        if self.gamma is not None:
            h = self.gamma.to(h.dtype) * h
        if self.training and self.drop_path_rate > 0.0:
            if generator is None:
                raise ValueError("drop path in training needs a torch.Generator")
            h = drop_path(h, self.drop_path_rate, generator)
        return x + h

    def fused_params(self):
        """The block's parameters in the kernel's layout: dw (7, C), w1 (C, I)
        and w2 (I, C) in bf16, the rest in f32, all contiguous, followed by
        the kernel's packed weights (`kernel_weights(w1, w2)`).

        Computed once and kept on the module; rebuilt when a parameter moves
        or is written in place (its storage or version changes). While an
        exported graph is traced, `given_fused_params` holds these tensors
        as the graph's own inputs, prepared once into the artifact: they are
        returned as they are, and the cache, keyed on storage, stays out of
        the trace."""
        if self.given_fused_params is not None:
            return self.given_fused_params
        params = (self.dwconv.weight, self.dwconv.bias, self.norm.weight, self.norm.bias,
                  self.pwconv1.weight, self.pwconv1.bias, self.pwconv2.weight,
                  self.pwconv2.bias, self.gamma)
        key = tuple((p.data_ptr(), p._version) for p in params)
        if self._fused_cache is None or self._fused_cache[0] != key:
            with torch.no_grad():
                f32 = lambda p: p.detach().float().contiguous()  # noqa: E731
                bf16 = lambda p: p.detach().t().to(torch.bfloat16).contiguous()  # noqa: E731
                prepared = (
                    f32(self.dwconv.weight[:, 0, :].t()), f32(self.dwconv.bias),
                    f32(self.norm.weight), f32(self.norm.bias),
                    bf16(self.pwconv1.weight), f32(self.pwconv1.bias),
                    bf16(self.pwconv2.weight), f32(self.pwconv2.bias), f32(self.gamma),
                )
                prepared += (kernel_weights(prepared[4], prepared[6]),)
            self._fused_cache = (key, prepared)
        return self._fused_cache[1]


class ConvNeXtBackbone(nn.Module):
    """Stack of ConvNeXt blocks, each followed by the keep-mask, then a
    final LayerNorm. Layer scale is 1/num_layers unless given; the drop-path
    rate ramps linearly from 0 at the first block to `drop_path` at the last."""

    def __init__(self, dim: int, intermediate_dim: int = 1024, num_layers: int = 4,
                 layer_scale_init_value: Optional[float] = None, fused_pallas: bool = False,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        lsiv = layer_scale_init_value or 1.0 / num_layers
        if num_layers > 1:
            rates = [drop_path * i / (num_layers - 1) for i in range(num_layers)]
        else:
            rates = [0.0]
        self.convnext = nn.ModuleList(
            [ConvNeXtBlock(dim, intermediate_dim, lsiv, rate, dtype) for rate in rates]
        )
        self.final_layer_norm = LayerNorm(dim, 1e-6, dtype)
        # module-level fused default (the decoder), OR'd with the call's `fused`
        self.fused_pallas = fused_pallas

    def forward(self, x, padding_mask=None, fused: bool = False,
                generator: Optional[torch.Generator] = None, any_length: bool = False):
        """padding_mask: (B, T) bool, True on PAD positions. `fused` applies
        in eval mode only."""
        fused = (fused or self.fused_pallas) and not self.training
        keep = None if padding_mask is None else (~padding_mask)[:, :, None].to(x.dtype)
        for block in self.convnext:
            x = block(x, fused=fused, generator=generator, any_length=any_length)
            if keep is not None:
                x = x * keep
        return self.final_layer_norm(x)
