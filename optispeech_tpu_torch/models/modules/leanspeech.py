"""LeanSpeech backbone: parallel LSTM (tanh) and ConvGLU branches.

Port of `optispeech_tpu/models/modules/leanspeech.py`. (B, T, C) in and
out. Submodule names follow the reference's torch keys
(`encoder.layers.{i}.lstm.weight_ih_l0`, `.conv.conv.0.depthwise_conv.weight`,
`.conv.conv.1.weight`, `.final_layer_norm.weight`).

The LSTM is `torch.nn.LSTM` (one layer, batch first; cuDNN on the card):
in JAX it is `nn.RNN(nn.OptimizedLSTMCell)`, a `lax.scan`, not a Pallas
kernel. Like JAX's it runs over the whole padded sequence from a zero
state, with no sequence lengths, so the sequence is not packed. Gates in
flax's (and torch's) order i, f, g, o; flax's single bias per gate is
`bias_hh_l0`, and `bias_ih_l0` stays zero (`FlaxLSTM`; a reference
checkpoint's two biases are summed on import, `compat/torch_import.py`).
flax's cell has no compute dtype of its own: its float32 parameters
promote a bfloat16 input, so in bf16 the LSTM runs in float32 here too.
"""

from typing import Optional

import torch
from torch import nn

from .convnext import drop_path
from .core import ConvSeparable, LayerNorm, conv_btc, glu, keep_mask


class FlaxLSTM(nn.LSTM):
    """One batch-first `nn.LSTM` layer with flax's one bias per gate: torch's
    `bias_ih_l0` is a zero buffer (kept in the state dict under the
    reference's key, neither trained nor counted among the parameters), so
    that training moves one bias, `bias_hh_l0`, as optax moves flax's."""

    def __init__(self, dim: int):
        super().__init__(dim, dim, batch_first=True)
        zero = torch.zeros_like(self.bias_ih_l0.data)
        del self._parameters["bias_ih_l0"]
        self.register_buffer("bias_ih_l0", zero)
        self._init_flat_weights()


class ConvGLU(nn.Module):
    """x + GLU(LN(sepconv(x)))."""

    def __init__(self, dim: int, kernel_size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        # a Sequential for the reference's keys conv.0 / conv.1
        self.conv = nn.Sequential(ConvSeparable(dim, 2 * dim, kernel_size, dtype=dtype),
                                  LayerNorm(2 * dim, 1e-12, dtype))

    def forward(self, x):
        return x + glu(self.conv[1](conv_btc(self.conv[0], x)))


class LeanSpeechBlock(nn.Module):
    def __init__(self, dim: int, kernel_size: int, drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.lstm = FlaxLSTM(dim)
        self.conv = ConvGLU(dim, kernel_size, dtype)
        self.final_layer_norm = LayerNorm(dim, 1e-5, dtype)

    def forward(self, x, padding_mask=None, generator: Optional[torch.Generator] = None):
        lx = torch.tanh(self.lstm(x.float())[0])
        cx = keep_mask(self.conv(x), padding_mask)
        h = self.final_layer_norm(lx + cx)
        if self.training and self.drop_path_rate > 0.0:
            if generator is None:
                raise ValueError("drop path in training needs a torch.Generator")
            h = drop_path(h, self.drop_path_rate, generator)
        return x + h


class LeanSpeechBackbone(nn.Module):
    """Blocks whose drop-path rate ramps linearly from 0 to `drop_path`."""

    def __init__(self, dim: int, kernel_size: int = 9, num_layers: int = 4,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        if num_layers > 1:
            rates = [drop_path * i / (num_layers - 1) for i in range(num_layers)]
        else:
            rates = [0.0]
        self.layers = nn.ModuleList([LeanSpeechBlock(dim, kernel_size, r, dtype) for r in rates])

    def forward(self, x, padding_mask=None, generator: Optional[torch.Generator] = None):
        for layer in self.layers:
            x = layer(x, padding_mask, generator)
        return x
