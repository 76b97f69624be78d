"""JETS alignment module: learned text<->mel affinity + beta-binomial prior.

Port of `optispeech_tpu/models/modules/alignment.py`. The squared distance
||f - t||^2 is expanded as ||f||^2 + ||t||^2 - 2 f.t in float32, one batched
product with no (B, T_feats, T_text, C) intermediate, as in JAX (which asks
for `precision="highest"`; the port runs float32 products with TF32 off).
Conv names follow the reference's torch keys (`alignment_module.t_conv1`).
The convs run in the compute dtype (`core.py`), the distance in float32 in
either, so the log-probs that MAS reads are float32.
"""

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.prior import beta_binomial_log_prior
from .core import Conv1d, conv_btc

BIG_NEG = -1e9


class AlignmentModule(nn.Module):
    def __init__(self, adim: int, odim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.t_conv1 = Conv1d(adim, adim, 3, padding=1, dtype=dtype)
        self.t_conv2 = Conv1d(adim, adim, 1, dtype=dtype)
        self.f_conv1 = Conv1d(odim, adim, 3, padding=1, dtype=dtype)
        self.f_conv2 = Conv1d(adim, adim, 3, padding=1, dtype=dtype)
        self.f_conv3 = Conv1d(adim, adim, 1, dtype=dtype)

    def forward(self, text, feats, text_lengths, feats_lengths, x_masks=None):
        """text (B, T_text, adim), feats (B, T_feats, odim), lengths (B,),
        x_masks (B, T_text) bool, True on PAD -> (B, T_feats, T_text) log
        attention probabilities plus the log prior."""
        t = conv_btc(self.t_conv2, F.relu(conv_btc(self.t_conv1, text)))
        f = F.relu(conv_btc(self.f_conv1, feats))
        f = conv_btc(self.f_conv3, F.relu(conv_btc(self.f_conv2, f)))
        f32, t32 = f.float(), t.float()
        f_sq = (f32 * f32).sum(dim=-1)
        t_sq = (t32 * t32).sum(dim=-1)
        cross = torch.einsum("bfc,btc->bft", f32, t32)
        dist_sq = torch.clamp(f_sq[:, :, None] + t_sq[:, None, :] - 2.0 * cross, min=0.0)
        score = -torch.sqrt(dist_sq + 1e-12)
        if x_masks is not None:
            score = score.masked_fill(x_masks[:, None, :], BIG_NEG)
        log_p_attn = F.log_softmax(score, dim=-1)
        return log_p_attn + beta_binomial_log_prior(text_lengths, feats_lengths, text.shape[1],
                                                    feats.shape[1])
