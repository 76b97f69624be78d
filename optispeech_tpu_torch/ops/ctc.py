"""Forward-sum (CTC) alignment loss (port of `optispeech_tpu/ops/ctc.py`).

The reference's semantics, batched in one `F.ctc_loss` call: a blank column
of probability e^-1 is prepended, log_softmax runs over the labels
0..text_length of each frame (the others are masked), the targets are
1..N, each item's loss is divided by its target length and the batch is
averaged (`reduction="mean"`), and infeasible items count 0
(`zero_infinity=True`).
"""

import math

import torch
from torch.nn import functional as F

BIG_NEG = -1e9


def forward_sum_loss(log_p_attn: torch.Tensor, text_lengths: torch.Tensor,
                     feats_lengths: torch.Tensor, blank_prob: float = math.exp(-1)) -> torch.Tensor:
    """log_p_attn (B, T_feats, T_text), lengths (B,) -> scalar."""
    b, t_feats, t_text = log_p_attn.shape
    lp = log_p_attn.float()
    blank = torch.full((b, t_feats, 1), math.log(blank_prob), device=lp.device)
    lp = torch.cat([blank, lp], dim=2)
    labels = torch.arange(t_text + 1, device=lp.device)
    label_valid = labels[None, None, :] <= text_lengths[:, None, None]
    lp = F.log_softmax(torch.where(label_valid, lp, BIG_NEG), dim=-1)
    targets = labels[1:].expand(b, t_text)
    return F.ctc_loss(lp.transpose(0, 1), targets, feats_lengths.long(), text_lengths.long(),
                      blank=0, reduction="mean", zero_infinity=True)
