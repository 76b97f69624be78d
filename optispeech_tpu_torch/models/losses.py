"""Acoustic-model losses (port of `optispeech_tpu/models/losses.py`):
duration MSE in the log domain (clip 1e-8), pitch and energy smooth L1,
means over the valid tokens. The forward-sum loss is in ops/ctc.py."""

import torch

from ..ops.masking import sequence_mask


def _masked_mean(values, mask):
    total = torch.where(mask, values, 0.0).sum()
    return total / torch.clamp(mask.float().sum(), min=1.0)


def smooth_l1(pred, target, beta: float = 1.0):
    """torch.nn.SmoothL1Loss elementwise."""
    diff = torch.abs(pred - target)
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def duration_loss(d_pred_log, d_target, token_mask, clip_val: float = 1e-8):
    """MSE between predicted log-durations and log(target + clip)."""
    target_log = torch.log(d_target.float() + clip_val)
    return _masked_mean((d_pred_log.float() - target_log) ** 2, token_mask)


def fastspeech2_loss(d_outs, p_outs, e_outs, ds, ps, es, ilens, max_text_len: int):
    """(duration_loss, pitch_loss, energy_loss), masked means over the valid
    tokens (FastSpeech2Loss with use_masking=True and the L1 regression the
    generator uses)."""
    mask = sequence_mask(ilens, max_text_len)
    d_l = duration_loss(d_outs, ds, mask)
    p_l = _masked_mean(smooth_l1(p_outs.float(), ps.float()), mask)
    e_l = _masked_mean(smooth_l1(e_outs.float(), es.float()), mask)
    return d_l, p_l, e_l
