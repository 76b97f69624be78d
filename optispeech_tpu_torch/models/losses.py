"""Acoustic-model losses (port of `optispeech_tpu/models/losses.py`):
duration MSE in the log domain (clip 1e-8), pitch and energy smooth L1,
means over the valid tokens. The forward-sum loss is in ops/ctc.py.

Under data parallelism (`mesh`, `parallel/mesh.py`) each rank's loss is
its share of the global batch's: its masked sum over the token count of
every rank's shard (one all-reduce of a device tensor, no host sync), so
that the shares, and their gradients, sum to the global batch's."""

import torch

from ..ops.masking import sequence_mask
from ..parallel.mesh import all_reduce_sum, data_size


def token_count(mask, mesh=None):
    """The valid tokens of `mask`, summed over the data-parallel ranks when
    there is a mesh: the denominator of the masked means."""
    count = mask.float().sum()
    if data_size(mesh) > 1:
        count = all_reduce_sum(count.detach().clone(), mesh)
    return count


def _masked_mean(values, mask, count=None):
    total = torch.where(mask, values, 0.0).sum()
    count = mask.float().sum() if count is None else count
    return total / torch.clamp(count, min=1.0)


def smooth_l1(pred, target, beta: float = 1.0):
    """torch.nn.SmoothL1Loss elementwise."""
    diff = torch.abs(pred - target)
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def duration_loss(d_pred_log, d_target, token_mask, clip_val: float = 1e-8, count=None):
    """MSE between predicted log-durations and log(target + clip); `count`
    is the denominator (default: the tokens of `token_mask`)."""
    target_log = torch.log(d_target.float() + clip_val)
    return _masked_mean((d_pred_log.float() - target_log) ** 2, token_mask, count)


def fastspeech2_loss(d_outs, p_outs, e_outs, ds, ps, es, ilens, max_text_len: int, mesh=None):
    """(duration_loss, pitch_loss, energy_loss), masked means over the valid
    tokens (FastSpeech2Loss with use_masking=True and the L1 regression the
    generator uses); with a `mesh`, over the valid tokens of every rank."""
    mask = sequence_mask(ilens, max_text_len)
    count = token_count(mask, mesh)
    d_l = duration_loss(d_outs, ds, mask, count=count)
    p_l = _masked_mean(smooth_l1(p_outs.float(), ps.float()), mask, count)
    e_l = _masked_mean(smooth_l1(e_outs.float(), es.float()), mask, count)
    return d_l, p_l, e_l
