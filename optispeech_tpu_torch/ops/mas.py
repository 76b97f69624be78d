"""Monotonic alignment search (MAS): the CUDA kernel and its plain twin.

Port of `optispeech_tpu/ops/mas.py::viterbi_decode`, with the TPU kernel
`optispeech_tpu/ops/pallas_mas_wavefront.py::viterbi_decode_wavefront` as
a CUDA kernel (`csrc/mas_wavefront.cu`). Same contract as both: log_p_attn
(B, T_feats, T_text), lengths (B,) -> (durations (B, T_text) f32 with no
gradient, the scalar bin loss, whose gradient reaches log_p_attn).

- `viterbi_decode` is the wrapper. For a CUDA tensor it launches the kernel
  for the durations or raises, then takes the bin loss outside the kernel
  as the wavefront function does: the path is rebuilt from the durations
  (cumsum + searchsorted) and gathered from the live log-probs.
  `viterbi_decode.launches` counts kernel launches. For a CPU tensor it runs
  the twin.
- `viterbi_decode_reference` is the twin: the JAX scan written as Python
  loops over frames (forward DP over the masked log-probs, backtrace that
  pins the last valid frame to the last token, `>=` breaking ties).

Lengths are clamped to [1, T] in both, as the wavefront kernel clamps them
to at least 1.
"""

import ctypes
import functools

import torch

from . import _build

BIG_NEG = -1e9
TOKENS_PER_LANE = (1, 2, 4, 8, 16, 32, 64)  # the kernel's template instantiations


def _lengths(text_lengths, feats_lengths, t_text, t_feats):
    return text_lengths.clamp(1, t_text), feats_lengths.clamp(1, t_feats)


def viterbi_decode_reference(log_p_attn, text_lengths, feats_lengths):
    """Plain PyTorch twin of the kernel: the scan of the JAX function."""
    b, t_feats, t_text = log_p_attn.shape
    tl, fl = _lengths(text_lengths.long(), feats_lengths.long(), t_text, t_feats)
    lp = log_p_attn.float()
    frame_valid = torch.arange(t_feats, device=lp.device)[None, :] < fl[:, None]
    token_valid = torch.arange(t_text, device=lp.device)[None, :] < tl[:, None]
    lp_m = torch.where(frame_valid[:, :, None] & token_valid[:, None, :], lp,
                       torch.full_like(lp, BIG_NEG))
    lp_dp = lp_m.detach()

    # forward: Q[j] = max(Q[j-1], shift(Q[j-1])) + lp[j]
    neg = torch.full((b, 1), BIG_NEG, device=lp.device)
    q = torch.cat([lp_dp[:, 0, :1], neg.expand(b, t_text - 1)], dim=1)
    rows = [q]
    for j in range(1, t_feats):
        q = torch.maximum(q, torch.cat([neg, q[:, :-1]], dim=1)) + lp_dp[:, j]
        rows.append(q)
    q_table = torch.stack(rows, dim=1)  # (B, T_feats, T_text)

    # backtrace: A[j] from A[j+1], frames >= fl-1 pinned to token tl-1
    a = tl - 1
    path = [a]
    for j in range(t_feats - 2, -1, -1):
        q_j = q_table[:, j]
        i_a = (a - 1).clamp(min=0)
        take = (a == 0) | (q_j.gather(1, i_a[:, None])[:, 0] >= q_j.gather(1, a[:, None])[:, 0])
        a = torch.where(j >= fl - 1, tl - 1, torch.where(take, i_a, a))
        path.append(a)
    path = torch.stack(path[::-1], dim=1)  # (B, T_feats)

    durations = torch.zeros((b, t_text), device=lp.device).scatter_add_(
        1, path, frame_valid.float())
    picked = lp_m.gather(2, path[:, :, None])[:, :, 0]
    bin_losses = -torch.where(frame_valid, picked, 0.0).sum(dim=1) / fl.float()
    return durations, bin_losses.mean()


def bin_loss_from_durations(log_p_attn, durations, text_lengths, feats_lengths):
    """The bin loss of a MAS path given by its durations, with the gradient
    into log_p_attn (`pallas_mas_wavefront.py:208-219`): frame j sits at
    token #{i : cumsum(durations)[i] <= j}, capped at tl-1, and that
    token's log-prob is gathered from the live tensor."""
    b, t_feats, t_text = log_p_attn.shape
    tl, fl = _lengths(text_lengths.long(), feats_lengths.long(), t_text, t_feats)
    cum = torch.cumsum(durations, dim=1).contiguous()
    frames = torch.arange(t_feats, dtype=cum.dtype, device=cum.device).expand(b, t_feats)
    path = torch.searchsorted(cum, frames.contiguous(), right=True)
    path = torch.minimum(path, (tl - 1)[:, None])
    # frames < fl sit at tokens < tl, where the masked and the raw log-probs agree
    picked = log_p_attn.float().gather(2, path[:, :, None])[:, :, 0]
    frame_valid = torch.arange(t_feats, device=cum.device)[None, :] < fl[:, None]
    bin_losses = -torch.where(frame_valid, picked, 0.0).sum(dim=1) / fl.float()
    return bin_losses.mean()


def tokens_per_lane(t_text: int) -> int:
    """Tokens each of the warp's 32 lanes holds for T_text tokens."""
    for c in TOKENS_PER_LANE:
        if 32 * c >= t_text:
            return c
    raise ValueError(f"the kernel takes T_text <= {32 * TOKENS_PER_LANE[-1]}, got {t_text}")


def mas_durations(log_p_attn, text_lengths, feats_lengths):
    """The kernel alone: (B, T_text) f32 durations of a CUDA tensor."""
    if log_p_attn.dim() != 3 or log_p_attn.shape[0] < 1 or min(log_p_attn.shape[1:]) < 1:
        raise ValueError(f"log_p_attn must be a non-empty (B, T_feats, T_text), "
                         f"got {tuple(log_p_attn.shape)}")
    b, t_feats, t_text = log_p_attn.shape
    device = log_p_attn.device
    for name, lengths in (("text_lengths", text_lengths), ("feats_lengths", feats_lengths)):
        if lengths.shape != (b,) or lengths.device != device:
            raise ValueError(f"{name} must be ({b},) on {device}, "
                             f"got {tuple(lengths.shape)} on {lengths.device}")
    per_lane = tokens_per_lane(t_text)
    lp = log_p_attn.detach().float().contiguous()
    tl, fl = _lengths(text_lengths, feats_lengths, t_text, t_feats)
    tl, fl = tl.to(torch.int32).contiguous(), fl.to(torch.int32).contiguous()
    durations = torch.empty((b, t_text), dtype=torch.float32, device=device)
    dec = torch.empty((b, t_feats, per_lane), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _library().mas_wavefront_launch(
            lp.data_ptr(), tl.data_ptr(), fl.data_ptr(), durations.data_ptr(), dec.data_ptr(),
            b, t_feats, t_text, per_lane, stream)
    if err != 0:
        raise RuntimeError(f"mas_wavefront: kernel launch failed with cudaError {err}")
    viterbi_decode.launches += 1
    return durations


def viterbi_decode(log_p_attn, text_lengths, feats_lengths):
    """MAS durations and bin loss; the kernel on the card, the twin on the CPU.

    Args:
        log_p_attn: (B, T_feats, T_text) log attention probabilities.
        text_lengths, feats_lengths: (B,) ints on the same device.

    Returns (durations (B, T_text) f32, detached; bin loss scalar).
    """
    if log_p_attn.device.type == "cpu":
        return viterbi_decode_reference(log_p_attn, text_lengths, feats_lengths)
    if log_p_attn.device.type != "cuda":
        raise ValueError(f"viterbi_decode: no kernel for device {log_p_attn.device}")
    durations = mas_durations(log_p_attn, text_lengths, feats_lengths)
    return durations, bin_loss_from_durations(log_p_attn, durations, text_lengths, feats_lengths)


viterbi_decode.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("mas_wavefront")
    fn = lib.mas_wavefront_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
