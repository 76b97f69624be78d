"""Monotonic alignment search (MAS): the CUDA kernels and their plain twins.

Two contracts, each with its TPU kernel ported to CUDA:

Training: port of `optispeech_tpu/ops/mas.py::viterbi_decode`, with the TPU
kernel `optispeech_tpu/ops/pallas_mas_wavefront.py::viterbi_decode_wavefront`
as a CUDA kernel (`csrc/mas_wavefront.cu`). log_p_attn (B, T_feats, T_text),
lengths (B,) -> (durations (B, T_text) f32 with no gradient, the scalar bin
loss, whose gradient reaches log_p_attn).

- `viterbi_decode` is the wrapper. For a CUDA tensor it launches the kernel
  for the durations or raises, then takes the bin loss outside the kernel
  as the wavefront function does: the path is rebuilt from the durations
  (cumsum + searchsorted) and gathered from the live log-probs.
  `viterbi_decode.launches` counts kernel launches (`captured_launches`
  those into a CUDA graph being captured; `fused_convnext.count_launch`).
  For a CPU tensor it runs the twin.
- `viterbi_decode_reference` is the twin: the JAX scan written as Python
  loops over frames (forward DP over the masked log-probs, backtrace that
  pins the last valid frame to the last token, `>=` breaking ties).

Extraction (no gradient anywhere): port of
`optispeech_tpu/ops/pallas_mas.py::viterbi_decode_pallas` as a CUDA kernel
(`csrc/mas_extract.cu`), for the validation step.

- `viterbi_decode_extract` is the wrapper. For a CUDA tensor it launches the
  kernel, which gives the durations and the per-token bin-loss numerator
  (`binsum`), or raises; `viterbi_decode_extract.launches` counts launches.
  For a CPU tensor it runs the twin. The bin loss is taken outside the
  kernel, `mean_b(-sum_i binsum / fl)`, as `pallas_mas.py:170-177` does.
- `viterbi_decode_extract_reference` is the twin: the scan's path, with the
  numerator summed frame by frame from the last valid frame down, the order
  of the TPU kernel's backtrace.

Lengths are clamped to [1, T] everywhere, as the wavefront kernel clamps
them to at least 1.
"""

import ctypes
import functools

import torch

from . import _build
from .fused_convnext import count_launch

BIG_NEG = -1e9
# the kernels' template instantiations: the contiguous tokens each of the
# warp's 32 lanes holds (csrc/mas_forward.cuh, MAS_TOKENS_PER_LANE)
TOKENS_PER_LANE = (*range(1, 17), 20, 24, 28, 32, 40, 48, 56, 64)


def _lengths(text_lengths, feats_lengths, t_text, t_feats):
    return text_lengths.clamp(1, t_text), feats_lengths.clamp(1, t_feats)


def _reference_path(log_p_attn, text_lengths, feats_lengths):
    """The scan's path: (path (B, T_feats) token per frame, frame_valid,
    masked log-probs lp_m (live), clamped fl)."""
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
    return torch.stack(path[::-1], dim=1), frame_valid, lp_m, fl


def viterbi_decode_reference(log_p_attn, text_lengths, feats_lengths):
    """Plain PyTorch twin of the wavefront kernel: the scan of the JAX function."""
    path, frame_valid, lp_m, fl = _reference_path(log_p_attn, text_lengths, feats_lengths)
    durations = torch.zeros(log_p_attn.shape[::2], device=path.device).scatter_add_(
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


def extract_reference(log_p_attn, text_lengths, feats_lengths):
    """Plain PyTorch twin of the extraction kernel: (durations, binsum), both
    (B, T_text) f32, binsum[i] the log-probs of token i's valid frames added
    from the highest frame down, as the TPU kernel's backtrace adds them."""
    with torch.no_grad():
        path, frame_valid, lp_m, _ = _reference_path(log_p_attn, text_lengths, feats_lengths)
        durations = torch.zeros(log_p_attn.shape[::2], device=path.device).scatter_add_(
            1, path, frame_valid.float())
        picked = torch.where(frame_valid, lp_m.gather(2, path[:, :, None])[:, :, 0], 0.0)
        binsum = torch.zeros_like(durations)
        for j in range(path.shape[1] - 1, -1, -1):  # one add per item a frame
            binsum.scatter_add_(1, path[:, j:j + 1], picked[:, j:j + 1])
    return durations, binsum


def bin_loss_from_binsum(binsum, feats_lengths, t_feats: int):
    """mean_b(-sum_i binsum / fl) (`pallas_mas.py:170-177`), fl clamped to [1, T_feats]."""
    return (-binsum.sum(dim=1) / feats_lengths.clamp(1, t_feats).float()).mean()


def viterbi_decode_extract_reference(log_p_attn, text_lengths, feats_lengths):
    """The twin with the wrapper's contract: (durations, bin loss), no gradient."""
    durations, binsum = extract_reference(log_p_attn, text_lengths, feats_lengths)
    return durations, bin_loss_from_binsum(binsum, feats_lengths, log_p_attn.shape[1])


def tokens_per_lane(t_text: int) -> int:
    """Tokens each of the warp's 32 lanes holds for T_text tokens: the
    smallest instantiated K with 32 K >= T_text."""
    for k in TOKENS_PER_LANE:
        if 32 * k >= t_text:
            return k
    raise ValueError(f"the kernel takes T_text <= {32 * TOKENS_PER_LANE[-1]}, got {t_text}")


def decision_bytes(b: int, t_feats: int, per_lane: int) -> int:
    """Bytes of the kernels' decision scratch: per item ceil(T_feats / FW)
    rows of 32 words, a lane's K bits of FW = 32 // K frames to a 32-bit
    word (one frame to a 64-bit word for K > 32)."""
    frames_per_word, word = (32 // per_lane, 4) if per_lane <= 32 else (1, 8)
    return b * -(-t_feats // frames_per_word) * 32 * word


def _kernel_inputs(log_p_attn, text_lengths, feats_lengths):
    """Checks what both kernels take; returns (lp f32 contiguous, tl, fl
    int32 clamped, tokens per lane, decision scratch)."""
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
    if lp.data_ptr() % 16:  # the kernels copy 16-byte-aligned windows of its rows
        lp = lp.clone()
    tl, fl = _lengths(text_lengths, feats_lengths, t_text, t_feats)
    tl, fl = tl.to(torch.int32).contiguous(), fl.to(torch.int32).contiguous()
    dec = torch.empty(decision_bytes(b, t_feats, per_lane), dtype=torch.uint8, device=device)
    return lp, tl, fl, per_lane, dec


def _launch(name, wrapper, *args):
    """Launch kernel `name` on the current stream of args[0]'s device and
    count it in `wrapper`'s launch counters."""
    device = args[0].device
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(_library(name), f"{name}_launch")(
            *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), stream)
        if err != 0:
            raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")
        count_launch(wrapper, "launches")


def mas_durations(log_p_attn, text_lengths, feats_lengths):
    """The wavefront kernel alone: (B, T_text) f32 durations of a CUDA tensor."""
    lp, tl, fl, per_lane, dec = _kernel_inputs(log_p_attn, text_lengths, feats_lengths)
    b, t_feats, t_text = lp.shape
    durations = torch.empty((b, t_text), dtype=torch.float32, device=lp.device)
    _launch("mas_wavefront", viterbi_decode, lp, tl, fl, durations, dec, b, t_feats, t_text,
            per_lane)
    return durations


def mas_extract(log_p_attn, text_lengths, feats_lengths):
    """The extraction kernel alone: (durations, binsum), both (B, T_text)
    f32, of a CUDA tensor."""
    lp, tl, fl, per_lane, dec = _kernel_inputs(log_p_attn, text_lengths, feats_lengths)
    b, t_feats, t_text = lp.shape
    durations = torch.empty((b, t_text), dtype=torch.float32, device=lp.device)
    binsum = torch.empty_like(durations)
    _launch("mas_extract", viterbi_decode_extract, lp, tl, fl, durations, binsum, dec, b,
            t_feats, t_text, per_lane)
    return durations, binsum


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
viterbi_decode.captured_launches = 0


def viterbi_decode_extract(log_p_attn, text_lengths, feats_lengths):
    """MAS durations and bin loss with no gradient (the validation step's
    duration extraction); the kernel on the card, the twin on the CPU.

    Args and returns as `viterbi_decode`, but neither output has a gradient.
    """
    if log_p_attn.device.type == "cpu":
        return viterbi_decode_extract_reference(log_p_attn, text_lengths, feats_lengths)
    if log_p_attn.device.type != "cuda":
        raise ValueError(f"viterbi_decode_extract: no kernel for device {log_p_attn.device}")
    durations, binsum = mas_extract(log_p_attn, text_lengths, feats_lengths)
    return durations, bin_loss_from_binsum(binsum, feats_lengths, log_p_attn.shape[1])


viterbi_decode_extract.launches = 0
viterbi_decode_extract.captured_launches = 0

# pointers (5 or 6), then batch, T_feats, T_text, tokens per lane, stream
_POINTERS = {"mas_wavefront": 5, "mas_extract": 6}


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * _POINTERS[name] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
