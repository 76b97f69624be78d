"""Beta-binomial alignment prior (port of `optispeech_tpu/ops/prior.py`)."""

import torch

BIG_NEG = -1e9


def _betaln(x, y):
    return torch.lgamma(x) + torch.lgamma(y) - torch.lgamma(x + y)


def beta_binomial_log_prior(text_lengths: torch.Tensor, feats_lengths: torch.Tensor,
                            max_text_len: int, max_feats_len: int,
                            w: float = 1.0) -> torch.Tensor:
    """(B, T_feats, T_text) log prior: BetaBinom(k; n=N, a=w(t+1),
    b=w(T - w(t+1) + 1)) per frame t and token k; BIG_NEG on invalid cells."""
    device = text_lengths.device
    n = text_lengths.float()[:, None, None]
    t_feats = feats_lengths.float()[:, None, None]
    t = torch.arange(max_feats_len, dtype=torch.float32, device=device)[None, :, None]
    k = torch.arange(max_text_len, dtype=torch.float32, device=device)[None, None, :]

    a = w * (t + 1.0)
    b = w * (t_feats - w * (t + 1.0) + 1.0)
    valid = (t < t_feats) & (k < n)
    # clamp the inputs on invalid cells so lgamma stays finite
    a_s = torch.where(valid, a, 1.0)
    b_s = torch.where(valid, torch.clamp(b, min=1e-3), 1.0)
    k_s = torch.where(valid, k, 0.0)
    n_s = torch.clamp(n, min=1.0)

    logpmf = (torch.lgamma(n_s + 1.0) - torch.lgamma(k_s + 1.0) - torch.lgamma(n_s - k_s + 1.0)
              + _betaln(k_s + a_s, n_s - k_s + b_s) - _betaln(a_s, b_s))
    return torch.where(valid, logpmf, BIG_NEG)
