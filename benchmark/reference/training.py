"""Plain PyTorch reference of OptiSpeech's GAN training step, float32.

A frozen, standalone copy of the equations of one step at the flagship's
configuration (ConvNeXt encoder and decoder, WaveNeXt, the Vocos critics):
- the generator's training forward: text embedding, encoder, the JETS
  aligner with its beta-binomial prior, monotonic alignment search (a
  dynamic program over frames and its backtrace), the forward-sum and bin
  losses, the teacher-forced predictors, Gaussian upsampling, the decoder,
  the vocoder on the segment starting at the batch's `start_idx`;
- the multi-period and multi-resolution critics (weight-normed conv2d
  stacks over period views and rectangular-window STFT magnitudes), hinge,
  feature-matching, mel L1 and multi-resolution STFT losses;
- the update: gradients of G's loss with respect to G alone, then of D's
  loss on the detached waveforms, each clipped to a global norm and applied
  by AdamW at the cosine-with-warmup rate.

Dropout and drop path draw from the caller's `torch.Generator`, in the
order the step's modules use them, so that a generator seeded alike draws
the same masks. It imports nothing of the program under test; the module
and parameter names equal the program's, so one state dict loads into both.
Callers run it with TF32 off (`harness.common.reference_mode`).
"""

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.nn.utils import parametrizations, parametrize

from .generator import conv_btc, gaussian_upsample, sequence_mask

BIG_NEG = -1e9
LRELU_SLOPE = 0.1


# ---- randomness, drawn as the step draws it ---------------------------------
def dropout(x, rate, rng):
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def drop_path(x, rate, rng):
    keep = 1.0 - rate
    mask = (torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), generator=rng,
                       device=x.device) < keep).to(x.dtype)
    return x * (mask / keep if keep > 0.0 else mask)


# ---- the generator in training ----------------------------------------------
def convnext_train(backbone, x, pad, rng, drop_max):
    n = len(backbone.convnext)
    rates = [drop_max * i / (n - 1) for i in range(n)] if n > 1 else [0.0]
    keep = None if pad is None else (~pad)[:, :, None].float()
    for block, rate in zip(backbone.convnext, rates):
        h = block.pwconv2(F.gelu(block.pwconv1(block.norm(conv_btc(block.dwconv, x)))))
        h = block.gamma * h
        if rate > 0.0:
            h = drop_path(h, rate, rng)
        x = x + h
        if keep is not None:
            x = x * keep
    return backbone.final_layer_norm(x)


def variance_train(vp, x, pad, rate, rng):
    for conv, relu, norm in vp.conv:
        x = dropout(norm(relu(conv_btc(conv, x))), rate, rng)
    return vp.linear(x)[..., 0].masked_fill(pad, 0.0)


def value_train(vp, x, pad, target, cfg, rng):
    preds = variance_train(vp.predictor, x, pad, cfg["dropout"], rng)
    emb = dropout(vp.embed[0](target[:, None, :]).transpose(1, 2), cfg["embed_dropout"], rng)
    return (x + emb) * (~pad)[..., None].float(), preds


def beta_binomial_log_prior(text_lengths, feats_lengths, t_text, t_feats):
    dev = text_lengths.device
    n = text_lengths.float()[:, None, None]
    tf = feats_lengths.float()[:, None, None]
    t = torch.arange(t_feats, dtype=torch.float32, device=dev)[None, :, None]
    k = torch.arange(t_text, dtype=torch.float32, device=dev)[None, None, :]
    a, b = t + 1.0, tf - (t + 1.0) + 1.0
    valid = (t < tf) & (k < n)
    a = torch.where(valid, a, 1.0)
    b = torch.where(valid, torch.clamp(b, min=1e-3), 1.0)
    k = torch.where(valid, k, 0.0)
    n = torch.clamp(n, min=1.0)
    betaln = lambda x, y: torch.lgamma(x) + torch.lgamma(y) - torch.lgamma(x + y)  # noqa: E731
    logpmf = (torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0) - torch.lgamma(n - k + 1.0)
              + betaln(k + a, n - k + b) - betaln(a, b))
    return torch.where(valid, logpmf, BIG_NEG)


def align(am, text, feats, text_lengths, feats_lengths, pad):
    """(B, T_feats, T_text) log attention probabilities plus the log prior."""
    t = conv_btc(am.t_conv2, F.relu(conv_btc(am.t_conv1, text)))
    f = F.relu(conv_btc(am.f_conv1, feats))
    f = conv_btc(am.f_conv3, F.relu(conv_btc(am.f_conv2, f)))
    dist = torch.clamp((f * f).sum(-1)[:, :, None] + (t * t).sum(-1)[:, None, :]
                       - 2.0 * torch.einsum("bfc,btc->bft", f, t), min=0.0)
    score = (-torch.sqrt(dist + 1e-12)).masked_fill(pad[:, None, :], BIG_NEG)
    return F.log_softmax(score, dim=-1) + beta_binomial_log_prior(
        text_lengths, feats_lengths, text.shape[1], feats.shape[1])


def monotonic_alignment(log_p, text_lengths, feats_lengths):
    """Viterbi over frames (the best monotonic path that starts at the
    first token and ends at the last valid one; ties go to the earlier
    token), its durations and the bin loss -mean_b(sum of the path's log
    probabilities / frames), whose gradient reaches log_p."""
    b, t_feats, t_text = log_p.shape
    tl = text_lengths.long().clamp(1, t_text)
    fl = feats_lengths.long().clamp(1, t_feats)
    frame_valid = torch.arange(t_feats, device=log_p.device)[None, :] < fl[:, None]
    token_valid = torch.arange(t_text, device=log_p.device)[None, :] < tl[:, None]
    lp = torch.where(frame_valid[:, :, None] & token_valid[:, None, :], log_p,
                     torch.full_like(log_p, BIG_NEG))
    dp = lp.detach()
    neg = torch.full((b, 1), BIG_NEG, device=lp.device)
    q = torch.cat([dp[:, 0, :1], neg.expand(b, t_text - 1)], dim=1)
    rows = [q]
    for j in range(1, t_feats):
        q = torch.maximum(q, torch.cat([neg, q[:, :-1]], dim=1)) + dp[:, j]
        rows.append(q)
    table = torch.stack(rows, dim=1)
    a = tl - 1
    path = [a]
    for j in range(t_feats - 2, -1, -1):
        q_j = table[:, j]
        prev = (a - 1).clamp(min=0)
        take = (a == 0) | (q_j.gather(1, prev[:, None])[:, 0] >= q_j.gather(1, a[:, None])[:, 0])
        a = torch.where(j >= fl - 1, tl - 1, torch.where(take, prev, a))
        path.append(a)
    path = torch.stack(path[::-1], dim=1)
    durations = torch.zeros((b, t_text), device=lp.device).scatter_add_(
        1, path, frame_valid.float())
    picked = lp.gather(2, path[:, :, None])[:, :, 0]
    bin_loss = (-torch.where(frame_valid, picked, 0.0).sum(1) / fl.float()).mean()
    return durations, bin_loss


def forward_sum_loss(log_p, text_lengths, feats_lengths):
    b, t_feats, t_text = log_p.shape
    blank = torch.full((b, t_feats, 1), -1.0, device=log_p.device)  # log(e^-1)
    lp = torch.cat([blank, log_p], dim=2)
    labels = torch.arange(t_text + 1, device=lp.device)
    valid = labels[None, None, :] <= text_lengths[:, None, None]
    lp = F.log_softmax(torch.where(valid, lp, BIG_NEG), dim=-1)
    return F.ctc_loss(lp.transpose(0, 1), labels[1:].expand(b, t_text), feats_lengths.long(),
                      text_lengths.long(), blank=0, reduction="mean", zero_infinity=True)


def average_by_duration(durations, xs, text_lengths, feats_lengths):
    t_text, t_feats = durations.shape[1], xs.shape[1]
    frame_valid = sequence_mask(feats_lengths, t_feats)
    xs = torch.where(frame_valid, xs, 0.0).float()
    token_valid = sequence_mask(text_lengths, t_text)
    dur = torch.where(token_valid, durations, 0).float()
    cs = torch.cumsum(dur, dim=1)
    t = torch.arange(t_feats, dtype=torch.float32, device=dur.device)[None, :, None]
    m = (((cs - dur)[:, None, :] <= t) & (cs[:, None, :] > t) & frame_valid[:, :, None]).float()
    avg = torch.einsum("bft,bf->bt", m, xs) / torch.clamp(m.sum(1), min=1.0)
    return torch.where(token_valid & (m.sum(1) > 0), avg, 0.0)


def get_segments(x, starts, size):
    idx = torch.clamp(starts.long()[:, None] + torch.arange(size, device=x.device)[None, :],
                      0, x.shape[-1] - 1)
    return torch.gather(x, 2, idx[:, None, :].expand(-1, x.shape[1], -1))


def _masked_mean(v, mask):
    return torch.where(mask, v, 0.0).sum() / torch.clamp(mask.float().sum(), min=1.0)


def _smooth_l1(a, b):
    d = torch.abs(a - b)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def generator_forward(gen, g, batch, rng):
    """G's training forward: the waveform segment, the acoustic loss and the
    alignment's durations."""
    x, xl, mel, ml = batch["x"], batch["x_lengths"], batch["mel"].float(), batch["mel_lengths"]
    t_text, t_mel = x.shape[1], mel.shape[-1]
    x_mask, mel_mask = sequence_mask(xl, t_text), sequence_mask(ml, t_mel)
    ipad = ~x_mask
    h = dropout(gen.text_embedding(x), g["text_embedding"]["dropout"], rng)
    h = convnext_train(gen.encoder, h, ipad, rng, g["encoder"]["drop_path"])
    log_p = align(gen.alignment_module, h, mel.transpose(1, 2), xl, ml, ipad)
    durations, bin_loss = monotonic_alignment(log_p, xl, ml)
    d_hat = variance_train(gen.duration_predictor, h.detach(), ipad,
                           g["duration_predictor"]["dropout"], rng)
    p_tok = average_by_duration(durations, batch["pitches"], xl, ml)
    e_tok = average_by_duration(durations, batch["energies"], xl, ml)
    h, p_hat = value_train(gen.pitch_predictor, h, ipad, p_tok, g["pitch_predictor"], rng)
    h, e_hat = value_train(gen.energy_predictor, h, ipad, e_tok, g["energy_predictor"], rng)
    y = gaussian_upsample(h, durations, mel_mask, x_mask)
    y = convnext_train(gen.decoder, y, ~mel_mask, rng, g["decoder"]["drop_path"])
    size = min(g["segment_size"], t_mel)
    seg = get_segments(y.transpose(1, 2), batch["start_idx"], size).transpose(1, 2)
    if g["detach_vocoder_input"]:
        seg = seg.detach()
    v = gen.vocoder
    z = v.norm(conv_btc(v.embed, seg))
    wav_hat = v.head(convnext_train(v.backbone, z, None, rng, g["vocoder"]["drop_path"]))

    d_loss = _masked_mean((d_hat - torch.log(durations + 1e-8)) ** 2, x_mask)
    p_loss = _masked_mean(_smooth_l1(p_hat, p_tok), x_mask)
    e_loss = _masked_mean(_smooth_l1(e_hat, e_tok), x_mask)
    align_loss = forward_sum_loss(log_p, xl, ml) + bin_loss
    lc = g["loss_coeffs"]
    loss = (align_loss * lc["lambda_align"] + d_loss * lc["lambda_duration"]
            + p_loss * lc["lambda_pitch"] + e_loss * lc["lambda_energy"])
    return wav_hat, loss, durations


# ---- the critics ------------------------------------------------------------
def stft_magnitude(x, n_fft, hop, win_length, window):
    """Centred (reflect-padded) onesided STFT magnitude, (B, frames, bins)."""
    if window == "ones":
        win = np.ones(win_length, np.float32)
    else:
        n = win_length + 1
        win = (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1)))[:win_length]
    lpad = (n_fft - win_length) // 2
    win = np.pad(win.astype(np.float32), (lpad, n_fft - win_length - lpad))
    x = F.pad(x[:, None, :], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop) * torch.as_tensor(win, device=x.device)
    k, n = np.arange(n_fft // 2 + 1), np.arange(n_fft)
    ang = -2.0 * np.pi * np.outer(n, k) / n_fft
    re = frames @ torch.as_tensor(np.cos(ang).astype(np.float32), device=x.device)
    im = frames @ torch.as_tensor(np.sin(ang).astype(np.float32), device=x.device)
    return torch.sqrt(torch.clamp(re * re + im * im, min=1e-14))


def htk_mel_filterbank(sr, n_fft, n_mels, f_min, f_max):
    hz2mel = lambda f: 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)  # noqa: E731
    mel2hz = lambda m: 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)  # noqa: E731
    fft = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    hz = mel2hz(np.linspace(hz2mel(f_min), hz2mel(f_max), n_mels + 2))
    ramps = hz[:, None] - fft[None, :]
    fd = np.diff(hz)
    return np.maximum(0.0, np.minimum(-ramps[:-2] / fd[:-1, None],
                                      ramps[2:] / fd[1:, None])).astype(np.float32)


def _leaky_relu(x):
    return torch.where(x >= 0, x, x * LRELU_SLOPE)


def _wn_conv(i, o, k, s, p):
    return parametrizations.weight_norm(nn.Conv2d(i, o, k, s, p), dim=0)


class DiscriminatorP(nn.Module):
    def __init__(self, period):
        super().__init__()
        self.period = period
        ch = [1, 32, 128, 512, 1024]
        self.convs = nn.ModuleList([_wn_conv(ch[i], ch[i + 1], (5, 1), (3, 1), (2, 0))
                                    for i in range(4)] + [_wn_conv(1024, 1024, (5, 1), 1, (2, 0))])
        self.conv_post = _wn_conv(1024, 1, (3, 1), 1, (1, 0))

    def forward(self, x):
        b, t = x.shape
        if t % self.period:
            pad = self.period - t % self.period
            x = F.pad(x[:, None, :], (0, pad), mode="reflect")[:, 0]
            t += pad
        x = x.reshape(b, 1, t // self.period, self.period)
        fmap = []
        for i, conv in enumerate(self.convs):
            x = _leaky_relu(conv(x))
            if i > 0:
                fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


class DiscriminatorR(nn.Module):
    def __init__(self, resolution, channels):
        super().__init__()
        self.resolution = tuple(resolution)
        specs = [((7, 5), (2, 2), (3, 2)), ((5, 3), (2, 1), (2, 1)), ((5, 3), (2, 2), (2, 1)),
                 ((3, 3), (2, 1), (1, 1)), ((3, 3), (2, 2), (1, 1))]
        self.convs = nn.ModuleList([_wn_conv(1 if i == 0 else channels, channels, k, s, p)
                                    for i, (k, s, p) in enumerate(specs)])
        self.conv_post = _wn_conv(channels, 1, (3, 3), 1, (1, 1))

    def forward(self, x):
        n_fft, hop, win = self.resolution
        x = stft_magnitude(x, n_fft, hop, win, "ones").transpose(1, 2)[:, None]
        fmap = []
        for conv in self.convs:
            x = _leaky_relu(conv(x))
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap


class Family(nn.Module):
    def __init__(self, discriminators):
        super().__init__()
        self.discriminators = nn.ModuleList(discriminators)

    def forward(self, y, y_hat):
        outs = [(d(y), d(y_hat)) for d in self.discriminators]
        return ([r[0] for r, _ in outs], [g[0] for _, g in outs],
                [r[1] for r, _ in outs], [g[1] for _, g in outs])


class Discriminator(nn.Module):
    """MPD + MRD and the three losses' entry points, from the configuration's
    `discriminator` block and the generator's `features`."""

    def __init__(self, d, features):
        super().__init__()
        self.d, self.features = d, features
        self.multiperioddisc = Family([DiscriminatorP(p) for p in d["periods"]])
        self.multiresddisc = Family([DiscriminatorR(r, d["mrd_channels"])
                                     for r in d["resolutions"]])

    def forward_disc(self, wav, wav_hat):
        loss = 0.0
        for fam, lam in ((self.multiperioddisc, 1.0),
                         (self.multiresddisc, self.d["loss_coeffs"]["lambda_mrd"])):
            real, gen, _, _ = fam(wav, wav_hat)
            part = sum(torch.clamp(1.0 - r, min=0.0).mean() + torch.clamp(1.0 + g, min=0.0).mean()
                       for r, g in zip(real, gen))
            loss = loss + lam * part / len(real)
        return loss

    def forward_gen(self, wav, wav_hat):
        lam_mrd = self.d["loss_coeffs"]["lambda_mrd"]
        loss = 0.0
        for fam, lam in ((self.multiperioddisc, 1.0), (self.multiresddisc, lam_mrd)):
            _, gen, fr, fg = fam(wav, wav_hat)
            adv = sum(torch.clamp(1.0 - g, min=0.0).mean() for g in gen) / len(gen)
            fm = sum(torch.abs(r - g).mean() for dr, dg in zip(fr, fg)
                     for r, g in zip(dr, dg)) / len(fr)
            loss = loss + lam * (adv + fm)
        f = self.features
        fb = torch.as_tensor(htk_mel_filterbank(f["sample_rate"], f["n_fft"], f["n_feats"],
                                                f["f_min"], f["f_max"]), device=wav.device)
        logmel = lambda w: torch.log(torch.clamp(  # noqa: E731
            stft_magnitude(w, f["n_fft"], f["hop_length"], f["win_length"], "hann") @ fb.T,
            min=1e-7))
        mel = torch.abs(logmel(wav) - logmel(wav_hat)).mean()
        sc = mag = 0.0
        for n_fft, hop, win in ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240)):
            xm = torch.clamp(stft_magnitude(wav_hat, n_fft, hop, win, "hann"), min=math.sqrt(1e-7))
            ym = torch.clamp(stft_magnitude(wav, n_fft, hop, win, "hann"), min=math.sqrt(1e-7))
            mag = mag + torch.abs(torch.log(ym) - torch.log(xm)).mean()
            sc = sc + torch.linalg.vector_norm(ym - xm) / torch.linalg.vector_norm(ym)
        lc = self.d["loss_coeffs"]
        return loss + lc["lambda_mel"] * mel + lc["lambda_mr_stft"] * (sc + mag) / 3


def weight_normed(module):
    return [m for m in module.modules() if parametrize.is_parametrized(m, "weight")]


# ---- the update ---------------------------------------------------------------
def cosine_with_warmup(base_lr, warmup, total):
    def schedule(step):
        f = np.float32
        s = f(step)
        if s < warmup:
            return float(f(base_lr) * ((s + f(1.0)) / f(max(warmup, 1))))
        progress = (s - f(warmup)) / f(max(total - warmup, 1))
        return float(f(base_lr) * max(f(0.0), f(0.5) * (f(1.0) + np.cos(f(np.pi) * progress))))

    return schedule


class Optimizer:
    """Clip to a global norm, then AdamW at the schedule's rate."""

    def __init__(self, params, cfg):
        o, s = cfg["optimizer"], cfg["scheduler"]
        if s["kind"] != "cosine_with_warmup":
            raise ValueError("the reference takes the cosine-with-warmup schedule")
        self.params = list(params)
        self.schedule = cosine_with_warmup(o["lr"], s["num_warmup_steps"],
                                           s["num_training_steps"])
        self.max_norm = cfg["train_args"]["gradient_clip_val"]
        self.adamw = torch.optim.AdamW(self.params, lr=self.schedule(0), betas=tuple(o["betas"]),
                                       eps=o["eps"], weight_decay=o["weight_decay"])
        self.count = 0

    @torch.no_grad()
    def update(self, grads):
        """Returns the clipped gradients, as the update used them."""
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = 1.0 if float(norm) < self.max_norm else self.max_norm / float(norm)
        for p, g in zip(self.params, grads):
            p.grad = g * scale
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        clipped = [p.grad.detach().clone() for p in self.params]
        self.adamw.zero_grad(set_to_none=True)
        self.count += 1
        return clipped


def _grads(loss, params, backward):
    """The gradient of `loss` with respect to `params` alone (by `backward`
    into `.grad` where a caller's hooks cannot follow `autograd.grad`)."""
    if not backward:
        return torch.autograd.grad(loss, params, allow_unused=True)
    for p in params:
        p.grad = None
    loss.backward(inputs=params)
    return [p.grad for p in params]


def train_step(gen, disc, g_opt, d_opt, batch, rng, cfg, backward=False):
    """One GAN step; returns (G's loss, D's loss, G's and D's clipped gradients)."""
    g = cfg["generator"]
    wav_hat, am_loss, _ = generator_forward(gen, g, batch, rng)
    wav = batch["wav_seg"]
    g_loss = am_loss + disc.forward_gen(wav, wav_hat)
    g_grads = g_opt.update(_grads(g_loss, g_opt.params, backward))
    d_loss = disc.forward_disc(wav.detach(), wav_hat.detach())
    d_grads = d_opt.update(_grads(d_loss, d_opt.params, backward))
    return g_loss.detach(), d_loss.detach(), g_grads, d_grads
