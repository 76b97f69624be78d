"""Plain PyTorch reference of OptiSpeech's synthesis path, float32 only.

A frozen, standalone copy of the generator's inference equations: the text
embedding, the ConvNeXt or Conformer encoder and decoder, the duration,
pitch and energy predictors, Gaussian upsampling and the WaveNeXt vocoder.
It imports nothing of the program under test and runs no kernel of it: every
block is plain `torch` operations (the ConvNeXt block unfused, attention as
explicit products and softmax). Module and parameter names equal the
program's, so one state dict loads into both.

Callers run it with TF32 off (`harness.precision.reference_mode`), so every
product and convolution is a float32 one.

Supported: `dim`-wide ConvNeXt and Conformer backbones (`conv_norm:
layernorm`), non-separable predictors, one speaker and one language, no f0
conditioning of the vocoder. Anything else raises.
"""

import math

import torch
from torch import nn
from torch.nn import functional as F

NEG_INF = -1e9


def sequence_mask(lengths, max_length):
    """(B, T) bool, True on valid positions."""
    pos = torch.arange(max_length, dtype=lengths.dtype, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def conv_btc(conv, x):
    return conv(x.transpose(1, 2)).transpose(1, 2)


def gaussian_upsample(hs, ds, h_masks, d_masks, delta=0.1):
    """Token states (B, Tt, C) to frames (B, Tf, C) by a Gaussian of fixed
    temperature around each token's centre; padded frames sit at position 0."""
    t_feats = h_masks.shape[-1]
    ds = ds.float()
    t = torch.arange(t_feats, dtype=torch.float32, device=hs.device)[None, :] * h_masks.float()
    c = torch.cumsum(ds, dim=-1) - ds / 2
    energy = -delta * (t[:, :, None] - c[:, None, :]) ** 2
    energy = torch.where(d_masks[:, None, :], energy, torch.full_like(energy, NEG_INF))
    p = torch.exp(energy - energy.max(dim=2, keepdim=True).values)
    p = p / p.sum(dim=2, keepdim=True)
    return torch.matmul(p, hs)


class ScaledSinusoidalEmbedding(nn.Module):
    def __init__(self, dim, theta):
        super().__init__()
        self.dim, self.theta = dim, theta
        self.scale = nn.Parameter(torch.full((1,), dim ** -0.5))

    def forward(self, seq_len):
        half = self.dim // 2
        dev = self.scale.device
        freq = torch.arange(half, dtype=torch.float32, device=dev) / half
        inv = torch.pow(torch.tensor(self.theta, dtype=torch.float32, device=dev), -freq)
        emb = torch.arange(seq_len, dtype=torch.float32, device=dev)[:, None] * inv[None, :]
        return torch.cat([emb.sin(), emb.cos()], dim=-1) * self.scale


class TextEmbedding(nn.Module):
    def __init__(self, dim, n_vocab, padding_idx, max_source_positions):
        super().__init__()
        self.dim, self.padding_idx = dim, padding_idx
        self.embed_tokens = nn.Embedding(n_vocab, dim)
        self.embed_positions = ScaledSinusoidalEmbedding(dim, max_source_positions)

    def forward(self, tokens):
        emb = self.embed_tokens(tokens) * (tokens != self.padding_idx)[..., None].float()
        return math.sqrt(self.dim) * emb + self.embed_positions(tokens.shape[1])[None]


class ConvNeXtBlock(nn.Module):
    """dwconv k7 -> LayerNorm -> Linear C->I -> exact GELU -> Linear I->C ->
    layer scale -> residual."""

    def __init__(self, dim, inter, scale):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, inter)
        self.pwconv2 = nn.Linear(inter, dim)
        self.gamma = nn.Parameter(torch.full((dim,), float(scale)))

    def forward(self, x):
        h = self.pwconv2(F.gelu(self.pwconv1(self.norm(conv_btc(self.dwconv, x)))))
        return x + self.gamma * h


class ConvNeXtBackbone(nn.Module):
    def __init__(self, dim, inter, num_layers, layer_scale=None):
        super().__init__()
        scale = layer_scale or 1.0 / num_layers
        self.convnext = nn.ModuleList([ConvNeXtBlock(dim, inter, scale)
                                       for _ in range(num_layers)])
        self.final_layer_norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, padding_mask):
        keep = (~padding_mask)[:, :, None].float()
        for block in self.convnext:
            x = block(x) * keep
        return self.final_layer_norm(x)


def sinusoids(pos, dim):
    """sin / cos of float64 positions interleaved over dim, rounded to float32."""
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float64, device=pos.device)
                    * -(math.log(10000.0) / dim))
    ang = pos[:, None] * div[None, :]
    return torch.stack([ang.sin(), ang.cos()], dim=-1).reshape(len(pos), dim).float()


class ConvFFN(nn.Module):
    def __init__(self, dim, units):
        super().__init__()
        self.w_1 = nn.Conv1d(dim, units, 1)
        self.w_2 = nn.Conv1d(units, dim, 1)

    def forward(self, x):
        return conv_btc(self.w_2, torch.relu(conv_btc(self.w_1, x)))


class RelPosSelfAttention(nn.Module):
    """Transformer-XL relative-position attention with pos_bias_u / _v."""

    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        d_k = dim // heads
        self.linear_q = nn.Linear(dim, dim)
        self.linear_k = nn.Linear(dim, dim)
        self.linear_v = nn.Linear(dim, dim)
        self.linear_out = nn.Linear(dim, dim)
        self.linear_pos = nn.Linear(dim, dim, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(heads, d_k))
        self.pos_bias_v = nn.Parameter(torch.zeros(heads, d_k))

    def forward(self, x, pos_emb, padding_mask):
        b, t, _ = x.shape
        h = self.heads
        q, k, v = (lin(x).reshape(b, t, h, -1)
                   for lin in (self.linear_q, self.linear_k, self.linear_v))
        d_k = q.shape[-1]
        p = self.linear_pos(pos_emb).reshape(2 * t - 1, h, d_k).permute(1, 2, 0)
        q_u = (q + self.pos_bias_u).transpose(1, 2)
        q_v = (q + self.pos_bias_v).transpose(1, 2)
        bd = q_v @ p  # (B, H, T, 2T-1) over positions t-1 .. -(t-1)
        # out[q, k] = bd[q, t-1 - (q-k)]: the relative shift
        bd = F.pad(bd, (1, 0)).reshape(b, h, 2 * t, t)[:, :, 1:, :]
        bd = bd.reshape(b, h, t, 2 * t - 1)[..., :t]
        scores = (q_u @ k.transpose(1, 2).transpose(-1, -2) + bd) / math.sqrt(d_k)
        scores = scores.masked_fill(padding_mask[:, None, None, :], NEG_INF)
        out = torch.softmax(scores, dim=-1) @ v.transpose(1, 2)
        return self.linear_out(out.transpose(1, 2).reshape(b, t, h * d_k))


class ConvModule(nn.Module):
    def __init__(self, dim, kernel):
        super().__init__()
        self.pointwise_conv1 = nn.Conv1d(dim, 2 * dim, 1)
        self.depthwise_conv = nn.Conv1d(dim, dim, kernel, padding=(kernel - 1) // 2, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pointwise_conv2 = nn.Conv1d(dim, dim, 1)

    def forward(self, x):
        a, g = conv_btc(self.pointwise_conv1, x).chunk(2, dim=-1)
        y = self.norm(conv_btc(self.depthwise_conv, a * torch.sigmoid(g)))
        return conv_btc(self.pointwise_conv2, y * torch.sigmoid(y))


class ConformerLayer(nn.Module):
    def __init__(self, dim, heads, units, kernel):
        super().__init__()
        self.self_attn = RelPosSelfAttention(dim, heads)
        self.feed_forward = ConvFFN(dim, units)
        self.feed_forward_macaron = ConvFFN(dim, units)
        self.conv_module = ConvModule(dim, kernel)
        for name in ("norm_ff", "norm_mha", "norm_ff_macaron", "norm_conv", "norm_final"):
            setattr(self, name, nn.LayerNorm(dim, eps=1e-12))

    def forward(self, x, pos_emb, padding_mask):
        x = x + 0.5 * self.feed_forward_macaron(self.norm_ff_macaron(x))
        x = x + self.self_attn(self.norm_mha(x), pos_emb, padding_mask)
        x = x + self.conv_module(self.norm_conv(x))
        x = x + 0.5 * self.feed_forward(self.norm_ff(x))
        return self.norm_final(x)


class ConformerEncoder(nn.Module):
    def __init__(self, dim, heads, units, blocks, kernel):
        super().__init__()
        self.dim = dim
        self.encoders = nn.ModuleList([ConformerLayer(dim, heads, units, kernel)
                                       for _ in range(blocks)])
        self.after_norm = nn.LayerNorm(dim, eps=1e-12)

    def forward(self, x, padding_mask):
        t = x.shape[1]
        x = x * math.sqrt(self.dim)
        pos = sinusoids(torch.arange(t - 1, -t, -1, dtype=torch.float64, device=x.device),
                        self.dim)
        for layer in self.encoders:
            x = layer(x, pos, padding_mask)
        return self.after_norm(x)


class ConformerBackbone(nn.Module):
    def __init__(self, dim, heads, units, blocks, kernel):
        super().__init__()
        self.conformer = ConformerEncoder(dim, heads, units, blocks, kernel)

    def forward(self, x, padding_mask):
        return self.conformer(x, padding_mask)


def make_backbone(cfg, dim):
    if cfg["kind"] == "convnext":
        return ConvNeXtBackbone(dim, cfg["intermediate_dim"], cfg["num_layers"],
                                cfg["layer_scale_init_value"])
    if cfg["kind"] == "conformer":
        if cfg["conv_norm"] != "layernorm":
            raise ValueError("the reference's Conformer takes conv_norm: layernorm")
        return ConformerBackbone(dim, cfg["attention_heads"], cfg["linear_units"],
                                 cfg["num_blocks"], cfg["cnn_module_kernel"])
    raise ValueError(f"the reference has no {cfg['kind']} backbone")


class VariancePredictor(nn.Module):
    """[conv -> ReLU -> LayerNorm(1e-12)] x N -> Linear -> (B, T), 0 on PAD."""

    def __init__(self, dim, num_layers, inter, kernel):
        super().__init__()
        self.conv = nn.ModuleList([
            nn.Sequential(nn.Conv1d(dim if i == 0 else inter, inter, kernel,
                                    padding=(kernel - 1) // 2),
                          nn.ReLU(), nn.LayerNorm(inter, eps=1e-12))
            for i in range(num_layers)])
        self.linear = nn.Linear(inter, 1)

    def forward(self, x, padding_mask):
        for conv, relu, norm in self.conv:
            x = norm(relu(conv_btc(conv, x)))
        return self.linear(x)[..., 0].masked_fill(padding_mask, 0.0)


class ValuePredictor(nn.Module):
    """Pitch or energy: the predictor, scaled by the factor, embedded by a
    conv and added back into the hidden stream."""

    def __init__(self, dim, cfg):
        super().__init__()
        self.predictor = VariancePredictor(dim, cfg["num_layers"], cfg["intermediate_dim"],
                                           cfg["kernel_size"])
        k = cfg["embed_kernel_size"]
        self.embed = nn.Sequential(nn.Conv1d(1, dim, k, padding=(k - 1) // 2))

    def forward(self, x, padding_mask, factor):
        preds = self.predictor(x, padding_mask) * factor
        emb = self.embed[0](preds[:, None, :]).transpose(1, 2)
        return (x + emb) * (~padding_mask)[..., None].float(), preds


class AlignmentModule(nn.Module):
    """The training aligner's parameters; synthesis does not run it."""

    def __init__(self, adim, odim):
        super().__init__()
        self.t_conv1 = nn.Conv1d(adim, adim, 3, padding=1)
        self.t_conv2 = nn.Conv1d(adim, adim, 1)
        self.f_conv1 = nn.Conv1d(odim, adim, 3, padding=1)
        self.f_conv2 = nn.Conv1d(adim, adim, 3, padding=1)
        self.f_conv3 = nn.Conv1d(adim, adim, 1)


class WaveNeXtHead(nn.Module):
    def __init__(self, dim, n_fft, hop):
        super().__init__()
        self.hop = hop
        self.linear_1 = nn.Linear(dim, n_fft + 2)
        self.linear_2 = nn.Linear(n_fft + 2, hop, bias=False)

    def forward(self, x):
        b, t, _ = x.shape
        return torch.clamp(self.linear_2(self.linear_1(x)).reshape(b, t * self.hop), -1.0, 1.0)


class WaveNeXt(nn.Module):
    def __init__(self, in_dim, cfg, n_fft, hop):
        super().__init__()
        self.embed = nn.Conv1d(in_dim, cfg["dim"], 7, padding=3)
        self.norm = nn.LayerNorm(cfg["dim"], eps=1e-6)
        self.backbone = ConvNeXtBackbone(cfg["dim"], cfg["intermediate_dim"], cfg["num_layers"])
        self.head = WaveNeXtHead(cfg["dim"], n_fft, hop)

    def forward(self, x, padding_mask):
        x = self.norm(conv_btc(self.embed, x))
        return self.head(self.backbone(x, padding_mask))


class Generator(nn.Module):
    """The synthesis path of OptiSpeech's generator, from a config dict (the
    `generator` block of a configuration file)."""

    def __init__(self, g):
        super().__init__()
        if g["num_speakers"] > 1 or g["num_languages"] > 1 or g["vocoder"]["f0_cond"]:
            raise ValueError("the reference takes one speaker, one language, no f0 conditioning")
        for name in ("duration_predictor", "pitch_predictor", "energy_predictor"):
            if g[name]["separable"]:
                raise ValueError("the reference takes non-separable predictors")
        dim, te, feats = g["dim"], g["text_embedding"], g["features"]
        self.hop = feats["hop_length"]
        self.text_embedding = TextEmbedding(dim, te["n_vocab"], te["padding_idx"],
                                            te["max_source_positions"])
        self.encoder = make_backbone(g["encoder"], dim)
        self.decoder = make_backbone(g["decoder"], dim)
        dp = g["duration_predictor"]
        self.duration_predictor = VariancePredictor(dim, dp["num_layers"],
                                                    dp["intermediate_dim"], dp["kernel_size"])
        self.pitch_predictor = ValuePredictor(dim, g["pitch_predictor"])
        self.energy_predictor = ValuePredictor(dim, g["energy_predictor"])
        self.alignment_module = AlignmentModule(dim, feats["n_feats"])
        self.vocoder = self.make_vocoder(g)

    def make_vocoder(self, g):
        """WaveNeXt. A reference file whose configuration has another
        vocoder subclasses this Generator and overrides this method; the
        vocoder takes (B, T, dim) frames and a (B, T) padding mask and gives
        (B, T * hop) samples."""
        return WaveNeXt(g["dim"], g["vocoder"], g["features"]["n_fft"], self.hop)

    def encode(self, x, x_lengths, d_factor, p_factor, e_factor):
        """Token rate: hidden states, integer durations, pitch and energy."""
        x_mask = sequence_mask(x_lengths, x.shape[1])
        pad = ~x_mask
        h = self.encoder(self.text_embedding(x), pad)
        logd = self.duration_predictor(h, pad)
        durations = torch.clamp(torch.ceil((torch.exp(logd) - 1e-8) * d_factor), min=0.0)
        durations = durations.masked_fill(pad, 0.0).to(torch.int32)
        h, pitch = self.pitch_predictor(h, pad, p_factor)
        h, energy = self.energy_predictor(h, pad, e_factor)
        return {"hidden": h, "durations": durations, "pitch": pitch, "energy": energy,
                "x_mask": x_mask}

    def decode(self, hidden, durations, x_mask, y_lengths, n_frames):
        """Frame rate: upsample, decoder, vocoder; (B, n_frames * hop) float32."""
        y_mask = sequence_mask(y_lengths, n_frames)
        y = gaussian_upsample(hidden, durations, y_mask, x_mask)
        y = self.decoder(y, ~y_mask)
        return self.vocoder(y, ~y_mask)
