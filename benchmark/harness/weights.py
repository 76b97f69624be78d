"""Seeded weights for the reference and the program, made on the device.

A frozen copy of the distributions flax's initialisers draw from, as the
JAX original of OptiSpeech initialises its generator:
- ConvNeXt blocks' depthwise conv and both products, the WaveNeXt head:
  normal, std 0.02, truncated at two standard deviations;
- the token table: normal, std dim ** -0.5;
- the Conformer's pos_bias_u / pos_bias_v: Xavier uniform;
- every other conv and linear weight: LeCun normal (truncated normal, std
  sqrt(1 / fan_in) / 0.8796); a transposed conv's fan-in is in_channels x
  kernel_size, as flax's ConvTranspose reckons it;
- biases 0, LayerNorm weights 1; layer scale and the position scale keep the
  constants the modules were built with.

A reference file may give a module a `weight_init = (kind, scale)`
attribute ("trunc", "normal" or "uniform": a standard draw of that kind
times `scale`): it sets the draw of every conv, transposed conv and linear
weight inside that module, the innermost such module's winning over the
rules above (HiFi-GAN's published init is ("normal", 0.01)).

The draws are made in three calls on the device's generator (one truncated
normal, one normal, one uniform over every parameter of that kind), then
scaled per parameter, so a full-width model takes milliseconds, not a walk
of a hundred small draws. The same seed gives the same weights.
"""

import math

import torch
from torch import nn

# std of a standard normal truncated to [-2, 2]
TRUNC_STD = 0.87962566103423978
KINDS = ("trunc", "normal", "uniform")  # the draws, in the order they are made
LAYERS = (nn.Conv1d, nn.ConvTranspose1d, nn.Linear)  # a weight drawn, a bias zeroed


def _plan(model: nn.Module):
    """(kind, parameter, scale) for every parameter that is drawn, and the
    parameters set to a constant."""
    names = {id(m): type(m).__name__ for m in model.modules()}
    explicit = {}
    for m in model.modules():
        kind = names[id(m)]
        if kind == "ConvNeXtBlock":
            for layer in (m.dwconv, m.pwconv1, m.pwconv2):
                explicit[id(layer.weight)] = ("trunc", 0.02)
        elif kind == "WaveNeXtHead":
            for layer in (m.linear_1, m.linear_2):
                explicit[id(layer.weight)] = ("trunc", 0.02)
        elif kind == "TextEmbedding":
            explicit[id(m.embed_tokens.weight)] = ("normal", m.dim ** -0.5)
        elif kind == "RelPosSelfAttention":
            for p in (m.pos_bias_u, m.pos_bias_v):
                fan_out, fan_in = p.shape
                explicit[id(p)] = ("uniform", math.sqrt(6.0 / (fan_in + fan_out)))
    for m in model.modules():  # parents before children: the innermost wins
        init = getattr(m, "weight_init", None)
        if init is None:
            continue
        if len(init) != 2 or init[0] not in KINDS:
            raise ValueError(f"{type(m).__name__}.weight_init: (kind in {KINDS}, scale), "
                             f"not {init!r}")
        for layer in m.modules():
            if isinstance(layer, LAYERS):
                explicit[id(layer.weight)] = (init[0], float(init[1]))
    draws, ones, zeros = [], [], []
    for m in model.modules():
        if isinstance(m, LAYERS):
            w = m.weight
            fan_in = w[0].numel()
            if isinstance(m, nn.ConvTranspose1d):  # weight (in, out / groups, k)
                fan_in = w.shape[0] * w.shape[2]
            kind, scale = explicit.get(id(w), ("trunc", math.sqrt(1.0 / fan_in) / TRUNC_STD))
            draws.append((kind, w, scale))
            if m.bias is not None:
                zeros.append(m.bias)
        elif isinstance(m, nn.Embedding):
            kind, scale = explicit.get(id(m.weight), ("normal", m.weight.shape[1] ** -0.5))
            draws.append((kind, m.weight, scale))
        elif isinstance(m, nn.LayerNorm):
            ones.append(m.weight)
            zeros.append(m.bias)
        elif names[id(m)] == "RelPosSelfAttention":
            draws += [("uniform", p, explicit[id(p)][1]) for p in (m.pos_bias_u, m.pos_bias_v)]
    return draws, ones, zeros


@torch.no_grad()
def init_weights(model: nn.Module, seed: int, device) -> None:
    """Draw `model`'s parameters (already on `device`) from `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    draws, ones, zeros = _plan(model)
    for kind in KINDS:
        params = [(p, s) for k, p, s in draws if k == kind]
        if not params:
            continue
        total = sum(p.numel() for p, _ in params)
        buf = torch.empty(total, device=device)
        if kind == "trunc":
            nn.init.trunc_normal_(buf, 0.0, 1.0, -2.0, 2.0, generator=g)
        elif kind == "normal":
            buf.normal_(0.0, 1.0, generator=g)
        else:
            buf.uniform_(-1.0, 1.0, generator=g)
        off = 0
        for p, scale in params:
            n = p.numel()
            p.copy_(buf[off:off + n].view_as(p) * scale)
            off += n
    for p in ones:
        p.fill_(1.0)
    for p in zeros:
        p.zero_()


def seeded_state_dict(model: nn.Module, seed: int, device) -> dict:
    """`model`'s state dict after `init_weights`, detached, on `device`."""
    init_weights(model, seed, device)
    return {k: v.detach() for k, v in model.state_dict().items()}


@torch.no_grad()
def init_critics(model: nn.Module, seed: int, device) -> None:
    """The critics' weight-normed convolutions as the original initialises
    them: each direction v uniform in +-1 / sqrt(fan_in) (one draw over all
    of them), zero biases, then each scale g = ||v|| per output channel, so
    that the effective kernel equals v."""
    from torch.nn.utils import parametrize

    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    convs = [m for m in model.modules() if parametrize.is_parametrized(m, "weight")]
    vs = [m.parametrizations.weight.original1 for m in convs]
    buf = torch.empty(sum(v.numel() for v in vs), device=device).uniform_(-1.0, 1.0, generator=g)
    off = 0
    for m, v in zip(convs, vs):
        v.copy_(buf[off:off + v.numel()].view_as(v) / math.sqrt(v[0].numel()))
        off += v.numel()
        m.bias.zero_()
        m.parametrizations.weight.original0.copy_(
            torch.linalg.vector_norm(v, dim=tuple(range(1, v.dim())), keepdim=True))
