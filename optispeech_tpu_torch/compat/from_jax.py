"""JAX params -> the port's state dicts.

- `state_dict_from_jax_params(params, gen_cfg)` takes the flax param tree of
  `optispeech_tpu`'s OptiSpeechGenerator (the training-only
  `alignment_module` included) and returns the state dict of the port's
  `OptiSpeechGenerator`, whose keys are the reference's torch keys.
- `discriminator_state_dict_from_jax_params(params, disc_cfg)` does the same
  for the VocosDiscriminator.
Both take nested dicts of numpy arrays. Layouts converted:
- flax Conv kernel (K, in/groups, out) -> Conv1d weight (out, in/groups, K);
- flax 2-D Conv kernel (KH, KW, in, out) -> Conv2d weight (out, in, KH, KW);
- flax WeightNorm scale (out,) -> the weight-norm g (out, 1, 1, 1), beside
  the raw kernel as v;
- flax Dense kernel (in, out)           -> Linear weight (out, in);
- flax LayerNorm scale                  -> LayerNorm weight;
- flax Embed embedding                  -> Embedding weight.

Every leaf must be consumed, and every expected leaf present, or the call
raises KeyError.
"""

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if hasattr(value, "items"):
            out.update(_flatten(value, f"{path}/"))
        else:
            out[path] = value
    return out


class _Consumer:
    """Pops leaves of a flattened JAX tree into a torch state dict."""

    def __init__(self, params: dict):
        self.flat = _flatten(params)
        self.sd: dict[str, torch.Tensor] = {}

    def take(self, path):
        if path not in self.flat:
            raise KeyError(f"JAX params lack `{path}`")
        return np.asarray(self.flat.pop(path), dtype=np.float32)

    def put(self, key, array):
        self.sd[key] = torch.tensor(array)

    def done(self) -> dict[str, torch.Tensor]:
        leftover = sorted(self.flat)
        if leftover:
            raise KeyError(f"{len(leftover)} JAX params were not consumed, e.g. {leftover[:5]}")
        return self.sd


def state_dict_from_jax_params(params: dict, gen_cfg) -> dict[str, torch.Tensor]:
    consumer = _Consumer(params)
    take, put = consumer.take, consumer.put

    def conv(key, path, bias=True):
        put(f"{key}.weight", take(f"{path}/kernel").transpose(2, 1, 0))
        if bias:
            put(f"{key}.bias", take(f"{path}/bias"))

    def dense(key, path, bias=True):
        put(f"{key}.weight", take(f"{path}/kernel").transpose(1, 0))
        if bias:
            put(f"{key}.bias", take(f"{path}/bias"))

    def layer_norm(key, path):
        put(f"{key}.weight", take(f"{path}/scale"))
        put(f"{key}.bias", take(f"{path}/bias"))

    def convnext(key, path, num_layers):
        for i in range(num_layers):
            k, p = f"{key}.convnext.{i}", f"{path}/block_{i}"
            conv(f"{k}.dwconv", f"{p}/dwconv")
            layer_norm(f"{k}.norm", f"{p}/norm")
            dense(f"{k}.pwconv1", f"{p}/pwconv1")
            dense(f"{k}.pwconv2", f"{p}/pwconv2")
            put(f"{k}.gamma", take(f"{p}/gamma"))
        layer_norm(f"{key}.final_layer_norm", f"{path}/final_layer_norm")

    def any_conv(key, path, separable):
        if separable:
            conv(f"{key}.depthwise_conv", f"{path}/depthwise", bias=False)
            conv(f"{key}.pointwise_conv", f"{path}/pointwise")
        else:
            conv(key, path)

    def variance_predictor(key, path, vp_cfg):
        for i in range(vp_cfg.num_layers):
            any_conv(f"{key}.conv.{i}.0", f"{path}/conv_{i}", vp_cfg.separable)
            layer_norm(f"{key}.conv.{i}.2", f"{path}/ln_{i}")
        dense(f"{key}.linear", f"{path}/linear")

    put("text_embedding.embed_tokens.weight", take("text_embedding/embed_tokens/embedding"))
    put("text_embedding.embed_positions.scale", take("text_embedding/embed_positions/scale"))
    for name in ("encoder", "decoder"):
        bb_cfg = getattr(gen_cfg, name)
        if bb_cfg.kind != "convnext":
            raise NotImplementedError(f"backbone kind `{bb_cfg.kind}` is not ported yet")
        convnext(name, name, bb_cfg.num_layers)
    variance_predictor("duration_predictor", "duration_predictor/predictor",
                       gen_cfg.duration_predictor)
    for name in ("pitch_predictor", "energy_predictor"):
        vp_cfg = getattr(gen_cfg, name)
        variance_predictor(f"{name}.predictor", f"{name}/predictor", vp_cfg)
        any_conv(f"{name}.embed.0", f"{name}/embed", vp_cfg.separable)
    conv("vocoder.embed", "vocoder/embed")
    if gen_cfg.vocoder.f0_cond:
        conv("vocoder.f0_embed", "vocoder/f0_embed")
    layer_norm("vocoder.norm", "vocoder/norm")
    convnext("vocoder.backbone", "vocoder/backbone", gen_cfg.vocoder.num_layers)
    dense("vocoder.head.linear_1", "vocoder/head/linear_1")
    dense("vocoder.head.linear_2", "vocoder/head/linear_2", bias=False)
    if gen_cfg.num_speakers > 1:
        put("sid_embed.weight", take("sid_embed/embedding"))
    if gen_cfg.num_languages > 1:
        put("lid_embed.weight", take("lid_embed/embedding"))
    for name in ("t_conv1", "t_conv2", "f_conv1", "f_conv2", "f_conv3"):
        conv(f"alignment_module.{name}", f"alignment_module/{name}")
    return consumer.done()


def discriminator_state_dict_from_jax_params(params: dict, disc_cfg) -> dict[str, torch.Tensor]:
    """flax's WeightNorm scope keeps the wrapped conv as `Conv_<i>` (kernel,
    bias) beside its wrapper `conv_<i>` / `conv_post`, which holds one param
    named `Conv_<i>/kernel/scale` with literal slashes (critics.py:56-66)."""
    consumer = _Consumer(params)
    take, put = consumer.take, consumer.put

    def stack(key, path):
        wrappers = [f"conv_{i}" for i in range(5)] + ["conv_post"]
        for i, wrapper in enumerate(wrappers):
            k = f"{key}.convs.{i}" if i < 5 else f"{key}.conv_post"
            v = take(f"{path}/Conv_{i}/kernel")  # (KH, KW, in, out)
            g = take(f"{path}/{wrapper}/Conv_{i}/kernel/scale")
            put(f"{k}.parametrizations.weight.original0", g.reshape(-1, 1, 1, 1))
            put(f"{k}.parametrizations.weight.original1", v.transpose(3, 2, 0, 1))
            put(f"{k}.bias", take(f"{path}/Conv_{i}/bias"))

    for j, period in enumerate(disc_cfg.periods):
        stack(f"multiperioddisc.discriminators.{j}", f"multiperioddisc/disc_p{period}")
    for j, resolution in enumerate(disc_cfg.resolutions):
        stack(f"multiresddisc.discriminators.{j}", f"multiresddisc/disc_r{resolution[0]}")
    return consumer.done()

