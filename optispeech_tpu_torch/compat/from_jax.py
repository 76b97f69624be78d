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
- flax Embed embedding                  -> Embedding weight;
- flax OptimizedLSTMCell's per-gate Denses -> nn.LSTM's packed matrices;
- the Transformer's pos_alpha (1,)      -> ESPnet's 0-d embed.0.alpha.
Every backbone kind (convnext, lightspeech, transformer, conformer with
either conv norm, leanspeech) maps onto the port's keys, which are the
reference's.

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

    def separable(key, path):
        conv(f"{key}.depthwise_conv", f"{path}/depthwise", bias=False)
        conv(f"{key}.pointwise_conv", f"{path}/pointwise")

    def any_conv(key, path, is_separable):
        if is_separable:
            separable(key, path)
        else:
            conv(key, path)

    def variance_predictor(key, path, vp_cfg):
        for i in range(vp_cfg.num_layers):
            any_conv(f"{key}.conv.{i}.0", f"{path}/conv_{i}", vp_cfg.separable)
            layer_norm(f"{key}.conv.{i}.2", f"{path}/ln_{i}")
        dense(f"{key}.linear", f"{path}/linear")

    def lightspeech(key, path, bb_cfg, is_decoder):
        if is_decoder:
            put(f"{key}.pos_emb.scale", take(f"{path}/pos_emb/scale"))
        for i in range(len(bb_cfg.kernel_sizes)):
            k, p = f"{key}.layers.{i}", f"{path}/layer_{i}"
            layer_norm(f"{k}.layer_norm", f"{p}/layer_norm")
            separable(f"{k}.conv1", f"{p}/conv1")
            separable(f"{k}.conv2", f"{p}/conv2")
        layer_norm(f"{key}.layer_norm", f"{path}/layer_norm")

    def attention(key, path, linears):
        for name in linears:
            dense(f"{key}.{name}", f"{path}/{name}", bias=name != "linear_pos")

    def ffn(key, path):
        conv(f"{key}.w_1", f"{path}/w_1")
        conv(f"{key}.w_2", f"{path}/w_2")

    def transformer(key, path, bb_cfg):
        base = f"{key}.transformer"
        put(f"{base}.embed.0.alpha", take(f"{path}/pos_alpha").reshape(()))
        for i in range(bb_cfg.num_blocks):
            k = f"{base}.encoders.{i}"
            attention(f"{k}.self_attn", f"{path}/self_attn_{i}",
                      ("linear_q", "linear_k", "linear_v", "linear_out"))
            ffn(f"{k}.feed_forward", f"{path}/ffn_{i}")
            layer_norm(f"{k}.norm1", f"{path}/norm1_{i}")
            layer_norm(f"{k}.norm2", f"{path}/norm2_{i}")
        layer_norm(f"{base}.after_norm", f"{path}/after_norm")

    def conformer(key, path, bb_cfg):
        base = f"{key}.conformer"
        for i in range(bb_cfg.num_blocks):
            k = f"{base}.encoders.{i}"
            attention(f"{k}.self_attn", f"{path}/self_attn_{i}",
                      ("linear_q", "linear_k", "linear_v", "linear_out", "linear_pos"))
            for bias in ("pos_bias_u", "pos_bias_v"):
                put(f"{k}.self_attn.{bias}", take(f"{path}/self_attn_{i}/{bias}"))
            ffn(f"{k}.feed_forward", f"{path}/ff_{i}")
            ffn(f"{k}.feed_forward_macaron", f"{path}/ff_macaron_{i}")
            cm, cp = f"{k}.conv_module", f"{path}/conv_module_{i}"
            conv(f"{cm}.pointwise_conv1", f"{cp}/pointwise_conv1")
            conv(f"{cm}.depthwise_conv", f"{cp}/depthwise_conv")
            if bb_cfg.conv_norm == "affine":
                put(f"{cm}.norm.weight", take(f"{cp}/norm_scale"))
                put(f"{cm}.norm.bias", take(f"{cp}/norm_bias"))
            else:
                layer_norm(f"{cm}.norm", f"{cp}/norm")
            conv(f"{cm}.pointwise_conv2", f"{cp}/pointwise_conv2")
            for norm in ("norm_ff", "norm_mha", "norm_ff_macaron", "norm_conv", "norm_final"):
                layer_norm(f"{k}.{norm}", f"{path}/{norm}_{i}")
        layer_norm(f"{base}.after_norm", f"{path}/after_norm")

    def lstm(key, path):
        """flax's per-gate Denses (input side without bias, hidden side with
        one) -> torch's packed (4H, H) matrices in the gate order i, f, g, o;
        flax's bias goes to bias_hh, and bias_ih is zero."""
        gates = "ifgo"
        put(f"{key}.weight_ih_l0", np.concatenate(
            [take(f"{path}/i{g}/kernel").T for g in gates]))
        put(f"{key}.weight_hh_l0", np.concatenate(
            [take(f"{path}/h{g}/kernel").T for g in gates]))
        b = np.concatenate([take(f"{path}/h{g}/bias") for g in gates])
        put(f"{key}.bias_ih_l0", np.zeros_like(b))
        put(f"{key}.bias_hh_l0", b)

    def leanspeech(key, path, bb_cfg):
        for i in range(bb_cfg.num_layers):
            k, p = f"{key}.layers.{i}", f"{path}/layer_{i}"
            lstm(f"{k}.lstm", f"{p}/OptimizedLSTMCell_0")
            separable(f"{k}.conv.conv.0", f"{p}/conv/conv")
            layer_norm(f"{k}.conv.conv.1", f"{p}/conv/ln")
            layer_norm(f"{k}.final_layer_norm", f"{p}/final_layer_norm")

    put("text_embedding.embed_tokens.weight", take("text_embedding/embed_tokens/embedding"))
    put("text_embedding.embed_positions.scale", take("text_embedding/embed_positions/scale"))
    for name in ("encoder", "decoder"):
        bb_cfg = getattr(gen_cfg, name)
        if bb_cfg.kind == "convnext":
            convnext(name, name, bb_cfg.num_layers)
        elif bb_cfg.kind == "lightspeech":
            lightspeech(name, name, bb_cfg, is_decoder=name == "decoder")
        elif bb_cfg.kind == "transformer":
            transformer(name, name, bb_cfg)
        elif bb_cfg.kind == "conformer":
            conformer(name, name, bb_cfg)
        elif bb_cfg.kind == "leanspeech":
            leanspeech(name, name, bb_cfg)
        else:
            raise ValueError(f"unknown backbone kind {bb_cfg.kind}")
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

