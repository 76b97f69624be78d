"""Reference PyTorch checkpoints into the port, without JAX.

Port of `optispeech_tpu/compat/torch_import.py`. The port's state-dict keys
are the reference's (`generator.encoder.convnext.0.dwconv.weight` less the
`generator.` prefix), so the conversion is close to an identity:
- only the `generator.` keys of a Lightning checkpoint are read, the
  prefix dropped;
- the Conformer's conv-module BatchNorm1d is frozen at its running
  statistics and folded into the affine norm's scale and bias,
  scale = gamma / sqrt(var + 1e-5), bias = beta - mean * scale, which needs
  `conv_norm: affine` in the config (as in JAX, a Conformer with the
  training default `layernorm` is refused);
- the LSTM's two biases are summed into `bias_hh_l0` (flax's one bias per
  gate; the port keeps `bias_ih_l0` at zero, `FlaxLSTM`); ESPnet's 0-d
  positional alpha and torch's LSTM matrices pass unchanged.
Every key the port's generator holds must be present (KeyError otherwise);
other keys are ignored.
"""

import torch

from ..utils.pylogger import get_pylogger

log = get_pylogger(__name__)

BATCHNORM_EPS = 1e-5  # torch BatchNorm1d's default
_BATCHNORM_STATS = ("running_mean", "running_var", "num_batches_tracked")


def _generator_keys(gen_cfg) -> dict[str, torch.Size]:
    """The port generator's state-dict keys and shapes for `gen_cfg`, built
    on the meta device (no memory)."""
    from ..models.generator import OptiSpeechGenerator

    with torch.device("meta"):
        gen = OptiSpeechGenerator(gen_cfg)
    return {k: v.shape for k, v in gen.state_dict().items()}


def _check_conformer(gen_cfg):
    for name in ("encoder", "decoder"):
        bb = getattr(gen_cfg, name)
        if bb.kind == "conformer" and bb.conv_norm != "affine":
            raise ValueError(
                f"conformer checkpoint import requires conv_norm='affine' in the {name}'s "
                "BackboneConfig: the reference conv module uses BatchNorm1d, whose frozen "
                "running stats are folded into an affine transform on import "
                "(training-from-scratch keeps the default LayerNorm)")


def convert_torch_generator_state_dict(state_dict: dict, gen_cfg) -> dict[str, torch.Tensor]:
    """Map a reference generator state dict (tensors or numpy arrays; keys
    with or without the `generator.` prefix) onto the port's state dict."""
    _check_conformer(gen_cfg)
    sd = {}
    for k, v in state_dict.items():
        if k.startswith("generator."):
            k = k[len("generator."):]
        sd[k] = torch.as_tensor(v).detach().cpu()

    for k in [k for k in sd if k.endswith(".conv_module.norm.running_mean")]:
        prefix = k[:-len("running_mean")]
        gamma, beta, mean, var = (sd[f"{prefix}{name}"].float() for name in (
            "weight", "bias", "running_mean", "running_var"))
        scale = gamma / torch.sqrt(var + BATCHNORM_EPS)  # float32, as JAX's numpy fold
        sd[f"{prefix}weight"] = scale
        sd[f"{prefix}bias"] = beta - mean * scale
        for stat in _BATCHNORM_STATS:
            sd.pop(f"{prefix}{stat}", None)

    # flax's one LSTM bias per gate: torch's two summed, bias_ih left at zero
    for k in [k for k in sd if k.endswith(".lstm.bias_ih_l0")]:
        hh = k.replace("bias_ih_l0", "bias_hh_l0")
        sd[hh] = sd[hh].float() + sd[k].float()
        sd[k] = torch.zeros_like(sd[hh])

    expected = _generator_keys(gen_cfg)
    missing = [k for k in expected if k not in sd]
    if missing:
        raise KeyError(f"state_dict missing {len(missing)} keys, e.g. {missing[:5]}")
    out = {}
    for k, shape in expected.items():
        v = sd[k].to(torch.float32)
        if v.shape != shape:
            raise ValueError(f"`{k}`: shape {tuple(v.shape)} where the config gives "
                             f"{tuple(shape)}")
        out[k] = v.contiguous()
    ignored = len(sd) - len(out)
    if ignored:
        log.info(f"ignored {ignored} keys the port's generator does not hold")
    return out


def load_torch_checkpoint(path: str, gen_cfg) -> dict[str, torch.Tensor]:
    """Load a reference Lightning `.ckpt` and convert its generator weights
    (its `generator.` keys) into the port's state dict."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    return convert_torch_generator_state_dict(
        {k: v for k, v in sd.items() if torch.is_tensor(v) and k.startswith("generator.")},
        gen_cfg)
