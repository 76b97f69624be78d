"""Reference checkpoints into the port without JAX
(`optispeech_tpu_torch.compat.torch_import`), held against the JAX
package's import of the same file, and JAX checkpoints of the other
backbone kinds through `scripts/jax_ckpt_to_torch.py`.

A reference-named Lightning checkpoint is built here with numpy, by
inverting the JAX names as tests/test_torch_import*.py do: the port's keys
are the reference's, so the inverse of a JAX init is the bridge's state
dict, given the reference's own forms where the port's differ (the
Conformer's BatchNorm1d with running statistics drawn from a seed, the
LSTM's two biases, a `generator.` prefix, and discriminator and
bookkeeping entries that the import must skip). It is saved with
`torch.save` and loaded by the port's `load_torch_checkpoint` and by JAX's.
Synthesis then agrees as in tests/test_torch_synthesis.py: durations
exactly equal, wav atol 1e-4.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_backbones import kind_config
from torch_parity import params_np, small_config, to_torch_config

from optispeech_tpu_torch.compat.from_jax import state_dict_from_jax_params
from optispeech_tpu_torch.compat.torch_import import (
    convert_torch_generator_state_dict,
    load_torch_checkpoint,
)
from optispeech_tpu_torch.models.optispeech import OptiSpeech

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
WAV_ATOL = 1e-4
TEXT = "The birch canoe slid on the smooth planks. Glue the sheet to the dark blue background."
KINDS = {"convnext": None, "lightspeech": "layernorm", "transformer": "layernorm",
         "conformer": "affine", "leanspeech": "layernorm"}


def _config(kind):
    if kind == "convnext":
        return small_config()
    return kind_config(kind, KINDS[kind])


def reference_state_dict(port_sd, seed):
    """The reference's Lightning `state_dict` for the port's `port_sd`
    (numpy): BatchNorm1d statistics whose fold is not the identity, the
    LSTM bias split in two, a `generator.` prefix, and entries the import
    skips."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in port_sd.items():
        v = v.numpy().copy()
        if k.endswith(".conv_module.norm.weight"):
            prefix = k[:-len("weight")]
            sd[f"{prefix}running_mean"] = (0.2 * rng.normal(size=v.shape)).astype(np.float32)
            sd[f"{prefix}running_var"] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            sd[f"{prefix}num_batches_tracked"] = np.array(1000, np.int64)
            v = (1.0 + 0.2 * rng.normal(size=v.shape)).astype(np.float32)
        elif k.endswith(".conv_module.norm.bias"):
            v = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
        elif k.endswith(".lstm.bias_hh_l0"):
            ih = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
            sd[k.replace("bias_hh", "bias_ih")] = ih
            v = v - ih
        elif k.endswith(".lstm.bias_ih_l0"):
            continue
        sd[k] = v
    out = {f"generator.{k}": torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    out["discriminator.multiperioddisc.discriminators.0.conv_post.bias"] = torch.zeros(1)
    return out


@pytest.fixture(scope="module", params=list(KINDS))
def imported(request, tmp_path_factory):
    """(kind, JAX OptiSpeech and port OptiSpeech each from its own import of
    one reference checkpoint file)."""
    from optispeech_tpu.compat.torch_import import load_torch_checkpoint as jax_load
    from optispeech_tpu.models.optispeech import OptiSpeech as JaxOptiSpeech

    kind = request.param
    cfg = _config(kind)
    tcfg = to_torch_config(cfg)
    init = params_np(JaxOptiSpeech(cfg, seed=1).params)
    ref = reference_state_dict(state_dict_from_jax_params(init, tcfg.generator), seed=2)
    path = tmp_path_factory.mktemp(f"ref_{kind}") / "last.ckpt"
    torch.save({"state_dict": ref, "epoch": 3, "hyper_parameters": {"kind": kind}}, path)

    japi = JaxOptiSpeech(cfg, params=jax.tree_util.tree_map(
        jnp.asarray, jax_load(str(path), cfg.generator)))
    tapi = OptiSpeech(tcfg, device="cpu", state_dict=load_torch_checkpoint(str(path),
                                                                           tcfg.generator))
    return kind, japi, tapi, ref


def test_reference_checkpoint_synthesises_as_jax_s_import(imported):
    kind, japi, tapi, _ = imported
    kw = dict(d_factor=2.0, p_factor=1.1, e_factor=0.9)
    jout = japi.synthesise(japi.prepare_input(TEXT, **kw))
    tout = tapi.synthesise(tapi.prepare_input(TEXT, **kw))
    np.testing.assert_array_equal(tout.durations, jout.durations)
    np.testing.assert_array_equal(tout.wav_lengths, jout.wav_lengths)
    np.testing.assert_allclose(tout.wav, jout.wav, atol=WAV_ATOL)


def test_import_folds_batchnorm_and_sums_the_lstm_biases(imported):
    """What the import does beyond renaming: BatchNorm1d's statistics folded
    into the affine norm (float32, eps 1e-5), the LSTM's two biases summed
    into bias_hh with bias_ih left at zero; everything else passes as it
    is, and the discriminator's and bookkeeping entries are skipped."""
    kind, _, tapi, ref = imported
    sd = tapi.generator.state_dict()
    assert set(sd) == {k[len("generator."):] for k in ref
                       if k.startswith("generator.") and "running_" not in k
                       and "num_batches" not in k}
    for k, v in sd.items():
        r = lambda name: ref[f"generator.{name}"]  # noqa: E731
        if ".conv_module.norm." in k:
            p = k.rsplit(".", 1)[0]
            scale = r(f"{p}.weight") / torch.sqrt(r(f"{p}.running_var") + 1e-5)
            shift = r(f"{p}.bias") - r(f"{p}.running_mean") * scale
            want = scale if k.endswith("weight") else shift
        elif k.endswith(".lstm.bias_hh_l0"):
            want = r(k) + r(k.replace("bias_hh", "bias_ih"))
        elif k.endswith(".lstm.bias_ih_l0"):
            want = torch.zeros_like(v)
        else:
            want = r(k)
        torch.testing.assert_close(v, want, rtol=0, atol=0, msg=k)


def test_conformer_import_needs_the_affine_norm():
    """As in JAX: a Conformer configured with the training default
    `layernorm` has nowhere to put BatchNorm1d's statistics."""
    from optispeech_tpu.compat.torch_import import convert_torch_generator_state_dict as jax_conv

    cfg = kind_config("conformer", "layernorm")
    with pytest.raises(ValueError, match="conv_norm='affine'"):
        jax_conv({}, cfg.generator)
    with pytest.raises(ValueError, match="conv_norm='affine'"):
        convert_torch_generator_state_dict({}, to_torch_config(cfg).generator)


def test_import_refuses_a_missing_key():
    cfg = to_torch_config(small_config())
    model = OptiSpeech(cfg, device="cpu")
    sd = {f"generator.{k}": v for k, v in model.generator.state_dict().items()
          if k != "vocoder.head.linear_2.weight"}
    with pytest.raises(KeyError, match="vocoder.head.linear_2.weight"):
        convert_torch_generator_state_dict(sd, cfg.generator)


def _converter():
    spec = importlib.util.spec_from_file_location("jax_ckpt_to_torch",
                                                  REPO / "scripts" / "jax_ckpt_to_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_light_jax_checkpoint_converts_and_infers_as_jax(tmp_path):
    """`scripts/jax_ckpt_to_torch.py` on a JAX inference checkpoint of the
    `light` kind (LightSpeech stacks, separable predictors), then the port's
    `cli/infer.py --fused` on the result: JAX's durations, JAX's wavs."""
    from optispeech_tpu.models.optispeech import OptiSpeech as JaxOptiSpeech
    from optispeech_tpu_torch.cli import infer
    from optispeech_tpu_torch.utils.wavio import load_wav

    japi = JaxOptiSpeech(kind_config("lightspeech"), seed=3)
    japi.save_checkpoint(str(tmp_path / "jax"))
    _converter().main([str(tmp_path / "jax"), str(tmp_path / "torch")])
    out = infer.main([str(tmp_path / "torch"), TEXT, str(tmp_path / "wavs"), "--fused",
                      "--device", "cpu"])
    jout = japi.synthesise(japi.prepare_input(TEXT))
    np.testing.assert_array_equal(out.durations, jout.durations)
    for i, n in enumerate(jout.wav_lengths):
        wav, _ = load_wav(str(tmp_path / "wavs" / f"gen-{i + 1}.wav"))
        assert len(wav) == n
        np.testing.assert_allclose(wav, jout.wav[i, :n], atol=2.0 / 32767 + WAV_ATOL)
