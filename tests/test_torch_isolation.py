"""The port stands alone: it imports neither JAX nor the JAX package, its
weight bridges consume the whole JAX trees (generator, with the
training-only `alignment_module`, and discriminator), its keys are the
reference's torch keys, and its entry points do not fall back to the CPU
unasked."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import build_pair, params_np, small_config, to_torch_config

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import optispeech_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "optispeech_tpu"))
print(len(names), bad)
assert not bad, bad
print(*names)
"""

# the modules of the training slices, which the walk above must have imported
TRAINING_MODULES = [f"optispeech_tpu_torch.{m}" for m in (
    "ops.mas", "ops.ctc", "ops.prior", "ops.segments", "ops.stft", "ops.audio", "ops._build",
    "models.losses", "models.modules.alignment", "models.discriminator.critics",
    "models.discriminator.losses", "models.discriminator.vocos", "training.schedules",
    "training.state", "training.step", "training.checkpoint", "training.trainer",
    "training.metrics", "training.loggers", "data.datamodule", "data.dsp", "utils.yamlcfg",
    "utils.pylogger", "cli.train")]
# the int8 A/B slice
INT8_MODULES = [f"optispeech_tpu_torch.{m}" for m in ("ops.fused_convnext", "cli.int8_ab")]
# the workflow slice: inference from the command line and the data pipeline
WORKFLOW_MODULES = [f"optispeech_tpu_torch.{m}" for m in (
    "utils.wavio", "models.optispeech", "cli.infer", "data.dsp", "data.pitch", "data.vad",
    "data.preprocess", "data.statistics", "data.datamodule", "cli.preprocess", "cli.stats",
    "data.synthcorpus")]

# without pyyaml the CLI imports and trains a config built in code; only
# reading a YAML file needs it
_WITHOUT_YAML = """
import sys
sys.modules["yaml"] = None  # any `import yaml` now raises
from optispeech_tpu_torch.cli import train
from optispeech_tpu_torch.config import ExperimentConfig
from optispeech_tpu_torch.utils import yamlcfg
args = train.parse_args(["--synthetic", "--device", "cpu"])
assert args.device == "cpu" and ExperimentConfig().data.batch_size == 128
try:
    yamlcfg.load_experiment("default")
except ImportError:
    print("yaml needed only to load")
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    first, imported = proc.stdout.splitlines()[:2]
    assert int(first.split()[0]) >= 35  # every module of the package was imported
    assert set(TRAINING_MODULES + INT8_MODULES + WORKFLOW_MODULES) <= set(imported.split())


def test_training_cli_imports_without_yaml():
    proc = subprocess.run([sys.executable, "-c", _WITHOUT_YAML], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "yaml needed only to load"


def test_kernel_sources_are_self_contained():
    """Every CUDA source the build compiles includes only the CUDA runtime,
    the C++ standard library and the port's own headers."""
    import re

    csrc = REPO / "optispeech_tpu_torch" / "csrc"
    sources = sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
    assert {p.name for p in sources} >= {"convnext_block.cu", "convnext_block_int8.cu",
                                          "mas_wavefront.cu", "mas_extract.cu", "mas_forward.cuh"}
    for path in sources:
        for inc in re.findall(r'#include\s+[<"]([^>"]+)[>"]', path.read_text()):
            assert inc in {"cstdint", "stdint.h", "cuda_runtime.h", "cuda_bf16.h", "mma.h"} or (
                csrc / inc).exists(), (path.name, inc)


@pytest.fixture(scope="module")
def pair():
    return build_pair(small_config(num_speakers=3, languages=("en-us", "en-gb")))


def test_bridge_consumes_every_leaf_but_alignment_module(pair):
    """Every leaf, `alignment_module` included since the port trains (the
    name is kept from the inference-only bridge, which skipped it)."""
    from optispeech_tpu_torch.compat.from_jax import state_dict_from_jax_params

    japi, tapi = pair
    cfg = to_torch_config(japi.cfg).generator
    params = params_np(japi.params)
    assert "alignment_module" in params
    sd = state_dict_from_jax_params(params, cfg)
    assert set(sd) == set(tapi.generator.state_dict())
    assert any(k.startswith("alignment_module.") for k in sd)
    # without the alignment module the tree is incomplete
    rest = {k: v for k, v in params.items() if k != "alignment_module"}
    with pytest.raises(KeyError, match="lack `alignment_module"):
        state_dict_from_jax_params(rest, cfg)
    # a leaf the bridge does not know is an error, not silently dropped
    stray = {**params, "vocoder": {**params["vocoder"], "extra": {"kernel": np.zeros(3)}}}
    with pytest.raises(KeyError, match="not consumed"):
        state_dict_from_jax_params(stray, cfg)
    # so is a missing one
    short = {**params, "decoder": {k: v for k, v in params["decoder"].items() if k != "block_1"}}
    with pytest.raises(KeyError, match="lack"):
        state_dict_from_jax_params(short, cfg)


def test_state_dict_keys_are_the_reference_torch_keys(pair):
    """The JAX package's reference-checkpoint importer reads the port's state
    dict as if it were a reference checkpoint and rebuilds the JAX tree."""
    import jax

    from optispeech_tpu.compat.torch_import import convert_torch_generator_state_dict

    japi, tapi = pair
    ref = params_np(japi.params)
    sd = {k: v.numpy() for k, v in tapi.generator.state_dict().items()}
    rebuilt = convert_torch_generator_state_dict(sd, japi.cfg.generator)
    assert jax.tree_util.tree_structure(rebuilt) == jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(rebuilt), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(np.asarray(a).reshape(b.shape), b)


def test_discriminator_bridge_consumes_every_leaf():
    """The flax WeightNorm layout (`Conv_<i>` beside its wrapper holding
    `Conv_<i>/kernel/scale`) maps onto the port's g and v; a stray or a
    missing leaf raises."""
    import jax
    import jax.numpy as jnp

    from optispeech_tpu import config as jax_config
    from optispeech_tpu.models.discriminator.vocos import VocosDiscriminator as JaxDisc
    from optispeech_tpu_torch import config as torch_config
    from optispeech_tpu_torch.compat.from_jax import discriminator_state_dict_from_jax_params
    from optispeech_tpu_torch.models.discriminator import VocosDiscriminator

    cfg = jax_config.DiscriminatorConfig(periods=(2, 3), resolutions=((256, 64, 256),),
                                         mrd_channels=16)
    wav = jnp.zeros((1, 1024))
    params = params_np(jax.jit(
        lambda k: JaxDisc(cfg, jax_config.FeatureConfig()).init(k, wav, wav))(
        jax.random.PRNGKey(0))["params"])
    sd = discriminator_state_dict_from_jax_params(params, cfg)
    tcfg = torch_config.from_dict(torch_config.DiscriminatorConfig, jax_config.to_dict(cfg))
    VocosDiscriminator(tcfg, torch_config.FeatureConfig()).load_state_dict(sd, strict=True)
    scale = params["multiresddisc"]["disc_r256"]["conv_post"]["Conv_5/kernel/scale"]
    g = sd["multiresddisc.discriminators.0.conv_post.parametrizations.weight.original0"]
    np.testing.assert_array_equal(g.numpy().reshape(-1), scale)
    stray = {**params, "extra": {"kernel": np.zeros(3)}}
    with pytest.raises(KeyError, match="not consumed"):
        discriminator_state_dict_from_jax_params(stray, cfg)
    short = {"multiperioddisc": params["multiperioddisc"]}
    with pytest.raises(KeyError, match="lack"):
        discriminator_state_dict_from_jax_params(short, cfg)


def test_entry_points_need_a_device_when_cuda_is_absent(pair, monkeypatch):
    from optispeech_tpu_torch.models.optispeech import OptiSpeech

    japi, _ = pair
    cfg = to_torch_config(japi.cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OptiSpeech(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OptiSpeech.load_from_jax_params(cfg, params_np(japi.params))
    assert OptiSpeech(cfg, device="cpu").device.type == "cpu"
    from optispeech_tpu_torch.training.state import init_train_state

    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(cfg)
    assert init_train_state(cfg, "cpu").rng.device.type == "cpu"


def test_int8_ab_needs_a_device_when_cuda_is_absent():
    """`python -m optispeech_tpu_torch.cli.int8_ab` runs on the card unless
    given `--device cpu`; with no card visible it raises rather than fall back."""
    import os

    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "optispeech_tpu_torch.cli.int8_ab"], cwd=REPO,
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0
    assert "RuntimeError: no CUDA device is available; pass device='cpu'" in proc.stderr
    assert "fused_int8" not in proc.stdout


def test_seeded_init_is_reproducible_and_flax_like(pair):
    from optispeech_tpu_torch.models.optispeech import OptiSpeech

    japi, _ = pair
    cfg = to_torch_config(japi.cfg)
    a = OptiSpeech(cfg, seed=3, device="cpu").generator.state_dict()
    b = OptiSpeech(cfg, seed=3, device="cpu").generator.state_dict()
    c = OptiSpeech(cfg, seed=4, device="cpu").generator.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.convnext.0.pwconv1.weight"],
                           c["encoder.convnext.0.pwconv1.weight"])
    # the distributions flax draws from: truncated normal 0.02, layer scale
    # 1/num_layers, token table std dim**-0.5, zero biases
    w = a["vocoder.backbone.convnext.0.pwconv1.weight"]
    assert w.abs().max() <= 0.04 and 0.015 < float(w.std()) < 0.02
    assert torch.all(a["decoder.convnext.1.gamma"] == 0.5)
    assert abs(float(a["text_embedding.embed_tokens.weight"].std()) - 32 ** -0.5) < 0.01
    assert torch.all(a["vocoder.head.linear_1.bias"] == 0)
