"""Every configs/*.yaml through the port's `utils/yamlcfg.py::load_experiment`
and the JAX package's, bare and with the same dotted overrides: the two
`to_dict` trees are EQUAL, the `_base_` chains (emily-light -> light ->
default, campaign-ms -> default) included."""

from pathlib import Path

import pytest

from optispeech_tpu import config as jax_config
from optispeech_tpu.utils.yamlcfg import load_experiment as jax_load
from optispeech_tpu_torch import config as torch_config
from optispeech_tpu_torch.utils.yamlcfg import load_experiment

CONFIGS = sorted(p.stem for p in (Path(__file__).resolve().parent.parent / "configs")
                 .glob("*.yaml"))
OVERRIDES = ["data.batch_size=4", "generator.dim=64", "data.statistics.pitch_mean=100.5",
             "data.text_processor.languages=[en-us, de]", "discriminator.periods=[2, 3]",
             "train_args.wire_mel_dtype=bfloat16"]


def test_every_config_file_is_covered():
    assert len(CONFIGS) == 10
    assert {"ljspeech-48k", "ljspeech-22k", "mike", "emily-light", "kareem",
            "campaign-ms"} <= set(CONFIGS)


@pytest.mark.parametrize("overrides", [[], OVERRIDES], ids=["bare", "overridden"])
@pytest.mark.parametrize("name", CONFIGS)
def test_config_loads_equal_to_jax(name, overrides):
    got = torch_config.to_dict(load_experiment(name, overrides))
    assert got == jax_config.to_dict(jax_load(name, overrides))
    # the data block reaches the generator (`finalize`)
    assert got["generator"]["features"] == got["data"]["features"]
    assert got["generator"]["num_languages"] == len(got["data"]["text_processor"]["languages"])


def test_the_chains_carry_their_bases():
    emily = load_experiment("emily-light")
    assert emily.generator.encoder.kind == "lightspeech"  # from light.yaml
    assert emily.data.preprocess.preemphasis_filter_coef == 0.5
    assert emily.optimizer.lr == 2.0e-4  # from default.yaml
    campaign = load_experiment("campaign-ms")
    assert campaign.generator.num_speakers == 4 and campaign.generator.num_languages == 2
    assert campaign.train_args.evaluate_stoi and campaign.generator.vocoder.num_layers == 8
    assert load_experiment("ljspeech-48k").generator.features.hop_length == 512
