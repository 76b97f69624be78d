"""YAML config layering and dotted overrides (the port's own copy of
`optispeech_tpu/utils/yamlcfg.py`).

`load_experiment("light")` reads configs/light.yaml of the repository; a
`_base_: default` key layers a file on top of another. Overrides are
`path.to.field=value` strings whose values are parsed as YAML. `yaml` is
imported only when a file or an override is parsed, so a machine without
pyyaml can still build an `ExperimentConfig` in code and train.
"""

import os
from typing import Optional

from ..config import ExperimentConfig, finalize, from_dict, merge_overrides

CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "configs")


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _load_yaml_layered(name_or_path: str, config_dir: Optional[str] = None) -> dict:
    import yaml

    config_dir = config_dir or CONFIG_DIR
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(config_dir, f"{name_or_path}.yaml")
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    base_name = data.pop("_base_", None)
    if base_name:
        data = _deep_merge(_load_yaml_layered(base_name, config_dir), data)
    return data


def parse_override(kv: str) -> tuple[str, object]:
    import yaml

    key, _, value = kv.partition("=")
    return key.strip(), yaml.safe_load(value)


def load_experiment(name_or_path: str = "default", overrides: Optional[list[str]] = None,
                    config_dir: Optional[str] = None) -> ExperimentConfig:
    cfg = from_dict(ExperimentConfig, _load_yaml_layered(name_or_path, config_dir))
    if overrides:
        cfg = merge_overrides(cfg, dict(parse_override(o) for o in overrides))
    return finalize(cfg)
