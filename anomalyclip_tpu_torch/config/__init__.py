import os
from pathlib import Path

from anomalyclip_tpu_torch.config.compose import (
    ConfigNode,
    compose,
    load_yaml,
    parse_cli_overrides,
    to_dict,
)


def default_config_dir() -> Path:
    """The YAML config tree for every CLI entry point: the JAX package's tree
    (``anomalyclip_tpu/configs``), read by path as data, never imported.
    Override with ``ANOMALYCLIP_CONFIG_DIR`` to point at a custom tree."""
    override = os.environ.get("ANOMALYCLIP_CONFIG_DIR")
    if override:
        return Path(override)
    return Path(__file__).resolve().parents[2] / "anomalyclip_tpu" / "configs"


__all__ = [
    "ConfigNode",
    "compose",
    "default_config_dir",
    "load_yaml",
    "parse_cli_overrides",
    "to_dict",
]
