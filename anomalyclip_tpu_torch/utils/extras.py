"""Pre-task extras: warning filters, tag enforcement, config-tree printing. A
copy of anomalyclip_tpu/utils/extras.py without the XLA compilation cache,
which has no torch counterpart: ``extras.compilation_cache`` and
``extras.compilation_cache_dir`` stay legal keys, read by nothing.

The reference applies these before every task (reference: src/utils/utils.py:12-39
``extras`` + src/utils/rich_utils.py): `ignore_warnings` silences python warnings,
`enforce_tags` refuses to run untagged experiments, `print_config` prints the
fully composed config tree, as block YAML per top-level group written by the
port's own writer (``yaml_subset.dump``).
"""

from __future__ import annotations

from typing import Any

from anomalyclip_tpu_torch.config import yaml_subset
from anomalyclip_tpu_torch.config.compose import to_dict
from anomalyclip_tpu_torch.utils.logging import get_logger, is_host_zero

log = get_logger(__name__)

_PRINT_ORDER = (
    "data",
    "model",
    "callbacks",
    "logger",
    "trainer",
    "paths",
    "extras",
)


def config_text(cfg: Any) -> str:
    """The composed tree as block YAML, the groups of ``_PRINT_ORDER`` first."""
    tree = to_dict(cfg)
    lines = ["config tree:"]
    for key in _PRINT_ORDER:
        if key in tree:
            lines.append(yaml_subset.dump({key: tree.pop(key)}).rstrip())
    if tree:
        lines.append(yaml_subset.dump(tree).rstrip())
    return "\n".join(lines)


def apply_extras(cfg: Any) -> None:
    """Apply cfg.extras before the task runs (utils.py:12-39 contract)."""
    extras = cfg.get("extras") or {}

    if extras.get("ignore_warnings"):
        import warnings

        warnings.filterwarnings("ignore")

    if extras.get("enforce_tags"):
        tags = list(cfg.get("tags") or [])
        if not tags or tags == ["dev"]:
            raise SystemExit(
                "extras.enforce_tags: no experiment tags set — pass "
                "tags=[your_tag] (or disable with extras.enforce_tags=False)"
            )

    if extras.get("print_config") and is_host_zero():
        log.info(config_text(cfg))
