"""Hydra-compatible YAML config composition: a copy of
anomalyclip_tpu/config/compose.py that reads YAML through the port's own
reader of the subset the config tree uses (``yaml_subset``), so that the card's
machine, which has no PyYAML, composes exactly as this one does.

The reference drives everything through Hydra 1.3 (reference: configs/train.yaml:5-29,
src/train.py:115). This module reproduces the user-visible contract without the Hydra
dependency:

- a root config (``train.yaml`` / ``eval.yaml``) with a ``defaults`` list of config
  groups (``data/``, ``model/``, ``trainer/``, ...),
- experiment bundles (``experiment=ucfcrime``) marked ``# @package _global_`` whose own
  ``defaults`` entries (``override /data: ucfcrime.yaml``) swap whole groups,
- dotted CLI overrides (``model.net.emb_size=128``, ``data.load_from_features=False``),
- ``${a.b.c}`` interpolation across groups and ``${oc.env:VAR,default}`` env lookup.

Composition order matches Hydra: group defaults in list order, experiment group
overrides, root keys (at the ``_self_`` position), experiment globals, CLI overrides,
then interpolation resolution. The ``_target_`` keys name classes of the JAX
package; neither package reads them.
"""

from __future__ import annotations

import copy
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from anomalyclip_tpu_torch.config import yaml_subset


class ConfigNode(dict):
    """A dict with attribute access, used for all composed configs."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return ConfigNode({k: copy.deepcopy(v, memo) for k, v in self.items()})


def _wrap(obj: Any) -> Any:
    if isinstance(obj, dict):
        return ConfigNode({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


def to_dict(obj: Any) -> Any:
    """Recursively convert ConfigNodes back to plain dicts (for YAML/JSON dumps)."""
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [to_dict(v) for v in obj]
    return obj


def load_yaml(path: Path) -> ConfigNode:
    with open(path) as f:
        data = yaml_subset.load(f.read(), str(path))
    return _wrap(data or {})


def _deep_merge(base: ConfigNode, overlay: Dict[str, Any]) -> None:
    """Merge ``overlay`` into ``base`` in place; nested dicts merge, scalars replace."""
    for key, value in overlay.items():
        if key in base and isinstance(base[key], dict) and isinstance(value, dict):
            _deep_merge(base[key], value)
        else:
            base[key] = copy.deepcopy(_wrap(value))


def _strip_ext(name: str) -> str:
    return name[:-5] if isinstance(name, str) and name.endswith(".yaml") else name


def _parse_defaults(defaults: List[Any]) -> List[Tuple[str, Optional[str], bool]]:
    """Flatten a Hydra defaults list into (group, choice, is_override) tuples.

    ``_self_`` is kept as group ``_self_``. ``- data: mnist.yaml`` -> ("data",
    "mnist"). ``- override /data: ucfcrime.yaml`` -> ("data", "ucfcrime", True).
    ``- optional local: default.yaml`` -> optional groups that silently skip when the
    file is missing are handled by the caller (we mark them with group prefix "?").
    """
    entries: List[Tuple[str, Optional[str], bool]] = []
    for item in defaults:
        if isinstance(item, str):
            entries.append((item, None, False))
            continue
        if isinstance(item, dict):
            for raw_key, value in item.items():
                key = str(raw_key)
                is_override = False
                if key.startswith("override"):
                    is_override = True
                    key = key[len("override") :].strip()
                optional = key.startswith("optional ")
                if optional:
                    key = key[len("optional ") :].strip()
                key = key.lstrip("/")
                choice = _strip_ext(value) if isinstance(value, str) else value
                group = ("?" + key) if optional else key
                entries.append((group, choice, is_override))
    return entries


_INTERP_RE = re.compile(r"\$\{([^{}]+)\}")


def _lookup(root: ConfigNode, dotted: str) -> Any:
    node: Any = root
    for part in dotted.split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        else:
            raise KeyError(f"Interpolation key not found: ${{{dotted}}}")
    return node


def _resolve_value(root: ConfigNode, value: Any, _depth: int = 0) -> Any:
    if _depth > 16:
        raise RecursionError("Interpolation recursion limit exceeded")
    if isinstance(value, str):
        # Innermost-first, iterate-to-fixpoint so nested interpolations like
        # ${oc.env:VAR,${paths.root_dir}/logs} resolve correctly.
        for _ in range(16):
            if not _INTERP_RE.search(value):
                return value
            full = _INTERP_RE.fullmatch(value)
            if full:
                resolved = _resolve_interp(root, full.group(1), _depth)
                if not isinstance(resolved, str):
                    return resolved
                value = resolved
                continue

            def sub(match: "re.Match[str]") -> str:
                resolved = _resolve_interp(root, match.group(1), _depth)
                return "" if resolved is None else str(resolved)

            value = _INTERP_RE.sub(sub, value)
        raise RecursionError(f"Interpolation did not converge: {value!r}")
    return value

def _resolve_interp(root: ConfigNode, expr: str, depth: int) -> Any:
    expr = expr.strip()
    if expr.startswith("oc.env:"):
        payload = expr[len("oc.env:") :]
        var, _, default = payload.partition(",")
        raw = os.environ.get(var.strip())
        if raw is None:
            if not _:
                raise KeyError(f"Environment variable {var} not set and no default given")
            return yaml_subset.load(default.strip()) if default.strip() else ""
        return raw
    target = _lookup(root, expr)
    return _resolve_value(root, target, depth + 1)


def _resolve_tree(root: ConfigNode, node: Any, _depth: int = 0) -> Any:
    if isinstance(node, dict):
        for key in list(node.keys()):
            node[key] = _resolve_tree(root, node[key], _depth)
        return node
    if isinstance(node, list):
        return [_resolve_tree(root, item, _depth) for item in node]
    return _resolve_value(root, node, _depth)


def parse_cli_overrides(argv: List[str]) -> Tuple[Dict[str, str], List[Tuple[str, Any]]]:
    """Split CLI args into group choices and dotted value overrides.

    ``experiment=ucfcrime`` is a group choice when the key has no dot and a matching
    group directory exists (decided by the caller); we return all ``key=value`` pairs
    and let :func:`compose` classify them. Values parse as YAML scalars (``yaml_subset.load``) so
    ``data.load_from_features=False`` becomes a bool (reference: README.md:91).
    """
    groups: Dict[str, str] = {}
    dotted: List[Tuple[str, Any]] = []
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"Malformed override (expected key=value): {arg!r}")
        key, _, raw = arg.partition("=")
        key = key.lstrip("+~")
        value = yaml_subset.load(raw, f"override {arg!r}") if raw != "" else None
        if "." in key:
            dotted.append((key, value))
        else:
            groups[key] = raw
    return groups, dotted


def _set_dotted(root: ConfigNode, dotted_key: str, value: Any) -> None:
    parts = dotted_key.split(".")
    node = root
    for part in parts[:-1]:
        if part not in node or not isinstance(node[part], dict):
            node[part] = ConfigNode()
        node = node[part]
    node[parts[-1]] = _wrap(value)


def compose(
    config_dir: str | Path,
    config_name: str,
    overrides: Optional[List[str]] = None,
    resolve: bool = True,
) -> ConfigNode:
    """Compose a config exactly like ``@hydra.main(config_path, config_name)`` would.

    Args:
        config_dir: path to the ``configs/`` tree.
        config_name: root config stem, e.g. ``"train"`` or ``"eval"``.
        overrides: CLI-style overrides, e.g. ``["experiment=ucfcrime",
            "trainer.max_epochs=3", "data.batch_size=16"]``.
        resolve: resolve ``${...}`` interpolations (disable to inspect raw values).
    """
    config_dir = Path(config_dir)
    overrides = list(overrides or [])
    group_choices, dotted_overrides = parse_cli_overrides(overrides)

    # A dotless key is a group choice only when a matching group directory exists;
    # otherwise it overrides a top-level scalar (e.g. ckpt_path=..., seed=...).
    for key in list(group_choices.keys()):
        if not (config_dir / key).is_dir():
            raw = group_choices.pop(key)
            dotted_overrides.append((key, yaml_subset.load(raw, f"override {key}={raw}")))

    root_cfg = load_yaml(config_dir / f"{config_name}.yaml")
    defaults = _parse_defaults(root_cfg.pop("defaults", []))

    # CLI group choices replace the default choice for that group.
    chosen: Dict[str, Optional[str]] = {}
    order: List[str] = []
    self_pos = len(defaults)
    for idx, (group, choice, _is_override) in enumerate(defaults):
        if group == "_self_":
            self_pos = idx
            continue
        chosen[group.lstrip("?")] = choice
        if group.lstrip("?") not in order:
            order.append(group.lstrip("?"))
    optional_groups = {g.lstrip("?") for g, _, _ in defaults if g.startswith("?")}

    for group, choice in group_choices.items():
        if group not in chosen:
            order.append(group)
        # `<group>=null` disables the group (the standard hydra idiom)
        chosen[group] = None if choice in ("null", "none", "None") else _strip_ext(choice)

    # Experiment bundles are "@package _global_": load first to collect their group
    # overrides, merge their non-defaults keys at the end (reference:
    # configs/experiment/ucfcrime.yaml:1-13).
    experiment_body: Optional[ConfigNode] = None
    exp_choice = chosen.get("experiment")
    if exp_choice:
        exp_cfg = load_yaml(config_dir / "experiment" / f"{exp_choice}.yaml")
        for group, choice, _ in _parse_defaults(exp_cfg.pop("defaults", [])):
            group = group.lstrip("?")
            if group == "_self_":
                continue
            # CLI explicit group choices win over experiment overrides.
            if group not in group_choices:
                chosen[group] = choice
                if group not in order:
                    order.insert(order.index("experiment"), group)
        experiment_body = exp_cfg

    composed = ConfigNode()
    merged_self = False

    def merge_self() -> None:
        nonlocal merged_self
        if not merged_self:
            _deep_merge(composed, root_cfg)
            merged_self = True

    for idx, group in enumerate(order):
        if idx >= self_pos:
            merge_self()
        if group == "experiment":
            # The "@package _global_" experiment body merges at its defaults-list
            # position, so later groups (e.g. debug=) still override it.
            if experiment_body is not None:
                _deep_merge(composed, experiment_body)
            continue
        choice = chosen.get(group)
        if choice is None:
            continue
        path = config_dir / group / f"{choice}.yaml"
        if not path.is_file():
            if group in optional_groups:
                continue
            raise FileNotFoundError(f"Config group file not found: {path}")
        group_cfg = _load_group_config(config_dir, group, choice)
        is_global = _is_package_global(path)
        if is_global:
            _deep_merge(composed, group_cfg)
        else:
            if group not in composed or not isinstance(composed.get(group), dict):
                composed[group] = ConfigNode()
            _deep_merge(composed[group], group_cfg)
    merge_self()

    for key, value in dotted_overrides:
        _set_dotted(composed, key, value)

    if resolve:
        _resolve_tree(composed, composed)
    return composed


def _load_group_config(config_dir: Path, group: str, choice: str) -> ConfigNode:
    """Load ``configs/<group>/<choice>.yaml``, resolving group-local ``defaults``.

    A group file may start with ``defaults: [- default]`` to inherit another choice
    from the same group (e.g. ``trainer/tpu.yaml`` extending ``trainer/default.yaml``).
    """
    cfg = load_yaml(config_dir / group / f"{choice}.yaml")
    defaults = cfg.pop("defaults", None)
    if not defaults:
        return cfg
    merged = ConfigNode()
    for entry in _parse_defaults(defaults):
        parent, sub_choice, _ = entry
        if parent == "_self_":
            continue
        if sub_choice is None:
            # plain string entry: another choice within the same group
            _deep_merge(merged, _load_group_config(config_dir, group, parent))
        else:
            _deep_merge(merged, _load_group_config(config_dir, parent, sub_choice))
    _deep_merge(merged, cfg)
    return merged


def _is_package_global(path: Path) -> bool:
    """Check for a ``# @package _global_`` directive in the file head."""
    with open(path) as f:
        for _ in range(5):
            line = f.readline()
            if not line:
                break
            if "@package" in line and "_global_" in line:
                return True
            if line.strip() and not line.lstrip().startswith("#"):
                break
    return False
