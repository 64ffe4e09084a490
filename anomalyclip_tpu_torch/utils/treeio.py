"""Parameter-pytree <-> .npz serialization (dicts, lists, array leaves).

Used by the golden parity fixtures (tests/golden/*.npz, generated by
scripts/gen_golden.py): a converted parameter tree is flattened to
slash-joined keys, saved with numpy's compressed container, and rebuilt
torch-free on load. Orbax remains the production checkpoint format; this is
deliberately dependency-free so fixtures load anywhere numpy imports.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts/lists/tuples of array leaves -> {'a/b/0/c': ndarray}.

    Keys must not contain '/'; list/tuple positions become integer segments
    (and are rebuilt as lists by :func:`unflatten_tree`).
    """
    flat: Dict[str, np.ndarray] = {}

    def visit(node: Any, path: str) -> None:
        if isinstance(node, dict):
            for key, value in node.items():
                key = str(key)
                if "/" in key:
                    raise ValueError(f"tree key {key!r} contains '/'")
                if key.isdigit():
                    # digit-string dict keys are indistinguishable from list
                    # positions in the flat form, so unflatten_tree would
                    # rebuild {'0': a, '1': b} as [a, b] — reject up front
                    # instead of silently changing the tree's shape on load
                    raise ValueError(
                        f"tree dict key {key!r} is all digits: it would "
                        "round-trip as a LIST index (use a non-numeric key)"
                    )
                visit(value, f"{path}/{key}" if path else key)
        elif isinstance(node, (list, tuple)):
            for i, value in enumerate(node):
                visit(value, f"{path}/{i}" if path else str(i))
        else:
            flat[path] = np.asarray(node)

    visit(tree, prefix)
    return flat


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Any:
    """Inverse of :func:`flatten_tree`: rebuild nested dicts, turning levels
    whose keys are exactly 0..n-1 back into lists."""
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        node = root
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(value)

    def listify(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            indices = sorted(int(k) for k in keys)
            if indices == list(range(len(indices))):
                return [listify(node[str(i)]) for i in indices]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_tree_npz(path: str | Path, tree: Any) -> None:
    np.savez_compressed(str(path), **flatten_tree(tree))


def load_tree_npz(path: str | Path) -> Any:
    with np.load(str(path)) as data:
        return unflatten_tree({k: data[k] for k in data.files})
