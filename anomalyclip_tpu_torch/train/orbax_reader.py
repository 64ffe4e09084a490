"""An Orbax ``StandardCheckpointer`` directory -> its tree of numpy arrays,
read without orbax, tensorstore or a compression package.

The JAX package's checkpoints (``anomalyclip_tpu/train/checkpoint.py``, and
``anomalyclip_tpu/convert_ckpt.py``'s output) are such directories:

- ``_METADATA`` (JSON) gives every leaf's key path: a ``key_type`` of 1 is a
  sequence index, 2 a dict key; a ``value_type`` of ``"None"`` marks an empty
  node (an optax ``EmptyState``, a masked-out leaf);
- the arrays live in an OCDBT store (``train/ocdbt.py``) as zarr v2 arrays, one
  a leaf, under the leaf's key path joined by dots: ``<path>/.zarray`` (JSON)
  and its chunks ``<path>/<i>.<j>...`` (``<path>/0`` for a scalar), each
  compressed by its ``compressor`` (Zstandard, ``utils/zstd.py``).

``read_tree`` gives what ``CheckpointManager.restore(path)`` of the JAX
package gives without a template, before it rebuilds the BN state: dicts for
dict nodes, lists for sequences, ``None`` for empty nodes, numpy arrays for
leaves. One thing differs: numpy has no bfloat16, so a bfloat16 leaf comes
back as float32 holding exactly its values (``read_leaves`` keeps the stored
bits). A ``last`` symlink is followed.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Dict, Iterator, Tuple, Union

import numpy as np

from anomalyclip_tpu_torch.train.ocdbt import OcdbtStore
from anomalyclip_tpu_torch.utils import zstd

METADATA_FILE = "_METADATA"
_SEQUENCE, _DICT = 1, 2


class OrbaxFormatError(ValueError):
    """A checkpoint directory this reader cannot take."""


def is_orbax_checkpoint(path: Union[str, Path]) -> bool:
    """Whether ``path`` is an Orbax directory with an OCDBT store."""
    path = Path(path)
    return (path / METADATA_FILE).is_file() and (path / "manifest.ocdbt").is_file()


def _metadata(path: Path) -> Dict[str, Any]:
    meta_file = path / METADATA_FILE
    if not meta_file.is_file():
        raise OrbaxFormatError(f"{path} holds no {METADATA_FILE}: not an Orbax checkpoint directory")
    meta = json.loads(meta_file.read_text())
    if not meta.get("use_ocdbt", True):
        raise OrbaxFormatError(f"{meta_file}: use_ocdbt is false; only OCDBT-backed checkpoints are read")
    if meta.get("use_zarr3"):
        raise OrbaxFormatError(f"{meta_file}: use_zarr3 is true; only zarr v2 arrays are read")
    return meta


def _entries(meta: Dict[str, Any], where: Path) -> Iterator[Tuple[Tuple[Tuple[str, int], ...], Dict]]:
    """(key path as (key, key_type) pairs, value metadata) of every leaf."""
    tree = meta.get("tree_metadata")
    if not isinstance(tree, dict):
        raise OrbaxFormatError(f"{where}/{METADATA_FILE}: no tree_metadata")
    for name, entry in tree.items():
        keys = tuple((str(k["key"]), int(k["key_type"])) for k in entry["key_metadata"])
        if any(t not in (_SEQUENCE, _DICT) for _, t in keys):
            raise OrbaxFormatError(f"{where}/{METADATA_FILE}: {name}: key types other than 1 and 2")
        yield keys, entry.get("value_metadata") or {}


def _is_empty(value_meta: Dict) -> bool:
    return value_meta.get("value_type") in (None, "None") or bool(value_meta.get("skip_deserialize"))


_FILLS = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}


def read_zarr(store: OcdbtStore, name: str) -> Tuple[np.ndarray, str]:
    """The zarr v2 array ``name`` of ``store`` -> (its values, its dtype's
    numpy name, or "bfloat16"). A bfloat16 array comes back as its uint16 bits."""
    zarray = json.loads(store.read(f"{name}/.zarray"))
    if zarray.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{store.root}: {name}/.zarray is not zarr v2")
    if zarray.get("filters"):
        raise OrbaxFormatError(f"{store.root}: {name}/.zarray has filters {zarray['filters']}")
    dtype_name = zarray["dtype"]
    dtype = np.dtype("<u2") if dtype_name == "bfloat16" else np.dtype(dtype_name)
    shape = tuple(zarray["shape"])
    chunks = tuple(zarray["chunks"])
    order = zarray.get("order", "C")
    compressor = zarray.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise OrbaxFormatError(f"{store.root}: {name} is compressed by {compressor.get('id')!r}")
    sep = zarray.get("dimension_separator", ".")
    fill = zarray.get("fill_value")
    fill = 0 if fill is None else _FILLS.get(fill, fill)
    if dtype_name == "bfloat16":
        fill = int(np.float32(fill).view(np.uint32) >> 16)
    out = np.full(shape, fill, dtype=dtype)
    grid = tuple(-(-s // c) for s, c in zip(shape, chunks))
    for index in np.ndindex(*grid) if shape else [()]:
        key = f"{name}/{sep.join(map(str, index)) if index else '0'}"
        if key not in store:
            continue  # a chunk never written holds the fill value
        raw = store.read(key)
        if compressor is not None:
            raw = zstd.decompress(raw)
        chunk = np.frombuffer(raw, dtype=dtype)
        if chunk.size != math.prod(chunks):
            raise OrbaxFormatError(f"{store.root}: chunk {key} holds {chunk.size} values, not {math.prod(chunks)}")
        chunk = chunk.reshape(chunks, order=order)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    return out, dtype_name if dtype_name == "bfloat16" else dtype.name


def read_leaves(path: Union[str, Path]) -> Dict[Tuple[Tuple[str, int], ...], Tuple[Any, str]]:
    """Every leaf of the checkpoint at ``path`` -> {key path: (values as
    stored, dtype name)}; an empty node's value is ``(None, "None")``. A
    bfloat16 leaf keeps its uint16 bits."""
    path = Path(path).resolve()  # a ``last`` symlink followed
    meta = _metadata(path)
    store = OcdbtStore(path)
    leaves = {}
    for keys, value_meta in _entries(meta, path):
        if _is_empty(value_meta):
            leaves[keys] = (None, "None")
            continue
        array, dtype_name = read_zarr(store, ".".join(k for k, _ in keys))
        leaves[keys] = (array, dtype_name)
    return leaves


class _Node:
    """An inner node while the tree is built: how its children are keyed."""

    __slots__ = ("kind", "children")

    def __init__(self, kind: int):
        self.kind, self.children = kind, {}

    def build(self, where: Path) -> Any:
        children = {k: v.build(where) if isinstance(v, _Node) else v for k, v in self.children.items()}
        if self.kind == _DICT:
            return children
        indices = sorted(int(k) for k in children)
        if indices != list(range(len(indices))):
            raise OrbaxFormatError(f"{where}: a sequence with indices {indices}")
        return [children[str(i)] for i in indices]


def read_tree(path: Union[str, Path]) -> Dict[str, Any]:
    """The checkpoint at ``path`` -> its tree: dicts, lists, ``None`` for
    empty nodes, numpy arrays (a bfloat16 leaf as float32 of its values)."""
    path = Path(path).resolve()
    root = _Node(_DICT)
    for keys, (array, dtype_name) in read_leaves(path).items():
        if dtype_name == "bfloat16":
            array = (array.astype(np.uint32) << 16).view(np.float32)
        node = root
        for depth, (key, kind) in enumerate(keys):
            if kind != node.kind:
                raise OrbaxFormatError(f"{path}: {keys} keys one node both as a sequence and a dict")
            if depth == len(keys) - 1:
                node.children[key] = array
            else:
                node = node.children.setdefault(key, _Node(keys[depth + 1][1]))
    return root.build(path)
