"""Turn the JAX package's parameters into the port's.

Input is numpy: the ``frozen`` and ``trainable`` pytrees and the selector's
``BNState`` (any arrays that ``np.asarray`` takes), or a flat treeio dictionary
with ``frozen/``, ``trainable/``, ``bn/`` and ``clip_cfg/`` keys, as in
``tests/golden/tiny_state.npz``. What changes on the way:

- every ``blocks`` subtree, stacked on a leading layer axis in the JAX package,
  becomes a list with one dictionary per layer;
- temporal conv kernels go from HWIO to OIHW, the layout ``F.conv2d`` takes;
- everything else keeps its layout: ``qkv_w`` stays (D, 3D) so the hot path is
  ``x @ w``, and ``patch_embed`` stays (3*p*p, width) in its channel-major order.

The trainable tree arrives as leaves that require grad (``as_trainable``); the
frozen tree and the BN state as plain tensors.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from anomalyclip_tpu_torch.models.clip.model import CLIPConfig
from anomalyclip_tpu_torch.models.selector import BNState
from anomalyclip_tpu_torch.utils.treeio import unflatten_tree

_CLIP_CFG_FIELDS = (
    "embed_dim", "image_resolution", "vision_layers", "vision_width",
    "vision_patch_size", "context_length", "vocab_size",
    "transformer_width", "transformer_heads", "transformer_layers",
)


def _tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


def _tree(node: Any, device, key: str = "") -> Any:
    if isinstance(node, Mapping):
        if key == "blocks":
            return _unstack_blocks(node, device)
        return {k: _tree(v, device, k) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree(v, device) for v in node]
    t = _tensor(node, device)
    if key in ("conv1_w", "conv2_w"):
        t = t.permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
    return t


def _unstack_blocks(blocks: Mapping, device) -> list:
    def depth(node):
        return depth(next(iter(node.values()))) if isinstance(node, Mapping) else len(node)

    def take(node, i):
        if isinstance(node, Mapping):
            return {k: take(v, i) for k, v in node.items()}
        return _tensor(np.asarray(node)[i], device)

    return [take(blocks, i) for i in range(depth(blocks))]


def params_from_jax(tree: Mapping, device="cpu") -> Dict[str, Any]:
    """Any JAX parameter tree of the package (CLIP params, ``frozen``,
    ``trainable``) -> the port's tree of fp32 tensors on ``device``."""
    return _tree(tree, device)


def bn_state_from_jax(bn_state, device="cpu") -> BNState:
    return BNState(mean=_tensor(bn_state.mean, device), var=_tensor(bn_state.var, device))


def state_from_flat(
    flat: Mapping[str, np.ndarray], device="cpu"
) -> Tuple[Dict[str, Any], Dict[str, Any], BNState, CLIPConfig]:
    """A flat treeio dictionary (tiny_state.npz layout) ->
    (frozen, trainable, bn_state, clip_cfg), the trainable leaves requiring grad."""

    def sub(prefix):
        return unflatten_tree(
            {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
        )

    clip_cfg = CLIPConfig(**{f: int(flat[f"clip_cfg/{f}"]) for f in _CLIP_CFG_FIELDS})
    bn = BNState(mean=_tensor(flat["bn/mean"], device), var=_tensor(flat["bn/var"], device))
    return (
        params_from_jax(sub("frozen/"), device),
        as_trainable(params_from_jax(sub("trainable/"), device)),
        bn,
        clip_cfg,
    )


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` over every tensor of a tree of dictionaries and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    """The tensors of a tree, in the order ``tree_map`` visits them."""
    leaves: list = []
    tree_map(leaves.append, tree)
    return leaves


def tree_to(tree: Any, device) -> Any:
    """Move every tensor of a parameter tree to ``device``."""
    return tree_map(lambda t: t.to(device), tree)


def as_trainable(tree: Any) -> Any:
    """Copies of every tensor as fp32 leaves that require grad, for the
    optimizer to update in place; the caller's tensors are left as they are."""
    return tree_map(lambda t: t.detach().float().clone().requires_grad_(True), tree)
