"""Checkpoint save and restore, torch-native: the counterpart of
anomalyclip_tpu/train/checkpoint.py without Orbax.

Replaces Lightning's ModelCheckpoint + trainer.fit(ckpt_path=...) resume (reference:
configs/callbacks/model_checkpoint.yaml, anomaly_clip_module.py via Lightning).
Layout under ``<run_dir>/checkpoints``:

    epoch_000/state.pt  epoch_001/state.pt  ...  last -> epoch_NNN

Each ``state.pt`` is one ``torch.save`` of {"trainable" (the tree of tensors),
"optimizer" (``torch.optim.AdamW.state_dict()``), "count" (the
``GroupedAdamW``'s updates so far), "bn_mean", "bn_var", "step", "epoch"}, all
on the CPU; it is written to a temporary name and renamed into place, and read
back with ``torch.load(..., weights_only=True)``. The normality centroid is a
side-channel file ``ncentroid.npy`` in the run dir, mirroring the reference's
``ncentroid.pt`` (anomaly_clip_module.py:140-171). In a ``torch.distributed``
group rank 0 writes and every rank restores the same file onto its own device.

``restore`` also reads the JAX package's Orbax checkpoint directories (a fit's
``epoch_NNN`` or ``last``, ``anomalyclip_tpu/convert_ckpt.py``'s output)
through ``orbax_reader`` with no JAX, orbax or compression package:
``state_from_orbax`` maps that tree onto the same state. The trainable tree
goes through ``convert.params_from_jax`` (conv kernels HWIO -> OIHW); the
optax state (``optax.multi_transform`` -> ``MaskedState`` ->
``ScaleByAdamState(count, mu, nu)`` per group, anomalyclip_tpu/train/optim.py)
becomes the AdamW state of the port's parameter order, each parameter's step
its group's count. A converted directory has no optimizer state: it restores
for evaluation and refuses to resume a fit.
"""

from __future__ import annotations

import re
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from anomalyclip_tpu_torch.convert import params_from_jax, tree_leaves
from anomalyclip_tpu_torch.models.selector import BNState
from anomalyclip_tpu_torch.parallel.mesh import any_rank
from anomalyclip_tpu_torch.train import orbax_reader
from anomalyclip_tpu_torch.train.optim import GROUP_OF_KEY
from anomalyclip_tpu_torch.utils.logging import is_host_zero

STATE_FILE = "state.pt"


def host_copy(node: Any) -> Any:
    """A deep copy of a tree of dicts, lists, tuples and tensors with every
    tensor detached and copied to the CPU, never an alias: the optimizer updates
    the trainable leaves and its moments in place, and ``Tensor.to("cpu")``
    returns the tensor itself when it already lies there."""
    if isinstance(node, torch.Tensor):
        return node.detach().to("cpu", copy=True)
    if isinstance(node, BNState):
        return BNState(*(host_copy(t) for t in node))
    if isinstance(node, dict):
        return {k: host_copy(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(host_copy(v) for v in node)
    return node


def _to_saveable(state: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(state)
    bn = out.pop("bn_state")
    out["bn_mean"] = bn.mean
    out["bn_var"] = bn.var
    out["step"] = int(out["step"])
    out["epoch"] = int(out["epoch"])
    return host_copy(out)


def _from_saved(raw: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(raw)
    out["bn_state"] = BNState(mean=out.pop("bn_mean"), var=out.pop("bn_var"))
    return out


def write_state(path: Path, state: Dict[str, Any]) -> Path:
    """One checkpoint directory ``path`` holding ``state`` (the keys of
    ``CheckpointManager.save_epoch``) as ``state.pt``, written to a temporary
    name and renamed into place -> ``path``."""
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / f".{STATE_FILE}.tmp"
    torch.save(_to_saveable(state), tmp)
    tmp.replace(path / STATE_FILE)
    return path


class CheckpointManager:
    def __init__(self, run_dir: str | Path, save_top_k: int = -1, save_last: bool = True):
        self.ckpt_dir = Path(run_dir) / "checkpoints"
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.save_top_k = save_top_k
        self.save_last = save_last

    def save_epoch(self, epoch: int, state: Dict[str, Any]) -> Path:
        """epoch_{epoch:03d} + refreshed ``last`` (save_last semantics of
        configs/callbacks/model_checkpoint.yaml). ``state`` holds "trainable",
        "optimizer", "count", "bn_state", "step" and "epoch".

        ``last`` is a symlink to the newest epoch directory, swapped atomically.
        ``save_top_k > 0`` keeps only the newest k epoch checkpoints (monitor:
        null in the reference default, so "top" = newest); it deletes only
        directories whose names parse as epochs.

        In a ``torch.distributed`` group every rank calls this: rank 0 writes,
        then every rank meets in one collective that also tells them whether
        the write failed, and all of them raise if it did."""
        path = self.ckpt_dir / f"epoch_{epoch:03d}"
        error: Optional[BaseException] = None
        if is_host_zero():
            try:
                self._write_epoch(path, state)
            except Exception as exc:  # noqa: BLE001 — raised below, on every rank
                error = exc
        if any_rank(error is not None):
            if error is not None:
                raise error
            raise RuntimeError(f"rank 0 failed to write the checkpoint {path}")
        return path

    def _write_epoch(self, path: Path, state: Dict[str, Any]) -> None:
        write_state(path, state)
        if self.save_last:
            last = self.ckpt_dir / "last"
            link = self.ckpt_dir / ".last.tmp"
            if link.is_symlink() or link.exists():
                link.unlink()
            link.symlink_to(path.name)
            link.replace(last)  # atomic swap
        if self.save_top_k and self.save_top_k > 0:
            epochs = self._epoch_dirs()
            for old in epochs[: -self.save_top_k]:
                shutil.rmtree(old, ignore_errors=True)

    def _epoch_dirs(self) -> list:
        """The epoch_* directories whose basenames parse as epochs, in NUMERIC
        order (lexicographic order breaks past the 3-digit padding: epoch_1000 <
        epoch_999). An unparseable epoch_* entry (epoch_backup) is never listed,
        so retention never deletes it."""
        parsed = [(self.epoch_of(p), p) for p in self.ckpt_dir.glob("epoch_*") if p.is_dir()]
        return [p for e, p in sorted((e, p) for e, p in parsed if e is not None)]

    def restore(self, path: str | Path, device="cpu") -> Dict[str, Any]:
        """A checkpoint directory (or ``last``) of the port or an Orbax one of
        the JAX package -> its state, tensors on ``device``; the BN statistics
        as a ``BNState``; "optimizer" None where the directory has no
        optimizer state."""
        return restore_state(path, device)

    def latest(self) -> Optional[Path]:
        last = self.ckpt_dir / "last"
        if last.is_dir():
            return last
        epochs = self._epoch_dirs()
        return epochs[-1] if epochs else None

    def epoch_of(self, path: str | Path) -> Optional[int]:
        """Epoch number of a checkpoint dir, parsed from its BASENAME only —
        matching anywhere in the absolute path would key every child off a
        run dir that happens to contain an 'epoch_<n>' token."""
        match = re.fullmatch(r"epoch_(\d+)", Path(path).name)
        return int(match.group(1)) if match else None


def save_ncentroid(run_dir: str | Path, ncentroid: np.ndarray) -> Path:
    path = Path(run_dir) / "ncentroid.npy"
    np.save(path, np.asarray(ncentroid))
    return path


def load_ncentroid(run_dir: str | Path) -> Optional[np.ndarray]:
    path = Path(run_dir) / "ncentroid.npy"
    return np.load(path) if path.is_file() else None


def restore_state(path: str | Path, device="cpu") -> Dict[str, Any]:
    """``CheckpointManager.restore`` of one directory: the port's ``state.pt``
    or an Orbax directory of the JAX package."""
    path = Path(path)
    state_file = path / STATE_FILE
    if state_file.is_file():
        return _from_saved(torch.load(state_file, map_location=device, weights_only=True))
    if orbax_reader.is_orbax_checkpoint(path):
        return state_from_orbax(orbax_reader.read_tree(path), device)
    raise FileNotFoundError(f"{path} holds neither {STATE_FILE} nor an Orbax checkpoint")


def _scalar(x) -> int:
    return int(np.asarray(x).reshape(-1)[0])


def _like(structure: Any, tree: Any, where: str) -> Any:
    """The leaves of ``tree`` at the paths of ``structure``'s leaves, in
    ``structure``'s order: an optax moment tree read for one parameter tree."""
    if isinstance(structure, dict):
        if not isinstance(tree, dict) or set(tree) != set(structure):
            raise ValueError(f"optimizer state at {where} does not have the parameters' keys")
        return {k: _like(v, tree[k], f"{where}/{k}") for k, v in structure.items()}
    if isinstance(structure, list):
        if not isinstance(tree, list) or len(tree) != len(structure):
            raise ValueError(f"optimizer state at {where} does not have the parameters' length")
        return [_like(v, t, f"{where}/{i}") for i, (v, t) in enumerate(zip(structure, tree))]
    if tree is None or np.shape(tree) != np.shape(structure):
        raise ValueError(f"optimizer state at {where} has no moment of the parameter's shape")
    return tree


def adamw_state_from_optax(opt_state: Dict[str, Any], trainable: Dict[str, Any]) -> Tuple[Dict, int]:
    """The JAX package's optax state (as ``orbax_reader.read_tree`` gives it)
    for the JAX ``trainable`` tree -> (a ``torch.optim.AdamW`` state dict over
    the leaves of ``params_from_jax(trainable)`` in their order, grouped by
    top-level key as ``optim.build_optimizer`` groups them, and the updates
    applied so far). Only the moments and steps are carried: the optimizer's
    hyperparameters are the session's, as in the JAX package."""
    inner = opt_state.get("inner_states") if isinstance(opt_state, dict) else None
    if not isinstance(inner, dict):
        raise ValueError("optimizer state is not an optax.multi_transform state (no inner_states)")
    state, groups, counts, index = {}, [], set(), 0
    for key, subtree in trainable.items():
        name = GROUP_OF_KEY[key]
        adam = ((inner.get(name) or {}).get("inner_state") or [None])[0]
        if not isinstance(adam, dict) or {"count", "mu", "nu"} - set(adam):
            raise ValueError(f"optimizer state of group {name!r} is not optax.adamw's")
        count = _scalar(adam["count"])
        counts.add(count)
        mu = params_from_jax(_like(subtree, adam["mu"][key], f"{name}/mu/{key}"), device="cpu")
        nu = params_from_jax(_like(subtree, adam["nu"][key], f"{name}/nu/{key}"), device="cpu")
        params = []
        for m, v in zip(tree_leaves(mu), tree_leaves(nu)):
            state[index] = {"step": torch.tensor(float(count)), "exp_avg": m, "exp_avg_sq": v}
            params.append(index)
            index += 1
        groups.append({"params": params, "name": name})
    if len(counts) != 1:
        raise ValueError(f"optimizer groups disagree on their update count: {sorted(counts)}")
    return {"state": state, "param_groups": groups}, counts.pop()


def state_from_orbax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """An Orbax checkpoint tree of the JAX package (``orbax_reader.read_tree``:
    trainable, bn_mean, bn_var, step, epoch and, from a fit, opt_state) -> the
    keys ``CheckpointManager.save_epoch`` takes, the trainable tree and BN
    state on ``device``, the optimizer state on the CPU (``load_state_dict``
    moves the moments to their parameters)."""
    missing = {"trainable", "bn_mean", "bn_var", "step", "epoch"} - set(tree)
    if missing:
        raise ValueError(f"not a checkpoint of the JAX package: no {sorted(missing)}")
    optimizer, count = None, 0
    if tree.get("opt_state") is not None:
        optimizer, count = adamw_state_from_optax(tree["opt_state"], tree["trainable"])
    return {
        "trainable": params_from_jax(tree["trainable"], device=device),
        "optimizer": optimizer,
        "count": count,
        "bn_state": BNState(mean=torch.tensor(np.asarray(tree["bn_mean"], np.float32), device=device),
                            var=torch.tensor(np.asarray(tree["bn_var"], np.float32), device=device)),
        "step": _scalar(tree["step"]),
        "epoch": _scalar(tree["epoch"]),
    }
