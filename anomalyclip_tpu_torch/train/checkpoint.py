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
"""

from __future__ import annotations

import re
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from anomalyclip_tpu_torch.models.selector import BNState
from anomalyclip_tpu_torch.parallel.mesh import any_rank
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
        """A checkpoint directory (or ``last``) -> its state, tensors on
        ``device``; the BN statistics as a ``BNState``."""
        path = Path(path)
        state_file = path / STATE_FILE
        if not state_file.is_file():
            raise FileNotFoundError(f"{path} holds no {STATE_FILE}")
        raw = torch.load(state_file, map_location=device, weights_only=True)
        return _from_saved(raw)

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
