"""The training step and its neighbours: the counterpart of the step-level parts
of anomalyclip_tpu/train/module.py.

- ``compute_ncentroid``: the mean CLIP feature over every frame of the normal
  training videos, accumulated in fp64 with padding frames dropped;
- ``prepare_batch``: a ``TrainBatch`` of numpy halves -> tensors on the device,
  the ncrops axis squeezed;
- ``build_train_step``: abnormal half first -> ``forward_train`` ->
  ``compute_loss`` -> ``backward`` (through the attention kernels' backwards on
  the card) -> AdamW update of the trainable leaves in place, the BN running
  state replaced, the loss terms added to on-device sums;
- ``fit_steps``: a loop over a stream of batches, grouped into epochs, moving
  the metric sums to the host once an epoch.

Validation, early stopping, checkpoints, preemption and loggers (the rest of the
JAX ``fit``) are not ported yet.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from anomalyclip_tpu_torch.data.loader import TrainBatch
from anomalyclip_tpu_torch.convert import as_trainable
from anomalyclip_tpu_torch.models.anomaly_clip import AnomalyCLIP
from anomalyclip_tpu_torch.models.losses import LossConfig, LossTerms, compute_loss
from anomalyclip_tpu_torch.models.selector import BNState
from anomalyclip_tpu_torch.numerics import matmul_precision_for
from anomalyclip_tpu_torch.train.optim import GroupedAdamW, build_optimizer

# metric name -> LossTerms field
METRIC_NAMES = {
    "train/loss": "total",
    "train/dir_abn_loss": "ldir_abn",
    "train/dir_nor_loss": "ldir_nor",
    "train/topk_abn_loss": "ltopk_abn",
    "train/bottomk_abn_loss": "lbottomk_abn",
    "train/topk_nor_loss": "ltopk_nor",
    "train/smooth_loss": "lsmooth",
    "train/sparse_loss": "lsparse",
}


@dataclasses.dataclass
class TrainState:
    """The trainable leaves (updated in place by ``optimizer``), the selector's
    BN running state and the number of steps taken."""

    trainable: Dict[str, Any]
    optimizer: GroupedAdamW
    bn_state: BNState
    step: int = 0


def init_state(
    trainable: Dict[str, Any],
    bn_state: BNState,
    solver_cfg: Dict[str, Any],
    optimizer_cfg: Dict[str, Any],
    scheduler_cfg: Dict[str, Any],
    steps_per_epoch: int,
) -> TrainState:
    """A state at step 0 from initial parameters (``model.init_trainable`` or a
    converted tree), on the device they are on. The trainable leaves are fresh
    copies, so the caller's tree is never updated."""
    trainable = as_trainable(trainable)
    optimizer = build_optimizer(
        trainable, solver_cfg, optimizer_cfg, scheduler_cfg, steps_per_epoch
    )
    return TrainState(trainable=trainable, optimizer=optimizer, bn_state=bn_state)


def zero_metric_sums(device) -> Dict[str, torch.Tensor]:
    return {name: torch.zeros((), device=device) for name in METRIC_NAMES}


def prepare_batch(batch: TrainBatch, device) -> TrainBatch:
    """numpy halves -> tensors on ``device``, a singleton ncrops axis squeezed
    ((b/2, 1, t, D) -> (b/2, t, D))."""

    def features(x):
        x = x[:, 0] if x.ndim >= 3 and x.shape[1] == 1 else x
        return torch.as_tensor(np.asarray(x)).to(device)

    def labels(y):
        return torch.as_tensor(np.asarray(y), dtype=torch.long).to(device)

    return TrainBatch(
        abnormal_features=features(batch.abnormal_features),
        abnormal_labels=labels(batch.abnormal_labels),
        normal_features=features(batch.normal_features),
        normal_labels=labels(batch.normal_labels),
    )


def build_train_step(model: AnomalyCLIP, loss_cfg: LossConfig):
    """-> train_step(frozen, state, batch, ncentroid, gen, metric_sums) ->
    (state, metric_sums, terms). ``batch`` comes from ``prepare_batch``; ``gen``
    draws the selector's dropout masks. The trainable leaves are updated in
    place; the returned state carries the new BN state and step count."""

    def train_step(
        frozen, state: TrainState, batch: TrainBatch, ncentroid, gen, metric_sums
    ):
        features = torch.cat([batch.abnormal_features, batch.normal_features])
        labels = torch.cat([batch.abnormal_labels, batch.normal_labels])
        state.optimizer.zero_grad()
        # the backward's products and convolutions need the forward's precision
        with matmul_precision_for(model.cfg.dtype):
            out, new_bn = model.forward_train(
                frozen, state.trainable, state.bn_state, features, labels, ncentroid, gen
            )
            terms = compute_loss(
                out.logits,
                out.logits_topk,
                labels,
                out.scores,
                out.idx_topk_abn,
                out.idx_topk_nor,
                out.idx_bottomk_abn,
                loss_cfg,
            )
            terms.total.backward()
        state.optimizer.step()
        # metrics accumulate on the device: one host transfer per epoch
        terms = LossTerms(*(t.detach() for t in terms))
        sums = {k: metric_sums[k] + getattr(terms, f) for k, f in METRIC_NAMES.items()}
        new_state = dataclasses.replace(state, bn_state=new_bn, step=state.step + 1)
        return new_state, sums, terms

    return train_step


def compute_ncentroid(videos: Iterable[Any], dim: int) -> np.ndarray:
    """Mean feature over every frame of ``videos`` -> (dim,) fp32.

    Each video has ``features`` (ncrops, t, D) and ``frame_labels`` (one per
    real frame), as the data package's test-mode items; frames past
    ``len(frame_labels)`` are padding and dropped. The sum is taken in fp64."""
    total = np.zeros(dim, dtype=np.float64)
    count = 0
    for item in videos:
        feats = np.asarray(item.features)
        flat = feats.reshape(-1, *feats.shape[2:])[: len(item.frame_labels)]
        total += flat.reshape(len(flat), -1).sum(axis=0, dtype=np.float64)
        count += len(flat)
    return (total / max(count, 1)).astype(np.float32)


def fit_steps(
    train_step,
    frozen,
    state: TrainState,
    batches: Iterable[TrainBatch],
    ncentroid: torch.Tensor,
    gen: torch.Generator,
    epochs: int,
    steps_per_epoch: int,
    on_step: Optional[Callable[[TrainState, LossTerms], None]] = None,
):
    """Take up to ``epochs * steps_per_epoch`` steps over ``batches`` (numpy
    ``TrainBatch``es, consumed in order; the loop ends early when they run out).
    ``on_step(state, terms)`` runs after every step. -> (state, one dict per
    epoch of the loss terms' means over its steps, on the host)."""
    device = ncentroid.device
    stream = iter(batches)
    history: List[Dict[str, float]] = []
    for _ in range(epochs):
        sums, count = zero_metric_sums(device), 0
        for batch in itertools.islice(stream, steps_per_epoch):
            state, sums, terms = train_step(
                frozen, state, prepare_batch(batch, device), ncentroid, gen, sums
            )
            count += 1
            if on_step is not None:
                on_step(state, terms)
        if count == 0:
            break
        history.append({k: float(v) / count for k, v in sums.items()})
    return state, history
