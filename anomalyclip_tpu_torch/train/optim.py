"""AdamW with per-component learning-rate groups and the warmup-cosine schedule:
the counterpart of anomalyclip_tpu/train/optim.py, on ``torch.optim.AdamW``.

- The trainable tree's top-level keys map to the reference's optimizer groups
  (``GROUP_OF_KEY``), each at ``solver.lr * <group>_ratio``. The selector group
  has a ratio for config parity but owns no parameters: its BatchNorm is
  non-affine.
- The schedule is the reference's WarmupCosineAnnealingLR, stepped per epoch:
  linear warmup from 0 over ``warmup_epochs`` (epoch 0 trains at lr=0, a
  reference quirk kept for parity), then cosine from the base lr to
  ``final_factor * base`` over ``total_epoch - warmup_epochs``, clamped at the end.
- Update k (counted from 0) runs at the schedule's value at k, as optax
  evaluates a schedule at the update count before incrementing it.

optax's ``adamw`` and ``torch.optim.AdamW`` apply the same update: bias-corrected
moments with betas (0.9, 0.999), eps outside the square root, and decoupled
weight decay ``lr * wd * p``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict

import torch

from anomalyclip_tpu_torch.convert import tree_leaves

# trainable tree top-level key -> reference optimizer group name
GROUP_OF_KEY = {
    "prompt_ctx": "prompt_learner",
    "text_projection": "text_projection",
    "temporal": "temporal_model",
}


def warmup_cosine_schedule(
    base_lr: float,
    warmup_epochs: int,
    total_epoch: int,
    steps_per_epoch: int,
    final_factor: float = 0.0,
    warmup_power: float = 1.0,
    warmup_lr: float = 0.0,
) -> Callable[[int], float]:
    """step -> lr. The factor is a function of the epoch, step // steps_per_epoch;
    during warmup lr = (epoch / warmup)**power * (base - warmup_lr) + warmup_lr."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        if epoch < warmup_epochs:
            progress = epoch / max(warmup_epochs, 1)
            return progress**warmup_power * (base_lr - warmup_lr) + warmup_lr
        progress = min((epoch - warmup_epochs) / max(total_epoch - warmup_epochs, 1), 1.0)
        cosine = (math.cos(math.pi * progress) + 1.0) / 2.0
        return base_lr * (cosine * (1.0 - final_factor) + final_factor)

    return schedule


def _schedule(base_lr: float, scheduler_cfg: Dict[str, Any], steps_per_epoch: int):
    return warmup_cosine_schedule(
        base_lr,
        int(scheduler_cfg.get("warmup_epochs", 0)),
        int(scheduler_cfg.get("total_epoch", 50)),
        steps_per_epoch,
        final_factor=float(scheduler_cfg.get("final_factor", 0.0)),
        warmup_power=float(scheduler_cfg.get("warmup_powers", 1.0)),
        # absolute per group in the reference: not scaled by the group's ratio
        warmup_lr=float(scheduler_cfg.get("warmup_lrs", 0.0)),
    )


def base_lr_schedule(
    solver_cfg: Dict[str, Any], scheduler_cfg: Dict[str, Any], steps_per_epoch: int
) -> Callable[[int], float]:
    """The base-lr schedule, group ratios excluded."""
    return _schedule(float(solver_cfg["lr"]), scheduler_cfg, steps_per_epoch)


class GroupedAdamW:
    """``torch.optim.AdamW`` with one parameter group per trainable top-level
    key, each group's lr set from its schedule before every update."""

    def __init__(self, optimizer: torch.optim.AdamW, schedules: Dict[str, Callable[[int], float]]):
        self.optimizer = optimizer
        self.schedules = schedules
        self.count = 0  # updates applied so far

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedules[group["name"]](self.count)
        self.optimizer.step()
        self.count += 1


def build_optimizer(
    trainable: Dict[str, Any],
    solver_cfg: Dict[str, Any],
    optimizer_cfg: Dict[str, Any],
    scheduler_cfg: Dict[str, Any],
    steps_per_epoch: int,
) -> GroupedAdamW:
    """AdamW (betas 0.9/0.999, eps 1e-8, ``weight_decay`` from the optimizer
    config, 0.2 by default) over the leaves of ``trainable``, which must
    require grad, grouped by top-level key."""
    base_lr = float(solver_cfg["lr"])
    groups, schedules = [], {}
    for key, subtree in trainable.items():
        name = GROUP_OF_KEY[key]
        ratio = float(solver_cfg.get(f"{name}_ratio", 1))
        groups.append({"params": tree_leaves(subtree), "name": name})
        schedules[name] = _schedule(base_lr * ratio, scheduler_cfg, steps_per_epoch)
    optimizer = torch.optim.AdamW(
        groups,
        lr=0.0,  # set per group from its schedule before each update
        betas=(0.9, 0.999),
        eps=1e-8,
        weight_decay=float(optimizer_cfg.get("weight_decay", 0.2)),
    )
    return GroupedAdamW(optimizer, schedules)
