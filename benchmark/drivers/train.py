"""Mix kind ``train``: UCF-Crime steps from CLIP features in host memory
through ``fit_steps``.

The mix's parameters: ``pool_batches`` seeded batches of CLIP features,
cycled; each batch ``half_batch`` abnormal videos (labels drawn from the
abnormal classes) then as many normal ones, ``num_segments * seg_length``
frames of ``embed_dim`` features each (``feature_std`` their spread), in fp32
host memory, from the schedule's epoch ``start_epoch``; the first
``check_steps`` are compared and ``trace_steps`` traced.

Set-up makes the weights, the ncentroid and the feature pool from the seed,
builds one training state and drives it through its first ``check_steps``
steps by the window's own call and feed (``fit_steps``, ``prepare_batch``),
reading each step's loss, the first gradient from AdamW's first moment after
one step, and the trainable leaves after the last; the same state then goes
on into the window, which takes steps until ``--seconds`` have passed and
ends with the epoch it is in. After the peak memory is read and the state is
freed, the plain reference takes the same first steps from the same trees,
batches and dropout masks and is compared.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from benchmark import program, weights, work
from benchmark.reference.precision import Products
from benchmark.reference.train import Trainer as ReferenceTrainer
from benchmark.reference.train import _leaves, keep_masks, leaf_names
from benchmark.session import Phases, free, memory_peak
from benchmark.trace import Reading, traced

BETA1 = 0.9  # AdamW's first-moment decay: after one step exp_avg = (1 - BETA1) * gradient


def feature_pool(mix: dict, cfg: dict, seed: int, device) -> list:
    """``pool_batches`` batches (abnormal features, abnormal labels, normal
    features, normal labels) as numpy arrays in host memory."""
    model = cfg["model"]
    half, frames = mix["half_batch"], model["num_segments"] * model["seg_length"]
    dim = cfg["clip"]["embed_dim"]
    gen = weights.generator(seed, "features", device)
    feats = torch.randn((mix["pool_batches"], 2, half, frames, dim), generator=gen, device=device)
    feats = feats.mul_(mix["feature_std"]).cpu().numpy()
    abnormal = [i for i in range(len(cfg["classnames"])) if i != model["normal_id"]]
    rng = np.random.default_rng([int(seed), 29])
    batches = []
    for i in range(mix["pool_batches"]):
        labels = np.asarray(abnormal)[rng.integers(0, len(abnormal), half)]
        batches.append((feats[i, 0], labels.astype(np.int64), feats[i, 1],
                        np.full(half, model["normal_id"], np.int64)))
    return batches


def cycle_batches(batches: list) -> Iterator[tuple]:
    while True:
        yield from batches


def until(stream, deadline: float):
    """The stream's batches until the host clock passes ``deadline``."""
    for batch in stream:
        if time.perf_counter() >= deadline:
            return
        yield batch


def snapshot(tree) -> List[torch.Tensor]:
    return [leaf.detach().clone() for leaf in _leaves(tree)]


def first_steps(trainer, batches: list, gen: torch.Generator, steps: int) -> dict:
    """The first ``steps`` steps of ``trainer`` -> their losses, the first
    gradients as AdamW got them and the trainable leaves after the last step."""
    before = snapshot(trainer.state.trainable)
    seen: Dict[str, object] = {"losses": []}

    def on_step(state, terms):
        seen["losses"].append(terms.total)
        if len(seen["losses"]) == 1:
            seen["grads"] = [trainer.first_moment(p).detach() / (1 - BETA1) for p in _leaves(state.trainable)]
        if len(seen["losses"]) == steps:
            seen["after"] = snapshot(state.trainable)

    trainer.fit(batches[:steps], gen, epochs=steps, on_step=on_step)
    return {"losses": [float(t) for t in seen["losses"]], "grads": [g.clone() for g in seen["grads"]],
            "change": [a - b for a, b in zip(seen["after"], before)]}


def reference_steps(cfg: dict, clip_text: dict, trainable: dict, bn: tuple, ncentroid: torch.Tensor,
                    batches: list, seed: int, first_step: int, steps: int, device, mode: str = "fp32") -> dict:
    ref = ReferenceTrainer(trainable, bn, cfg, first_step, Products(mode))
    before = snapshot(ref.trainable)
    gen = weights.generator(seed, "masks", device)
    losses, grads = [], None
    for abn, abn_labels, nor, nor_labels in batches[:steps]:
        features = torch.from_numpy(np.concatenate([abn, nor])).to(device)
        labels = torch.from_numpy(np.concatenate([abn_labels, nor_labels])).to(device)
        loss, step_grads = ref.step(clip_text, features, labels, ncentroid.to(device),
                                    keep_masks(gen, len(labels), cfg))
        losses.append(loss)
        grads = step_grads if grads is None else grads
    return {"losses": losses, "grads": grads, "change": [a - b for a, b in zip(snapshot(ref.trainable), before)]}


def leaf_gap(program_norms: List[float], reference_norms: List[float], keep: Optional[List[bool]] = None) -> tuple:
    """The worst leaf's gap between the two sides' norms, over the reference's
    norm of that leaf or of the median leaf, whichever is larger -> (gap, leaf index)."""
    keep = keep or [True] * len(reference_norms)
    counted = [r for r, k in zip(reference_norms, keep) if k]
    median = float(np.median(counted))
    worst, at = 0.0, -1
    for i, (p, r) in enumerate(zip(program_norms, reference_norms)):
        if keep[i]:
            gap = abs(p - r) / max(r, median)
            if not np.isfinite(gap) or gap > worst:
                worst, at = (gap if np.isfinite(gap) else float("inf")), i
    return worst, at


def compare(prog: dict, ref: dict, names: List[str]) -> tuple:
    """-> (numbers, notes). Leaves whose first reference gradient is under a
    thousandth of the median leaf's move by round-off alone and are left out of
    the change."""
    losses = [abs(p - r) / abs(r) if np.isfinite(p) else float("inf") for p, r in zip(prog["losses"], ref["losses"])]
    norms = lambda ts: [float(t.float().norm()) for t in ts]  # noqa: E731
    ref_grad = norms(ref["grads"])
    median = float(np.median(ref_grad))
    moving = [g >= 1e-3 * median for g in ref_grad]
    grad_gap, grad_at = leaf_gap(norms(prog["grads"]), ref_grad)
    change_gap, change_at = leaf_gap(norms(prog["change"]), norms(ref["change"]), moving)
    numbers = {"loss_gap": max(losses), "grad_gap": grad_gap, "change_gap": change_gap}
    notes = {"grad_leaf": names[grad_at] if grad_at >= 0 else None,
             "change_leaf": names[change_at] if change_at >= 0 else None,
             "still_leaves": [n for n, m in zip(names, moving) if not m]}
    return numbers, notes


def run(cell, seed: int, seconds: float, trace: bool, device, setup_clock: Callable[[], float]) -> dict:
    """One run of a training cell -> the outcome ``run.py`` reports."""
    cfg, mix = cell.config, cell.mix
    phases = Phases(setup_clock)
    clip = weights.clip_tree(cfg, seed, device, visual=False)
    trainable, bn, ncentroid = weights.head_trees(cfg, seed, device, clip["text"]["text_projection"])
    phases.mark("weights", device)
    batches = feature_pool(mix, cfg, seed, device)
    phases.mark("features", device)
    first_step = mix["start_epoch"] * cfg["epoch_steps"]
    trainer = program.Trainer(cfg, clip, trainable, bn, ncentroid, first_step, device)
    phases.mark("trainer", device)
    gen = weights.generator(seed, "masks", device)
    steps = mix["check_steps"]
    prog = first_steps(trainer, batches, gen, steps)
    phases.mark("first_steps", device)
    setup_s = setup_clock()

    count = {"steps": 0}

    def on_step(state, terms):
        count["steps"] += 1

    def window(limit_steps: Optional[int] = None):
        stream = itertools.islice(cycle_batches(batches), steps, None)
        if limit_steps is not None:
            stream = itertools.islice(stream, limit_steps)
        start = time.perf_counter()
        trainer.fit(until(stream, start + seconds), gen, epochs=10**9, on_step=on_step)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - start

    reading: Optional[Reading] = None
    if trace:
        reading = traced(lambda: count.update(steps=0) or window(mix["trace_steps"]), device)
        window_s = reading.window_s
        batch = 2 * mix["half_batch"]
        reading.counters.update(steps=count["steps"])
        reading.work.update(
            flops=count["steps"] * work.train_step_flops(cfg, batch), peak_flops=work.PEAK_FLOPS[cell.dtype],
            attention_bound_s=count["steps"] * (
                work.text_attention_bound_s(cfg["clip"], len(cfg["classnames"]), "fwd", cell.dtype)
                + work.text_attention_bound_s(cfg["clip"], len(cfg["classnames"]), "bwd", cell.dtype)
                + work.temporal_attention_bound_s(cfg, batch, "fwd")
                + work.temporal_attention_bound_s(cfg, batch, "bwd")))
    else:
        window_s = window()
    peak = memory_peak(device)
    names = leaf_names(trainer.state.trainable)
    del trainer
    free()

    start = time.perf_counter()
    ref = reference_steps(cfg, clip["text"], trainable, bn, ncentroid, batches, seed, first_step, steps, device)
    phases.times["reference"] = time.perf_counter() - start
    numbers, notes = compare(prog, ref, names)
    done = count["steps"]
    return {
        "end_to_end": {"train_step_ms": window_s * 1e3 / max(done, 1), "setup_s": setup_s},
        "attempted": done, "failed": 0, "numbers": numbers, "memory_peak_bytes": peak,
        "reading": reading, "notes": {"steps": done, "window_s": window_s, "seconds": phases.times, **notes},
    }


def halved(prepare):
    """``prepare_batch`` keeping only the first half of each half-batch: half of
    the batch is left out and every mean is taken over the rest."""

    def prepare_half(batch, device):
        keep = len(batch.abnormal_labels) // 2
        return prepare(type(batch)(*(x[:keep] for x in batch)), device)

    return prepare_half


@contextlib.contextmanager
def half_batch_fault():
    """The program's upload halved (``halved``) inside the scope."""
    from anomalyclip_tpu_torch.train import module

    original = module.prepare_batch
    module.prepare_batch = halved(original)
    try:
        yield
    finally:
        module.prepare_batch = original


def controls(cell) -> List[str]:
    """The control (the reference in TF32 in the program's place) and the
    fault a training cell can have, planted in the program: half of each batch
    left out. A state left unchanged reads 1 and needs no run."""
    return ["tf32", "half_batch"]


def reading(cell, seed: int, device, mode: str) -> dict:
    """The numbers a run compares, from its first steps alone (no window):
    ``mode`` "program", "half_batch" (the fault planted in the program) or
    "tf32" (the reference in TF32 in the program's place)."""
    cfg, mix = cell.config, cell.mix
    clip = weights.clip_tree(cfg, seed, device, visual=False)
    trainable, bn, ncentroid = weights.head_trees(cfg, seed, device, clip["text"]["text_projection"])
    batches = feature_pool(mix, cfg, seed, device)
    first_step = mix["start_epoch"] * cfg["epoch_steps"]
    steps = mix["check_steps"]
    names = leaf_names(trainable)
    if mode == "tf32":
        side = reference_steps(cfg, clip["text"], trainable, bn, ncentroid, batches, seed, first_step, steps,
                               device, mode="tf32")
    else:
        trainer = program.Trainer(cfg, clip, trainable, bn, ncentroid, first_step, device)
        with half_batch_fault() if mode == "half_batch" else contextlib.nullcontext():
            side = first_steps(trainer, batches, weights.generator(seed, "masks", device), steps)
        del trainer
        free()
    ref = reference_steps(cfg, clip["text"], trainable, bn, ncentroid, batches, seed, first_step, steps, device)
    numbers, notes = compare(side, ref, names)
    return {"numbers": numbers, **notes}
