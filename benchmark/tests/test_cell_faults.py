"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven at a tiny
size on the CPU, under the limits of the fp32 cells (the faults a cell can
have: an answer altered where it is produced, half of the batch left out and
the mean taken over the rest, a step that returns its state unchanged; no cell
spans chips, so no exchange between chips can be left out)."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark.cells import load_driver, load_limits
from benchmark.run import execute, judge
from benchmark.tests.tiny import tiny_cell

SEED = 2**31 + 4242


def run(kind: str, workload: str):
    cell = tiny_cell(kind, limits=load_limits(workload))
    start = time.perf_counter()
    out = execute(cell, SEED, 0.3, False, torch.device("cpu"), lambda: time.perf_counter() - start)
    return judge(out["numbers"], cell.limits)


def altered_answer(monkeypatch):
    """Every third frame's score moved where the evaluator produces it, so
    that each grid the check samples holds a moved answer."""
    from anomalyclip_tpu_torch.eval import evaluator

    original = evaluator.score_sampled_features

    def altered(*args, **kwargs):
        sim, sc, probs = original(*args, **kwargs)
        sc = sc.copy()
        sc[1::3] += np.where(sc[1::3] < 0.5, 0.25, -0.25)
        return sim, sc, probs

    monkeypatch.setattr(evaluator, "score_sampled_features", altered)


def half_of_each_chunk(monkeypatch):
    """The encoder leaves out the second half of every chunk and gives it the
    mean of the first half's features."""
    from anomalyclip_tpu_torch.eval import evaluator

    original = evaluator.encode_frames_chunked

    def halved(encode, frames, device, *args, **kwargs):
        feats = original(encode, frames[: max(1, len(frames) // 2)], device, *args, **kwargs)
        rest = np.repeat(feats.mean(axis=0, keepdims=True), len(frames) - len(feats), axis=0)
        return np.concatenate([feats, rest])

    monkeypatch.setattr(evaluator, "encode_frames_chunked", halved)


def unchanged_state(monkeypatch):
    """The update counts its step and leaves every parameter as it was."""
    from anomalyclip_tpu_torch.train import optim

    def skipped(self):
        self.count += 1

    monkeypatch.setattr(optim.GroupedAdamW, "step", skipped)


def half_batch(monkeypatch):
    from anomalyclip_tpu_torch.train import module

    monkeypatch.setattr(module, "prepare_batch", load_driver("train").halved(module.prepare_batch))


@pytest.mark.parametrize("kind,workload", [("clips", "vitb16-clips-fp32"), ("train", "vitb16-train-fp32")])
def test_the_sound_run_is_correct(kind, workload):
    correct, checks = run(kind, workload)
    assert correct, checks


@pytest.mark.parametrize("kind,workload,fault", [
    ("clips", "vitb16-clips-fp32", altered_answer),
    ("clips", "vitb16-clips-fp32", half_of_each_chunk),
    ("train", "vitb16-train-fp32", unchanged_state),
    ("train", "vitb16-train-fp32", half_batch),
], ids=["clips-altered-answer", "clips-half-chunk", "train-unchanged-state", "train-half-batch"])
def test_a_broken_path_is_not_correct(kind, workload, fault, monkeypatch):
    fault(monkeypatch)
    correct, checks = run(kind, workload)
    assert not correct, checks
