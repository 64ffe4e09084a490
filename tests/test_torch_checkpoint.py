"""The port's checkpoints, resume, preemption, metric loggers and test
artifacts, on the CPU (the counterparts of tests/test_review_fixes.py:26, 43,
55, 82, 130 and tests/test_preempt.py, on the port alone):

- the CSV logger keeps its history on resume, and a new field keeps the old rows;
- ``CheckpointManager``: ``save_top_k`` retention, ``last`` a symlink, numeric
  order by basename, an unparseable ``epoch_backup`` directory kept, the
  optimizer's state round-tripped through ``torch.save``;
- ``ncentroid.npy`` is never written or trusted by a limited pass;
- one epoch, then a resume to two, equals an uninterrupted two-epoch run to the
  bit: losses, weights, BN and optimizer state;
- a SIGTERM in epoch 1 saves the true epoch-0 boundary, not the state its next
  step updated in place; before any epoch it saves nothing; the handler is not
  installed under ``preempt_save=false`` or off the main thread;
- ``write_test_artifacts`` writes the four PNGs, and only ``metrics.json`` plus a
  warning when ``matplotlib`` does not import;
- ``load_state`` refuses an empty or incomplete Lightning ``.ckpt`` and an Orbax
  directory.
"""

from __future__ import annotations

import csv
import importlib.util
import signal
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from anomalyclip_tpu.config.compose import to_dict
from anomalyclip_tpu_torch.convert import as_trainable, tree_leaves
from anomalyclip_tpu_torch.eval import artifacts
from anomalyclip_tpu_torch.models.selector import BNState
from anomalyclip_tpu_torch.train import module as tmod
from anomalyclip_tpu_torch.train.checkpoint import STATE_FILE, CheckpointManager
from anomalyclip_tpu_torch.train.optim import build_optimizer
from anomalyclip_tpu_torch.utils.logging import CSVMetricLogger


def _load_helper(name: str):
    """tests/helpers/<name>.py loaded by its path: an installed package named
    ``tests`` may shadow this repository's."""
    path = Path(__file__).resolve().parent / "helpers" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_test_torch_checkpoint_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


synthetic_cfg = _load_helper("synthetic_run").synthetic_cfg
NO_DROPOUT = ("model.net.select_idx_dropout_topk=0.0", "model.net.select_idx_dropout_bottomk=0.0")


def port_module(root: Path, run: str, *overrides: str) -> tmod.AnomalyCLIPTrainModule:
    """The port's module on the CPU over the synthetic corpus under ``root``
    (shared between runs), with its own run directory ``root / run``."""
    cfg = synthetic_cfg(root, "data.num_workers=0", f"paths.output_dir={root / run}", *overrides)
    return tmod.AnomalyCLIPTrainModule(to_dict(cfg), device="cpu")


def logged_losses(module) -> dict:
    """epoch -> the loss means the run logged to its CSV file."""
    rows = list(csv.DictReader(open(module.save_dir / "csv" / "metrics.csv")))
    return {int(r["step"]): {k: float(r[k]) for k in tmod.METRIC_NAMES} for r in rows if r.get("train/loss")}


def _state(seed: int):
    g = torch.Generator().manual_seed(seed)
    trainable = {"prompt_ctx": torch.randn(3, 4, generator=g), "temporal": {"w": torch.randn(5, generator=g)}}
    solver = {"lr": 1e-2, "prompt_learner_ratio": 1, "temporal_model_ratio": 2}
    opt = build_optimizer(as_trainable(trainable), solver, {}, {"warmup_epochs": 0}, 1)
    for leaf in tree_leaves([group["params"] for group in opt.optimizer.param_groups]):
        leaf.grad = torch.ones_like(leaf)
    opt.step()
    return {
        "trainable": trainable,
        "optimizer": opt.optimizer.state_dict(),
        "count": opt.count,
        "bn_state": BNState(torch.zeros(2), torch.ones(2)),
        "step": 3,
    }


# ---------------------------------------------------------------------------
# loggers
# ---------------------------------------------------------------------------


def test_csv_logger_preserves_history_on_resume(tmp_path):
    first = CSVMetricLogger(tmp_path)
    first.log_metrics({"train/loss": 1.0}, step=0)
    first.log_metrics({"train/loss": 0.5}, step=1)

    resumed = CSVMetricLogger(tmp_path)  # fresh logger, same dir
    resumed.log_metrics({"train/loss": 0.25}, step=2)

    rows = list(csv.DictReader(open(tmp_path / "csv" / "metrics.csv")))
    assert [r["step"] for r in rows] == ["0", "1", "2"]
    assert rows[0]["train/loss"] == "1.0"


def test_csv_logger_new_field_keeps_old_rows(tmp_path):
    logger = CSVMetricLogger(tmp_path)
    logger.log_metrics({"a": 1.0}, step=0)
    logger.log_metrics({"a": 2.0, "b": 3.0}, step=1)  # widens the schema
    rows = list(csv.DictReader(open(tmp_path / "csv" / "metrics.csv")))
    assert len(rows) == 2 and rows[0]["a"] == "1.0" and rows[1]["b"] == "3.0"


# ---------------------------------------------------------------------------
# the checkpoint manager
# ---------------------------------------------------------------------------


def test_checkpoint_retention_and_symlinked_last(tmp_path):
    mgr = CheckpointManager(tmp_path, save_top_k=2)
    state = _state(0)
    for epoch in range(4):
        mgr.save_epoch(epoch, {**state, "epoch": epoch})

    kept = sorted(p.name for p in (tmp_path / "checkpoints").glob("epoch_*"))
    assert kept == ["epoch_002", "epoch_003"]  # top-k=2 newest
    last = tmp_path / "checkpoints" / "last"
    assert last.is_symlink() and last.resolve().name == "epoch_003"

    restored = mgr.restore(mgr.latest())
    assert restored["epoch"] == 3 and restored["step"] == 3 and restored["count"] == 1
    assert isinstance(restored["bn_state"], BNState)
    for got, want in zip(tree_leaves(restored["trainable"]), tree_leaves(state["trainable"])):
        assert torch.equal(got, want)
    moments = restored["optimizer"]["state"]
    assert moments.keys() == state["optimizer"]["state"].keys()
    for i, entry in moments.items():
        for name, value in entry.items():
            assert torch.equal(value, state["optimizer"]["state"][i][name]), (i, name)
    assert restored["optimizer"]["param_groups"] == state["optimizer"]["param_groups"]


def test_checkpoint_ordering_numeric_and_pathname_proof(tmp_path):
    """Retention and latest() order epoch dirs NUMERICALLY by basename, also
    past the 3-digit padding and under a run dir named like an epoch."""
    run_dir = tmp_path / "epoch_2_rerun"
    mgr = CheckpointManager(run_dir, save_top_k=2)
    state = _state(1)
    for epoch in (998, 999, 1000, 1001):
        mgr.save_epoch(epoch, {**state, "epoch": epoch})

    kept = sorted(p.name for p in (run_dir / "checkpoints").glob("epoch_*"))
    assert kept == ["epoch_1000", "epoch_1001"]
    assert mgr.restore(mgr.latest())["epoch"] == 1001
    assert mgr.epoch_of("epoch_000") == 0  # falsy epoch 0 still parses


def test_retention_keeps_an_unparseable_epoch_dir(tmp_path):
    mgr = CheckpointManager(tmp_path, save_top_k=1)
    backup = tmp_path / "checkpoints" / "epoch_backup"
    backup.mkdir(parents=True)
    (backup / "notes.txt").write_text("kept")
    state = _state(2)
    for epoch in range(3):
        mgr.save_epoch(epoch, {**state, "epoch": epoch})
    assert sorted(p.name for p in (tmp_path / "checkpoints").glob("epoch_*")) == ["epoch_002", "epoch_backup"]
    assert (backup / "notes.txt").read_text() == "kept"
    assert mgr.epoch_of(backup) is None and mgr._epoch_dirs() == [tmp_path / "checkpoints" / "epoch_002"]


def test_ncentroid_limit_never_cached(tmp_path):
    """A truncated centroid pass (fast_dev_run) neither writes nor trusts the cache."""
    module = port_module(tmp_path, "run")
    module.compute_ncentroid(limit=1)
    assert not (module.save_dir / "ncentroid.npy").is_file()
    full = module.compute_ncentroid()
    assert (module.save_dir / "ncentroid.npy").is_file()
    before = np.load(module.save_dir / "ncentroid.npy")
    np.testing.assert_array_equal(before, full)
    module.ncentroid = None
    limited = module.compute_ncentroid(limit=1)
    assert not np.array_equal(limited, full)
    np.testing.assert_array_equal(np.load(module.save_dir / "ncentroid.npy"), before)


def test_load_state_refuses_lightning_and_orbax_inputs(tmp_path):
    """A Lightning ``.ckpt`` is read and converted since the converter was
    ported (tests/test_torch_entry.py): an empty one, or one without the
    model's weights, is refused. Orbax directories are not read yet."""
    module = port_module(tmp_path, "run")
    ckpt = tmp_path / "released.ckpt"
    ckpt.write_bytes(b"")
    with pytest.raises(EOFError):
        module.load_state(ckpt)
    torch.save({"state_dict": {"net.prompt_learner.ctx": torch.zeros(2, 8, 64)}}, ckpt)
    with pytest.raises(KeyError):
        module.load_state(ckpt)
    orbax_dir = tmp_path / "orbax_epoch_000"
    orbax_dir.mkdir()
    (orbax_dir / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="item 5"):
        module.load_state(orbax_dir)


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------


def test_resume_equals_an_uninterrupted_run_to_the_bit(tmp_path):
    one_step = ("trainer.limit_train_batches=1", *NO_DROPOUT)  # an epoch of one step keeps it short
    whole = port_module(tmp_path, "whole", "trainer.max_epochs=2", *one_step)
    whole.fit()
    first = port_module(tmp_path, "resumed", "trainer.max_epochs=1", *one_step)
    first.fit()
    last = first.ckpt.ckpt_dir / "last"
    resumed = port_module(tmp_path, "resumed", "trainer.max_epochs=2", f"ckpt_path={last}", *one_step)
    resumed.fit()

    assert logged_losses(resumed) == logged_losses(whole)  # the CSV kept epoch 0's row
    a, b = whole._final_state, resumed._final_state
    assert a.step == b.step and a.optimizer.count == b.optimizer.count
    for x, y in zip(tree_leaves(a.trainable) + list(a.bn_state), tree_leaves(b.trainable) + list(b.bn_state)):
        assert torch.equal(x, y)
    sa, sb = a.optimizer.optimizer.state_dict(), b.optimizer.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][i][name], sb["state"][i][name]), (i, name)
    for epoch in (0, 1):
        x = whole.ckpt.restore(whole.ckpt.ckpt_dir / f"epoch_{epoch:03d}")
        y = resumed.ckpt.restore(resumed.ckpt.ckpt_dir / f"epoch_{epoch:03d}")
        for u, v in zip(tree_leaves(x["trainable"]), tree_leaves(y["trainable"])):
            assert torch.equal(u, v)


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------


def _sigterm_after(module, when, captured=None):
    """Wrap the module's train step: ``when(n, state)`` after step n says
    whether to raise SIGTERM; ``captured`` collects the state after each step,
    copied."""
    build = module._build_train_step

    def build_hooked():
        step, taken = build(), [0]

        def hooked(*args):
            state, sums, terms = step(*args)
            taken[0] += 1
            if captured is not None:
                captured.append([t.detach().clone() for t in tree_leaves(state.trainable)])
            if when(taken[0], state):
                signal.raise_signal(signal.SIGTERM)
            return state, sums, terms

        return hooked

    module._build_train_step = build_hooked


def test_sigterm_saves_the_epoch_boundary_not_the_next_step(tmp_path):
    """SIGTERM after epoch 1's first step: the epoch-0 boundary is saved (by the
    preemption path: every_n_epochs=2 keeps the regular save off epoch 0), and
    it holds the weights at the end of epoch 0, not those the next step
    updated in place."""
    sentinel_called = []
    old = signal.signal(signal.SIGTERM, lambda s, f: sentinel_called.append(s))
    sentinel = signal.getsignal(signal.SIGTERM)
    try:
        module = port_module(tmp_path, "run", "trainer.max_epochs=3",
                             "callbacks.model_checkpoint.every_n_epochs=2", *NO_DROPOUT)
        steps_per_epoch = len(module.datamodule.train_dataloader())
        captured = []
        _sigterm_after(module, lambda n, state: n == steps_per_epoch + 1, captured)
        with pytest.raises(tmod.TrainingPreempted, match=r"saved boundary: epoch 0"):
            module.fit()
        assert signal.getsignal(signal.SIGTERM) is sentinel and not sentinel_called

        restored = module.ckpt.restore(module.ckpt.ckpt_dir / "last")
        assert restored["epoch"] == 0 and restored["step"] == steps_per_epoch
        assert restored["count"] == steps_per_epoch
        end_of_epoch_0, after_next_step = captured[steps_per_epoch - 1], captured[steps_per_epoch]
        saved = tree_leaves(restored["trainable"])
        assert all(torch.equal(x, y) for x, y in zip(saved, end_of_epoch_0))
        assert any(not torch.equal(x, y) for x, y in zip(saved, after_next_step))
        assert all(m["exp_avg"].abs().max() > 0 for m in restored["optimizer"]["state"].values())
    finally:
        signal.signal(signal.SIGTERM, old)


def test_sigterm_before_any_epoch_completed_saves_nothing(tmp_path):
    old = signal.getsignal(signal.SIGTERM)
    module = port_module(tmp_path, "run", "trainer.max_epochs=2")
    _sigterm_after(module, lambda n, state: n == 1)
    with pytest.raises(tmod.TrainingPreempted, match="before any epoch completed"):
        module.fit()
    assert signal.getsignal(signal.SIGTERM) is old
    assert not list(module.ckpt.ckpt_dir.iterdir())


@pytest.mark.parametrize("where", ["preempt_save=false", "off the main thread"])
def test_sigterm_handler_not_installed(tmp_path, monkeypatch, where):
    overrides = ["trainer.fast_dev_run=True"]
    if where == "preempt_save=false":
        overrides.append("trainer.preempt_save=false")
    module = port_module(tmp_path, "run", *overrides)
    installed = []
    real_signal = signal.signal

    def spy(signum, handler):
        installed.append(signum)
        return real_signal(signum, handler)

    monkeypatch.setattr(signal, "signal", spy)
    results = []
    if where == "off the main thread":
        thread = threading.Thread(target=lambda: results.append(module.fit()))
        thread.start()
        thread.join()
    else:
        results.append(module.fit())
    assert installed == [] and "auc_roc" in results[0]


# ---------------------------------------------------------------------------
# test artifacts
# ---------------------------------------------------------------------------


def _outputs():
    rng = np.random.default_rng(0)
    labels = np.repeat([3, 0, 3, 1, 3, 2], 50)
    scores = rng.random(len(labels)).astype(np.float32)
    class_probs = rng.random((len(labels), 3)).astype(np.float32)
    return scores, labels, class_probs


@pytest.mark.parametrize("matplotlib", ["present", "absent"])
def test_write_test_artifacts(tmp_path, monkeypatch, matplotlib):
    warned = []
    monkeypatch.setattr(artifacts.log, "warning", warned.append)
    if matplotlib == "absent":
        monkeypatch.setitem(sys.modules, "matplotlib", None)  # its import raises ImportError
    scores, labels, class_probs = _outputs()
    args = (scores, labels, class_probs, 3, 4, ["a", "b", "c", "Normal"])
    metrics = artifacts.write_test_artifacts(tmp_path, *args)
    assert metrics == artifacts.write_test_artifacts(tmp_path / "none", *args, write_files=False)
    assert not (tmp_path / "none").exists()
    assert (tmp_path / "metrics.json").is_file()
    written = sorted(p.name for p in tmp_path.glob("*.png"))
    if matplotlib == "present":
        assert written == sorted(artifacts.PLOTS) and warned == []
    else:
        assert written == [] and len(warned) == 1
        assert all(name in warned[0] for name in artifacts.PLOTS)


def test_checkpoint_file_is_the_state_file(tmp_path):
    module = port_module(tmp_path, "run", "trainer.max_epochs=1")
    module.fit()
    epoch_dir = module.ckpt.ckpt_dir / "epoch_000"
    assert sorted(p.name for p in epoch_dir.iterdir()) == [STATE_FILE]
    raw = torch.load(epoch_dir / STATE_FILE, weights_only=True)
    assert sorted(raw) == ["bn_mean", "bn_var", "count", "epoch", "optimizer", "step", "trainable"]
    state = module.load_state(module.ckpt.ckpt_dir / "last")
    assert state.optimizer is None and state.step == raw["step"]
