"""The port's ``AnomalyCLIPTrainModule`` against the JAX package's, on the CPU.

- A 2-epoch synthetic ``fit()`` of both from the same initial state: the JAX
  module's frozen tree and the trees of its own ``init_state``, carried across
  by ``convert`` (``adopt_converted_state`` and an override of the port
  module's ``init_state``), dropout 0: per-epoch losses at rtol 5e-4,
  ``metrics_0.json`` and ``metrics_1.json`` within 1e-4 on AUC, AP, mAUC and
  mAP, ``ncentroid.npy`` at rtol 1e-5, then ``test(state=final)`` within 1e-4.
- The from-frames ncentroid (``data.load_from_features=false``, the tiny CLIP)
  against the JAX module's at rtol 1e-4.
- The rest of the fit loop on the port alone: ``fast_dev_run`` (no checkpoint,
  no cache), ``overfit_batches`` (``set_epoch(0)`` every epoch), early
  stopping under ``check_val_every_n_epoch=2`` (stale metrics burn no
  patience), ``exception.log`` on a failing fit, ``train/lr``, a pretrained
  CLIP read from ``clip_ckpt_path``, ``trainer.model_parallel`` in one
  process falling back to the single tower with a warning, RN50
  resolving and ``trainer.profiler=jax`` fitting with a trace.
- ``chip_smoke.py``'s UCF-Crime run config against the composed
  ``experiment=ucfcrime`` on every key the port's module reads.
"""

from __future__ import annotations

import csv
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from anomalyclip_tpu.config.compose import compose, to_dict
from anomalyclip_tpu.train import optim as joptim
from anomalyclip_tpu.train.module import AnomalyCLIPTrainModule as JaxModule
from anomalyclip_tpu_torch import convert
from anomalyclip_tpu_torch.data.datamodule import DataConfig
from anomalyclip_tpu_torch.models.anomaly_clip import AnomalyCLIPConfig
from anomalyclip_tpu_torch.models.clip.model import CLIPConfig
from anomalyclip_tpu_torch.models.losses import LossConfig
from anomalyclip_tpu_torch.train import module as tmod
from anomalyclip_tpu_torch.train.optim import base_lr_schedule

ROOT = Path(__file__).resolve().parents[1]


def _load_by_path(name: str, path: Path):
    """A module loaded by its path: an installed package named ``tests`` may
    shadow this repository's, and chip_smoke.py is no package."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module  # dataclasses look their module up there
    spec.loader.exec_module(module)
    return module


synthetic_cfg = _load_by_path("_test_torch_fit_synthetic_run",
                              ROOT / "tests" / "helpers" / "synthetic_run.py").synthetic_cfg
PARITY = ("trainer.max_epochs=2", "model.net.select_idx_dropout_topk=0.0",
          "model.net.select_idx_dropout_bottomk=0.0", "data.num_workers=0")
METRICS = ("auc_roc", "auc_pr", "mean_mc_auroc", "mean_mc_aupr")
LOSS_RTOL = 5e-4
METRIC_TOL = 1e-4


def _epoch_losses(run_dir: Path) -> dict:
    rows = list(csv.DictReader(open(run_dir / "csv" / "metrics.csv")))
    return {int(r["step"]): [float(r[k]) for k in tmod.METRIC_NAMES] for r in rows if r.get("train/loss")}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _adopt_jax_state(port: tmod.AnomalyCLIPTrainModule, jmod: JaxModule, trainable, bn_state):
    """The port module onto the JAX module's frozen tree, and its initial state
    onto the given JAX trees, through convert."""
    clip_cfg = CLIPConfig(**dataclasses.asdict(jmod.model.clip_cfg))
    frozen = convert.params_from_jax(_np(jmod.frozen), device="cpu")
    trainable = convert.params_from_jax(_np(trainable), device="cpu")
    bn = convert.bn_state_from_jax(bn_state, device="cpu")
    port.adopt_converted_state(frozen, trainable, bn, clip_cfg)
    model_cfg = port.cfg["model"]

    def init_state(steps_per_epoch):
        return tmod.init_state(trainable, bn, dict(model_cfg["solver"]), dict(model_cfg["optimizer"]),
                               dict(model_cfg["scheduler"]), steps_per_epoch)

    port.init_state = init_state


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """Both modules fitted for 2 epochs from the same state, then tested."""
    root = tmp_path_factory.mktemp("fit_parity")
    jcfg = synthetic_cfg(root, *PARITY, f"paths.output_dir={root / 'jax'}")
    jmod = JaxModule(jcfg)
    tx = joptim.build_optimizer(dict(jcfg.model.solver), dict(jcfg.model.optimizer),
                                dict(jcfg.model.scheduler), 1)
    jstate = jmod.init_state(tx)
    port = tmod.AnomalyCLIPTrainModule(
        to_dict(synthetic_cfg(root, *PARITY, f"paths.output_dir={root / 'port'}")), device="cpu")
    _adopt_jax_state(port, jmod, jstate.trainable, jstate.bn_state)

    jval, val = jmod.fit(), port.fit()
    jtest, test = jmod.test(state=jmod._final_state), port.test(state=port._final_state)
    return SimpleNamespace(jmod=jmod, port=port, jval=jval, val=val, jtest=jtest, test=test)


@pytest.mark.parametrize("epoch", [0, 1])
def test_fit_epoch_losses_match_jax(parity, epoch):
    got, want = _epoch_losses(parity.port.save_dir), _epoch_losses(parity.jmod.save_dir)
    assert sorted(got) == sorted(want) == [0, 1]
    np.testing.assert_allclose(got[epoch], want[epoch], rtol=LOSS_RTOL, atol=1e-7)


@pytest.mark.parametrize("epoch", [0, 1])
def test_fit_validation_metrics_match_jax(parity, epoch):
    got, want = (json.load(open(m.save_dir / f"metrics_{epoch}.json")) for m in (parity.port, parity.jmod))
    assert got["epoch"] == want["epoch"] == epoch
    np.testing.assert_allclose([got[k] for k in METRICS], [want[k] for k in METRICS], rtol=0, atol=METRIC_TOL)
    assert np.isfinite([got[k] for k in METRICS]).all()


def test_fit_ncentroid_and_checkpoints_match_jax(parity):
    np.testing.assert_allclose(np.load(parity.port.save_dir / "ncentroid.npy"),
                               np.load(parity.jmod.save_dir / "ncentroid.npy"), rtol=1e-5, atol=0)
    ckpts = parity.port.ckpt.ckpt_dir
    assert sorted(p.name for p in ckpts.iterdir()) == ["epoch_000", "epoch_001", "last"]
    assert parity.port.ckpt.restore(ckpts / "last")["epoch"] == 1
    # what fit returns is the last validation
    np.testing.assert_allclose([parity.val[k] for k in METRICS], [parity.jval[k] for k in METRICS],
                               rtol=0, atol=METRIC_TOL)


def test_test_pass_matches_jax(parity):
    np.testing.assert_allclose([parity.test[k] for k in METRICS], [parity.jtest[k] for k in METRICS],
                               rtol=0, atol=METRIC_TOL)
    for name in ("metrics.json", *("PR.png", "ROC.png", "F1.png", "confusion_matrix.png")):
        assert (parity.port.save_dir / name).is_file(), name


def test_fit_logs_lr_and_epoch_time(parity):
    rows = list(csv.DictReader(open(parity.port.save_dir / "csv" / "metrics.csv")))
    lr = {int(r["step"]): float(r["train/lr"]) for r in rows if r.get("train/lr")}
    schedule = base_lr_schedule(parity.port.cfg["model"]["solver"], parity.port.cfg["model"]["scheduler"], 2)
    assert lr == {0: schedule(0), 1: schedule(2)} and lr[0] == 0.0 < lr[1]
    assert all(float(r["train/epoch_time_s"]) > 0 for r in rows if r.get("train/epoch_time_s"))
    assert any(r.get("test/AUC") for r in rows) and any(r.get("model/params_trainable") for r in rows)


def test_from_frames_ncentroid_matches_jax(tmp_path):
    overrides = ("data.load_from_features=false", "data.input_size=32", "data.synthetic_num_normal=2",
                 "data.synthetic_num_abnormal=2", "data.synthetic_num_test=1", "data.synthetic_min_frames=40",
                 "data.synthetic_max_frames=80", "data.num_workers=0")
    jmod = JaxModule(synthetic_cfg(tmp_path, *overrides, f"paths.output_dir={tmp_path / 'jax'}"))
    want = jmod.compute_ncentroid()
    port = tmod.AnomalyCLIPTrainModule(
        to_dict(synthetic_cfg(tmp_path, *overrides, f"paths.output_dir={tmp_path / 'port'}")), device="cpu")
    trainable, bn = jmod.model.init_trainable(jax.random.PRNGKey(0), jmod.frozen)
    _adopt_jax_state(port, jmod, trainable, bn)
    assert not port.net_cfg.load_from_features
    got = port.compute_ncentroid()
    assert got.dtype == np.float32 and got.shape == (port.model.embedding_dim,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(np.load(port.save_dir / "ncentroid.npy"), got)


# ---------------------------------------------------------------------------
# the rest of the fit loop, on the port alone
# ---------------------------------------------------------------------------


def _port(root: Path, run: str, *overrides: str) -> tmod.AnomalyCLIPTrainModule:
    cfg = synthetic_cfg(root, "data.num_workers=0", f"paths.output_dir={root / run}", *overrides)
    return tmod.AnomalyCLIPTrainModule(to_dict(cfg), device="cpu")


def test_fast_dev_run_writes_no_checkpoint_and_no_cache(tmp_path):
    module = _port(tmp_path, "run", "trainer.fast_dev_run=True", "trainer.max_epochs=5")
    metrics = module.fit()
    assert "auc_roc" in metrics and module._final_state.step == 1
    assert not list(module.ckpt.ckpt_dir.iterdir())
    assert not (module.save_dir / "ncentroid.npy").exists()
    assert (module.save_dir / "metrics_0.json").is_file()


def test_overfit_batches_pins_the_epoch(tmp_path):
    module = _port(tmp_path, "run", "trainer.overfit_batches=1", "trainer.max_epochs=3")
    epochs, make = [], module.datamodule.train_dataloader

    def loader():
        it = make()
        set_epoch = it.set_epoch
        it.set_epoch = lambda e: (epochs.append(e), set_epoch(e))
        return it

    module.datamodule.train_dataloader = loader
    module.fit()
    assert epochs == [0, 0, 0] and module._final_state.step == 3


def test_early_stopping_counts_only_fresh_validations(tmp_path):
    """check_val_every_n_epoch=2, patience 2: AUC 0.5, 0.4, 0.3 at epochs 1, 3,
    5. Counting the stale epochs 2 and 4 would stop at epoch 3; counting fresh
    validations only, the second bad one comes at epoch 5."""
    module = _port(tmp_path, "run", "trainer.max_epochs=8", "trainer.check_val_every_n_epoch=2",
                   "trainer.limit_train_batches=1", "callbacks=early_stopping",
                   "callbacks.early_stopping.patience=2")
    aucs, seen = iter([0.5, 0.4, 0.3, 0.2]), []

    def validate(state, epoch, limit=None, should_stop=None):
        seen.append(epoch)
        return {"epoch": epoch, "auc_roc": next(aucs)}

    module.validate = validate
    module.fit()
    assert seen == [1, 3, 5]
    assert module._final_state.step == 6  # epochs 0-5 of one step each


def test_exception_log_on_a_failing_fit(tmp_path):
    module = _port(tmp_path, "run", "trainer.max_epochs=1")
    finalized = []
    finalize = module.loggers.finalize
    module.loggers.finalize = lambda: (finalized.append(True), finalize())

    def failing_step():
        def step(*args):
            raise RuntimeError("step failed on purpose")

        return step

    module._build_train_step = failing_step
    with pytest.raises(RuntimeError, match="on purpose"):
        module.fit()
    log = (module.save_dir / "exception.log").read_text()
    assert "Traceback" in log and "step failed on purpose" in log
    assert finalized == [True] and module._train_loader is None


@pytest.mark.parametrize("override, item", [
    ("trainer.model_parallel=2", "item 8"),
])
def test_unported_options_raise_at_init(tmp_path, override, item, monkeypatch):
    """``trainer.model_parallel=2`` raised here until ROADMAP.md section 1,
    ``item`` landed. In one process it now builds, and its first encode warns
    and runs on the single tower, as the JAX module does with too few devices
    (anomalyclip_tpu/train/module.py:196-201); tests/test_torch_tensor_parallel.py
    runs it on two ranks."""
    module = _port(tmp_path, "run", override)
    warned = []
    monkeypatch.setattr(tmod.log, "warning", warned.append)
    assert module.model_group is None and module._encode_fn() == module.model.encode_frames
    assert any("model_parallel=2 requested but only 1 device(s)" in w for w in warned), warned


def test_pretrained_clip_comes_from_clip_ckpt_path(tmp_path, monkeypatch):
    """``clip_init: pretrained`` reads the CLIP file the registry resolves; with
    no file to read and downloads switched off it names what it searched."""
    import torch

    from anomalyclip_tpu_torch.models.clip.convert import state_dict_from_params
    from anomalyclip_tpu_torch.models.clip.model import init_clip_params

    params = init_clip_params(torch.Generator().manual_seed(5), CLIPConfig.tiny())
    path = tmp_path / "clip.pt"
    torch.save(state_dict_from_params(params), path)
    module = _port(tmp_path, "run", "model.net.clip_init=pretrained", f"model.net.clip_ckpt_path={path}")
    for got, want in zip(convert.tree_leaves(module.frozen["clip"]), convert.tree_leaves(params), strict=True):
        assert torch.equal(got, want)
    monkeypatch.setenv("ANOMALYCLIP_NO_DOWNLOAD", "1")
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("CLIP_CKPT_PATH", raising=False)
    with pytest.raises(FileNotFoundError, match="No CLIP checkpoint found"):
        _port(tmp_path, "run2", "model.net.clip_init=pretrained")


def test_unported_options_raise_where_used(tmp_path):
    """RN50 and ``trainer.profiler=jax`` raised where used until they were
    ported (ROADMAP.md section 1). RN50 now resolves to the ModifiedResNet
    tower, and a profiled fit runs and writes one trace."""
    params, clip_cfg = tmod.resolve_clip("RN50", "random-full")  # ported: the ModifiedResNet tower
    assert clip_cfg == CLIPConfig.rn50() and clip_cfg.is_resnet and "stem" in params["visual"]
    # ported: a torch.profiler trace of the fit (tests/test_torch_profiler.py)
    module = _port(tmp_path, "run", "trainer.profiler=jax", "trainer.max_epochs=1")
    assert "auc_roc" in module.fit()
    assert len(list((module.save_dir / tmod.TRACE_DIR).glob("*.pt.trace.json"))) == 1


# ---------------------------------------------------------------------------
# chip_smoke.py's run config
# ---------------------------------------------------------------------------

# the keys the port's module reads, apart from the data, net and loss blocks
# (read as their dataclasses' fields) and the paths
READ_KEYS = (
    "seed", "ckpt_path",
    "trainer.model_parallel", "trainer.detect_anomaly", "trainer.fast_dev_run", "trainer.max_epochs",
    "trainer.overfit_batches", "trainer.limit_train_batches", "trainer.limit_val_batches",
    "trainer.limit_test_batches", "trainer.check_val_every_n_epoch", "trainer.preempt_save", "trainer.profiler",
    "model.solver", "model.optimizer.weight_decay", "model.scheduler.warmup_epochs",
    "model.scheduler.total_epoch", "model.scheduler.final_factor", "model.scheduler.warmup_powers",
    "model.scheduler.warmup_lrs", "model.net.arch", "model.net.clip_init", "model.net.quantize",
    "callbacks.model_checkpoint.save_top_k", "callbacks.model_checkpoint.save_last",
    "callbacks.model_checkpoint.every_n_epochs", "callbacks.model_summary", "callbacks.lr_logger",
    "callbacks.early_stopping", "data.synthetic",
)
PATHS = {"frames_root", "annotations_root", "annotation_file_normal", "annotation_file_anomaly",
         "annotation_file_test", "annotation_file_temporal_test", "labels_file"}


def _lookup(cfg: dict, dotted: str):
    node = cfg
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            return "<absent>"
        node = node[part]
    return node


def test_chip_smoke_fit_config_is_the_published_ucfcrime_run(tmp_path):
    chip_smoke = _load_by_path("_test_torch_fit_chip_smoke", ROOT / "chip_smoke.py")
    got = chip_smoke.ucf_fit_config(tmp_path / "features", tmp_path / "annotations", tmp_path / "run")
    want = to_dict(compose(ROOT / "configs", "train", ["experiment=ucfcrime"]))
    keys = list(READ_KEYS)
    for block, cls in (("data", DataConfig), ("model.net", AnomalyCLIPConfig), ("model.loss", LossConfig)):
        keys += [f"{block}.{f.name}" for f in dataclasses.fields(cls) if f.name not in PATHS]
    compared = 0
    for key in keys:
        if key in chip_smoke.FIT_OVERRIDES:
            assert _lookup(got, key) != _lookup(want, key), f"{key} is listed as an override but is not one"
            continue
        assert _lookup(got, key) == _lookup(want, key), key
        compared += 1
    assert compared > 60
    # the paths point into the phase's directories; the logger is the csv one there
    assert got["model"]["save_dir"] == str(tmp_path / "run")
    assert got["logger"] == {"csv": {"save_dir": str(tmp_path / "run"), "name": "csv"}}
    assert list(want["logger"]) == ["csv"]
    assert Path(got["data"]["labels_file"]).name == Path(want["data"]["labels_file"]).name
