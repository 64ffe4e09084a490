"""Logging: a host-zero console logger and pluggable metric backends. A copy
of anomalyclip_tpu/utils/logging.py without jax: host zero is rank 0 of
``torch.distributed``, or the only process when it is not initialized.

Replaces the reference's rank-zero pylogger + 7 Lightning logger backends
(reference: src/utils/pylogger.py:6-25, configs/logger/*). Backends degrade
gracefully: CSV always works; tensorboard (through tensorflow), wandb, mlflow,
neptune, comet and aim are imported when their backend is built, and one that
does not import is skipped with a warning."""

from __future__ import annotations

import csv
import logging
import sys
from pathlib import Path
from typing import Dict, List, Optional


def is_host_zero() -> bool:
    """Rank 0 of an initialized ``torch.distributed`` group, else True. torch is
    imported here, not at module level, so that the loggers load without it."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


class _HostZeroFilter(logging.Filter):
    """Suppress sub-WARNING records on non-zero hosts, checking the rank lazily
    at emit time: a logger is made at import, before any process group exists,
    and the rank it would see then is not the one it runs under."""

    def filter(self, record: logging.LogRecord) -> bool:
        if record.levelno >= logging.WARNING:
            return True
        try:
            return is_host_zero()
        except Exception:  # pre-init edge: behave like host 0
            return True


def get_logger(name: str = "anomalyclip_tpu_torch") -> logging.Logger:
    """Console logger that only emits on host 0 (pylogger.py:15-24 analogue)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(
            logging.Formatter("[%(asctime)s][%(name)s][%(levelname)s] %(message)s")
        )
        handler.addFilter(_HostZeroFilter())
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


class CSVMetricLogger:
    """Append-only metrics.csv, one row per log call (configs/logger/csv.yaml)."""

    def __init__(self, save_dir: str | Path, name: str = "csv"):
        self.dir = Path(save_dir) / name
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / "metrics.csv"
        self._fieldnames: Optional[List[str]] = None
        if self.path.is_file():
            # resuming into an existing run dir: adopt the file's fields so prior
            # metric history survives (a fresh logger must not truncate it)
            with open(self.path) as f:
                header = next(csv.reader(f), None)
            if header:
                self._fieldnames = header

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        row = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        new_fields = sorted(row.keys())
        if self._fieldnames is None or any(f not in self._fieldnames for f in new_fields):
            self._rewrite_with_fields(new_fields)
        with open(self.path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fieldnames)
            writer.writerow(row)

    def _rewrite_with_fields(self, new_fields: List[str]) -> None:
        old_rows: List[Dict] = []
        if self._fieldnames is not None and self.path.is_file():
            with open(self.path) as f:
                old_rows = list(csv.DictReader(f))
        merged = sorted(set(new_fields) | set(self._fieldnames or []))
        with open(self.path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=merged)
            writer.writeheader()
            for row in old_rows:
                writer.writerow(row)
        self._fieldnames = merged

    def finalize(self) -> None:
        pass


class TensorBoardMetricLogger:
    def __init__(self, save_dir: str | Path, name: Optional[str] = None):
        from tensorflow.summary import create_file_writer  # lazy; tf is heavy

        self._writer = create_file_writer(str(Path(save_dir) / (name or "")))

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        import tensorflow as tf

        with self._writer.as_default():
            for key, value in metrics.items():
                tf.summary.scalar(key, float(value), step=step)

    def finalize(self) -> None:
        self._writer.close()


class WandbMetricLogger:
    def __init__(self, save_dir, project: str, name: Optional[str], offline: bool = False):
        import wandb

        self._run = wandb.init(
            project=project, name=name, dir=str(save_dir), mode="offline" if offline else None
        )

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        self._run.log(metrics, step=step)

    def finalize(self) -> None:
        self._run.finish()


class MLflowMetricLogger:
    """configs/logger/mlflow.yaml analogue (reference configs/logger/mlflow.yaml);
    file-store tracking URI by default so it works without a server."""

    def __init__(self, save_dir, experiment_name: str, tracking_uri: Optional[str]):
        import mlflow

        self._mlflow = mlflow
        mlflow.set_tracking_uri(tracking_uri or f"file:{Path(save_dir) / 'mlruns'}")
        mlflow.set_experiment(experiment_name)
        self._run = mlflow.start_run()

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        clean = {
            k.replace("/", "_"): float(v)
            for k, v in metrics.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        }
        self._mlflow.log_metrics(clean, step=step)

    def finalize(self) -> None:
        self._mlflow.end_run()


class NeptuneMetricLogger:
    """configs/logger/neptune.yaml analogue (reference configs/logger/neptune.yaml)."""

    def __init__(self, project: Optional[str], name: Optional[str]):
        import neptune

        self._run = neptune.init_run(project=project, name=name)

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        for k, v in metrics.items():
            self._run[k].append(float(v), step=step)

    def finalize(self) -> None:
        self._run.stop()


class CometMetricLogger:
    """configs/logger/comet.yaml analogue (reference configs/logger/comet.yaml)."""

    def __init__(self, project_name: Optional[str], experiment_name: Optional[str]):
        import comet_ml

        self._exp = comet_ml.Experiment(project_name=project_name)
        if experiment_name:
            self._exp.set_name(experiment_name)

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        self._exp.log_metrics({k: float(v) for k, v in metrics.items()}, step=step)

    def finalize(self) -> None:
        self._exp.end()


class AimMetricLogger:
    """configs/logger/aim.yaml analogue (reference configs/logger/aim.yaml)."""

    def __init__(self, repo: Optional[str], experiment: Optional[str]):
        import aim

        self._run = aim.Run(repo=repo, experiment=experiment)

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        for k, v in metrics.items():
            self._run.track(float(v), name=k, step=step)

    def finalize(self) -> None:
        self._run.close()


class MetricLoggerSet:
    """Fan-out to every configured backend; host 0 only."""

    def __init__(self, logger_cfg: Optional[Dict], save_dir: str | Path):
        self.backends = []
        if not is_host_zero() or not logger_cfg:
            return
        log = get_logger(__name__)
        for kind, kwargs in (logger_cfg or {}).items():
            try:
                if kind == "csv":
                    self.backends.append(CSVMetricLogger(kwargs.get("save_dir", save_dir)))
                elif kind == "tensorboard":
                    self.backends.append(
                        TensorBoardMetricLogger(kwargs.get("save_dir", save_dir))
                    )
                elif kind == "wandb":
                    self.backends.append(
                        WandbMetricLogger(
                            kwargs.get("save_dir", save_dir),
                            kwargs.get("project", "AnomalyCLIP-TPU"),
                            kwargs.get("name"),
                            kwargs.get("offline", False),
                        )
                    )
                elif kind == "mlflow":
                    self.backends.append(
                        MLflowMetricLogger(
                            kwargs.get("save_dir", save_dir),
                            kwargs.get("experiment_name", "anomalyclip_tpu"),
                            kwargs.get("tracking_uri"),
                        )
                    )
                elif kind == "neptune":
                    self.backends.append(
                        NeptuneMetricLogger(kwargs.get("project"), kwargs.get("name"))
                    )
                elif kind == "comet":
                    self.backends.append(
                        CometMetricLogger(
                            kwargs.get("project_name"), kwargs.get("experiment_name")
                        )
                    )
                elif kind == "aim":
                    self.backends.append(
                        AimMetricLogger(kwargs.get("repo"), kwargs.get("experiment"))
                    )
                else:
                    log.warning(f"unknown logger backend {kind!r}; skipping")
            except Exception as exc:  # degrade, never kill training over logging
                log.warning(f"logger backend {kind!r} unavailable: {exc}")

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        for backend in self.backends:
            backend.log_metrics(metrics, step)

    def finalize(self) -> None:
        for backend in self.backends:
            backend.finalize()
