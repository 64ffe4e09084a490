"""The system under test, and the one module of the benchmark that imports it:
``anomalyclip_tpu_torch``, the PyTorch and CUDA port. The benchmark hands it
the trees it made from the seed and drives its own entries: ``Scorer`` wraps
``predict.Predictor.score_frames``, ``Trainer`` wraps
``train.module.fit_steps`` with the step of ``build_train_step`` (and
``prepare_batch``'s upload inside it). Everything is imported inside the
functions, so the benchmark's other modules load without the port.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Callable, Iterable, Optional

import numpy as np
import torch


def _model(cfg: dict, clip_params: dict, compute_dtype: str):
    from anomalyclip_tpu_torch.models.anomaly_clip import AnomalyCLIP, AnomalyCLIPConfig
    from anomalyclip_tpu_torch.models.clip.model import CLIPConfig

    names = {f.name for f in dataclasses.fields(AnomalyCLIPConfig)}
    fields = {k: v for k, v in cfg["model"].items() if k in names}
    net = AnomalyCLIPConfig(**fields, arch=cfg["arch"], labels_file=cfg["labels_file"],
                            compute_dtype=compute_dtype)
    clip_cfg = CLIPConfig(**cfg["clip"])
    model, frozen = AnomalyCLIP.build(net, clip_params, clip_cfg)
    if list(model.classnames) != list(cfg["classnames"]):
        raise ValueError(f"the program reads classes {model.classnames}, the configuration has "
                         f"{cfg['classnames']}")
    return model, frozen


def encode_chunk() -> int:
    from anomalyclip_tpu_torch.eval.grids import ENCODE_CHUNK

    return ENCODE_CHUNK


class Scorer:
    """``Predictor`` over the benchmark's trees."""

    def __init__(self, cfg: dict, clip_params: dict, trainable: dict, bn: tuple, ncentroid: torch.Tensor,
                 device):
        from anomalyclip_tpu_torch.models.selector import BNState
        from anomalyclip_tpu_torch.predict import Predictor

        self.model, frozen = _model(cfg, clip_params, cfg["compute_dtype"])
        sampling = SimpleNamespace(**{k: cfg["model"][k] for k in ("num_segments", "seg_length", "stride")})
        self.predictor = Predictor(self.model, frozen, trainable, BNState(*bn), ncentroid,
                                   sampling=sampling, device=str(device))

    @property
    def encode_calls(self) -> int:
        return self.predictor.scorer.encode_calls

    def score(self, frames: np.ndarray) -> tuple:
        """(T, S, S, 3) uint8 frames in host memory -> (scores (T,), class
        probabilities (T, C-1)) in host memory."""
        vs, _ = self.predictor.score_frames(frames[None])
        return vs.scores, vs.class_probs


class Trainer:
    """One training state (model, trainable leaves, AdamW, BN state) and its step."""

    def __init__(self, cfg: dict, clip_params: dict, trainable: dict, bn: tuple, ncentroid: torch.Tensor,
                 first_step: int, device):
        from anomalyclip_tpu_torch.models.losses import LossConfig
        from anomalyclip_tpu_torch.models.selector import BNState
        from anomalyclip_tpu_torch.train.module import build_train_step, init_state

        self.model, self.frozen = _model(cfg, clip_params, cfg["compute_dtype"])
        self.state = init_state(trainable, BNState(*bn), cfg["solver"], cfg["optimizer"], cfg["scheduler"],
                                cfg["epoch_steps"])
        self.state.optimizer.count = first_step
        self.train_step = build_train_step(self.model, LossConfig(**cfg["loss"]))
        self.ncentroid = ncentroid.to(device)
        self.epoch_steps = cfg["epoch_steps"]

    def fit(self, batches: Iterable[tuple], gen: torch.Generator, epochs: int,
            on_step: Optional[Callable] = None):
        """``fit_steps`` over numpy (abnormal features, labels, normal features,
        labels) batches -> the per-epoch loss means."""
        from anomalyclip_tpu_torch.data.loader import TrainBatch
        from anomalyclip_tpu_torch.train.module import fit_steps

        self.state, history = fit_steps(self.train_step, self.frozen, self.state,
                                        (TrainBatch(*b) for b in batches), self.ncentroid, gen, epochs,
                                        self.epoch_steps, on_step=on_step)
        return history

    def first_moment(self, leaf: torch.Tensor) -> torch.Tensor:
        """AdamW's first moment of ``leaf``; zeros where the optimizer holds none
        (it has taken no step on the leaf)."""
        state = self.state.optimizer.optimizer.state.get(leaf, {})
        return state["exp_avg"] if "exp_avg" in state else torch.zeros_like(leaf)
