"""The training and evaluation orchestrator: the counterpart of
anomalyclip_tpu/train/module.py.

The step-level functions:

- ``compute_ncentroid``: the mean CLIP feature over every frame of the normal
  training videos, accumulated in fp64 with padding frames dropped (frames
  encoded first by a given ``encode``);
- ``prepare_batch``: a ``TrainBatch`` of numpy halves -> tensors on the device,
  the ncrops axis squeezed;
- ``build_train_step``: abnormal half first -> ``forward_train`` ->
  ``compute_loss`` -> ``backward`` (through the attention kernels' backwards on
  the card) -> AdamW update of the trainable leaves in place, the BN running
  state replaced, the loss terms added to on-device sums;
- ``fit_steps``: a loop over a stream of batches, grouped into epochs, moving
  the metric sums to the host once an epoch.

``AnomalyCLIPTrainModule`` builds a run from a composed config (a plain nested
dict) and runs it: the ncentroid pass and its cache, ``fit`` (epochs of
``fit_steps``, validation, early stopping, checkpoints, resume, preemption,
metric loggers; under ``trainer.profiler=jax`` a ``torch.profiler`` trace of
the whole fit in ``<run>/profile/``), ``validate``, ``test`` with its
artifacts, ``load_state`` and ``adopt_converted_state``. On the card unless
the caller passes ``device="cpu"``.

In a ``torch.distributed`` group (parallel/mesh.py) a run is data-parallel
over its ranks and computes what one process computes on the global batch:
each rank loads its block of each half, the selector's BatchNorm is sync-BN,
the dropout masks are the global batch's, the smoothness term crosses ranks,
the gradients are averaged in one all-reduce before AdamW, and the parameters
start from rank 0's. Validation, test and the ncentroid pass stride the videos
over the ranks and gather; rank 0 alone writes. ``trainer.model_parallel=mp``
encodes frames through the tensor-parallel tower (parallel/tp.py) over model
groups of ``mp`` ranks.
"""

from __future__ import annotations

import dataclasses
import itertools
import signal
import threading
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from anomalyclip_tpu_torch.convert import as_trainable, tree_leaves, tree_to
from anomalyclip_tpu_torch.data.datamodule import AnomalyCLIPDataModule, DataConfig
from anomalyclip_tpu_torch.data.loader import TrainBatch, limit_count
from anomalyclip_tpu_torch.data.synthetic import generate_synthetic_dataset
from anomalyclip_tpu_torch.eval.artifacts import write_metrics_json, write_test_artifacts
from anomalyclip_tpu_torch.eval.evaluator import GridScorer, evaluate_videos
from anomalyclip_tpu_torch.eval.grids import encode_frames_chunked
from anomalyclip_tpu_torch.eval.metrics import detection_metrics
from anomalyclip_tpu_torch.models.anomaly_clip import AnomalyCLIP, AnomalyCLIPConfig, read_classnames
from anomalyclip_tpu_torch.models.clip.model import CLIPConfig
from anomalyclip_tpu_torch.models.clip.quant import encode_image_int8, quantize_clip_visual
from anomalyclip_tpu_torch.models.clip.registry import resolve_clip
from anomalyclip_tpu_torch.models.losses import LossConfig, LossTerms, compute_loss
from anomalyclip_tpu_torch.models.selector import BNState
from anomalyclip_tpu_torch.numerics import matmul_precision_for
from anomalyclip_tpu_torch.parallel.mesh import (
    any_rank,
    broadcast_,
    distributed,
    every_rank,
    log_stage,
    mean_gradients_,
    mean_over_ranks,
    rank,
    rank_device,
    sum_f64,
    usable_data_devices,
    world_size,
)
from anomalyclip_tpu_torch.parallel.tp import model_group, tp_image_encoder
from anomalyclip_tpu_torch.train.checkpoint import (
    CheckpointManager,
    host_copy,
    load_ncentroid,
    save_ncentroid,
)
from anomalyclip_tpu_torch.train.optim import GroupedAdamW, base_lr_schedule, build_optimizer
from anomalyclip_tpu_torch.utils.logging import MetricLoggerSet, get_logger, is_host_zero

log = get_logger(__name__)

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
    BN running state and the number of steps taken. A state loaded to score
    (``load_state``, ``adopt_converted_state``) has no optimizer."""

    trainable: Dict[str, Any]
    optimizer: Optional[GroupedAdamW]
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


def build_train_step(model: AnomalyCLIP, loss_cfg: LossConfig, dp: Optional[Tuple[int, int]] = None):
    """-> train_step(frozen, state, batch, ncentroid, gen, metric_sums) ->
    (state, metric_sums, terms). ``batch`` comes from ``prepare_batch``; ``gen``
    draws the selector's dropout masks. The trainable leaves are updated in
    place; the returned state carries the new BN state and step count.

    ``dp=(rank, ranks)``: the batch is this rank's block of a data-parallel
    global batch (JAX module.py:544-556). The forward and the loss compute the
    global batch's (``forward_train``, ``compute_loss``), the gradients are
    averaged over the ranks in one bucket before AdamW, so every rank's update
    is the same, and ``terms`` are this rank's (their mean over the ranks is
    the global loss)."""

    def train_step(
        frozen, state: TrainState, batch: TrainBatch, ncentroid, gen, metric_sums
    ):
        features = torch.cat([batch.abnormal_features, batch.normal_features])
        labels = torch.cat([batch.abnormal_labels, batch.normal_labels])
        state.optimizer.zero_grad()
        # the backward's products and convolutions need the forward's precision
        with matmul_precision_for(model.cfg.dtype):
            out, new_bn = model.forward_train(
                frozen, state.trainable, state.bn_state, features, labels, ncentroid, gen, dp=dp
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
                dp=dp,
            )
            terms.total.backward()
        if dp is not None:
            mean_gradients_([p for group in state.optimizer.optimizer.param_groups for p in group["params"]])
        state.optimizer.step()
        # metrics accumulate on the device: one host transfer per epoch
        terms = LossTerms(*(t.detach() for t in terms))
        sums = {k: metric_sums[k] + getattr(terms, f) for k, f in METRIC_NAMES.items()}
        new_state = dataclasses.replace(state, bn_state=new_bn, step=state.step + 1)
        return new_state, sums, terms

    return train_step


def ncentroid_sums(
    videos: Iterable[Any], dim: int, encode: Optional[Callable[[np.ndarray], np.ndarray]] = None
) -> np.ndarray:
    """(dim + 1,) fp64: the sum of every frame's feature over ``videos``, then
    the number of frames.

    Each video has ``features`` (ncrops, t, D), or frames (ncrops, t, H, W, 3)
    that ``encode`` turns into (n, D) features, and ``frame_labels`` (one per
    real frame), as the data package's test-mode items; frames past
    ``len(frame_labels)`` are padding and dropped."""
    total = np.zeros(dim, dtype=np.float64)
    count = 0
    for item in videos:
        feats = np.asarray(item.features)
        flat = feats.reshape(-1, *feats.shape[2:])[: len(item.frame_labels)]
        if encode is not None:
            flat = encode(flat)
        total += flat.reshape(len(flat), -1).sum(axis=0, dtype=np.float64)
        count += len(flat)
    return np.concatenate([total, [np.float64(count)]])


def centroid_of(sums: np.ndarray) -> np.ndarray:
    """``ncentroid_sums``' output (or the sum of several) -> the mean, fp32."""
    return (sums[:-1] / max(sums[-1], 1)).astype(np.float32)


def compute_ncentroid(
    videos: Iterable[Any], dim: int, encode: Optional[Callable[[np.ndarray], np.ndarray]] = None
) -> np.ndarray:
    """Mean feature over every frame of ``videos`` -> (dim,) fp32, the sum
    taken in fp64 (``ncentroid_sums``)."""
    return centroid_of(ncentroid_sums(videos, dim, encode))


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
    dp: Optional[Tuple[int, int]] = None,
):
    """Take up to ``epochs * steps_per_epoch`` steps over ``batches`` (numpy
    ``TrainBatch``es, consumed in order; the loop ends early when they run out).
    ``on_step(state, terms)`` runs after every step. -> (state, one dict per
    epoch of the loss terms' means over its steps, on the host). With ``dp``
    (a data-parallel ``train_step``'s) each epoch's sums are averaged over the
    ranks once, at its end: the global batch's means."""
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
        if dp is not None:
            sums = dict(zip(sums, mean_over_ranks(torch.stack(list(sums.values())))))
        history.append({k: float(v) / count for k, v in sums.items()})
    return state, history


# ---------------------------------------------------------------------------
# the module: a run from a composed config
# ---------------------------------------------------------------------------


TRACE_DIR = "profile"  # a profiled fit's trace, under its run directory


def start_fit_trace(device: torch.device):
    """A ``torch.profiler`` session, started: the host's operators always, the
    card's kernels, copies and sets too when ``device`` is the card."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    session = profile(activities=activities)
    session.start()
    return session


def stop_fit_trace(session, out_dir: Path, device: torch.device) -> Path:
    """Stop ``session`` once the card has drained, and write its trace as
    Chrome/Perfetto JSON under ``out_dir`` -> the file (open it in
    ui.perfetto.dev or chrome://tracing). Raises if the file is not written."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    session.stop()
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"fit.{time.time_ns()}.pt.trace.json"
    session.export_chrome_trace(str(path))
    if not path.is_file() or path.stat().st_size == 0:
        raise RuntimeError(f"the profiler wrote no trace to {path}")
    log.info(f"profiler trace written to {path}")
    return path


class TrainingPreempted(RuntimeError):
    """Raised after a SIGTERM-triggered checkpoint save (preemption recovery).

    Preemptions and maintenance events deliver SIGTERM with a grace period; the
    reference (Lightning on GPUs) has no preemption story. fit() saves the last
    *epoch-boundary* state as a regular checkpoint and raises this, so
    `ckpt_path=<run>/checkpoints/last` resumes with exactly the same semantics as
    any other epoch checkpoint (no partial-epoch optimizer state is ever
    persisted)."""


def _fields(cls, mapping: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in mapping.items() if k in names}


class AnomalyCLIPTrainModule:
    """Owns model, data, optimizer and the train and eval loops for one composed
    config: the JAX package's ``AnomalyCLIPTrainModule``
    (anomalyclip_tpu/train/module.py:87-1208).

    ``cfg`` is the composed config as a plain nested dict (what
    ``to_dict(compose(...))`` of ``anomalyclip_tpu_torch.config`` gives).
    ``device`` is the card unless the caller passes ``"cpu"``; in a
    ``torch.distributed`` group the card is the rank's own (``rank_device``).
    The frozen CLIP tree lives on the device, but for the visual tower of a
    tensor-parallel run, which stays on the host: its shards go to the
    devices (``_tp_encode_fn``)."""

    def __init__(self, cfg: Dict[str, Any], device=None):
        self.cfg = cfg
        self.device = rank_device(device)
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)
        # in a group (of any size) the run is data-parallel over its ranks
        self.dp = (rank(), world_size()) if distributed() else None
        self.seed = int(cfg.get("seed") or 0)
        model_cfg = cfg["model"]
        self.save_dir = Path(model_cfg.get("save_dir") or cfg["paths"]["output_dir"])
        self.save_dir.mkdir(parents=True, exist_ok=True)

        trainer_cfg = cfg.get("trainer") or {}
        if trainer_cfg.get("detect_anomaly"):
            torch.autograd.set_detect_anomaly(True)

        data_cfg = dict(cfg["data"])
        net_cfg = dict(model_cfg["net"])
        # the synthetic features must match the resolved tower's embed_dim
        clip_params, clip_cfg = resolve_clip(
            arch=net_cfg.get("arch", "ViT-B/16"),
            clip_init=net_cfg.get("clip_init", "pretrained"),
            clip_ckpt_path=net_cfg.get("clip_ckpt_path"),
            seed=self.seed,
        )
        if data_cfg.get("synthetic"):
            generate_synthetic_dataset(
                frames_root=data_cfg["frames_root"],
                annotations_root=data_cfg["annotations_root"],
                num_normal=data_cfg.get("synthetic_num_normal", 8),
                num_abnormal=data_cfg.get("synthetic_num_abnormal", 8),
                num_test=data_cfg.get("synthetic_num_test", 4),
                num_classes=data_cfg["num_classes"],
                normal_id=data_cfg["normal_id"],
                feature_dim=clip_cfg.embed_dim,
                min_frames=data_cfg.get("synthetic_min_frames", 600),
                max_frames=data_cfg.get("synthetic_max_frames", 1400),
                seed=self.seed,
                make_frames=not data_cfg.get("load_from_features", True),
                frame_size=int(data_cfg.get("input_size", 224)),
            )
        self.datamodule = AnomalyCLIPDataModule(DataConfig.from_dict(data_cfg), seed=self.seed)
        if self.dp is not None:
            # a joined group is the data mesh: the half-batch must divide over it
            usable_data_devices(self.datamodule.cfg.batch_size // 2)

        self.net_cfg = AnomalyCLIPConfig(**_fields(AnomalyCLIPConfig, net_cfg))
        self.model, frozen = AnomalyCLIP.build(self.net_cfg, clip_params, clip_cfg)
        # trainer.model_parallel: the tensor-parallel tower where it can run
        # (JAX module.py:172-241, 342-409), its model groups made here, at one
        # program point of every rank
        self.model_parallel = int(trainer_cfg.get("model_parallel") or 1)
        self._route_tp()
        self.frozen = self._place_frozen(frozen)
        self.loss_cfg = LossConfig(**_fields(LossConfig, dict(model_cfg["loss"])))

        mc_cfg = (cfg.get("callbacks") or {}).get("model_checkpoint") or {}
        self.ckpt = CheckpointManager(
            self.save_dir,
            save_top_k=int(mc_cfg.get("save_top_k", -1) or -1),
            save_last=bool(mc_cfg.get("save_last", True)),
        )
        self._ckpt_every_n_epochs = int(mc_cfg.get("every_n_epochs", 1) or 1)
        self.loggers = MetricLoggerSet(cfg.get("logger"), self.save_dir)
        self.ncentroid: Optional[np.ndarray] = None
        self._encode_frames_fn: Optional[Callable] = None
        self._in_fit = False
        self._scorer_cache: Optional[GridScorer] = None
        self._train_loader = None
        self._sigterm_installed = False
        self._old_sigterm = None

    # ------------------------------------------------------------------ data

    def _tp_unavailable_reason(self, mp: int) -> Optional[str]:
        """Why ``trainer.model_parallel=mp`` cannot run here (None: it can; JAX
        module.py:342-364): too few ranks, a ModifiedResNet tower (no sharding,
        it stays on the data-parallel path) or more ranks than heads."""
        n = world_size()
        if n < mp:
            return f"only {n} device(s) (ranks) for model_parallel={mp}"
        if self.model.clip_cfg.is_resnet:
            return "ResNet towers have no TP sharding (stay on the DP path)"
        if mp > self.model.clip_cfg.vision_heads:
            return f"{self.model.clip_cfg.vision_heads} heads do not split over model_parallel={mp}"
        return None

    def _route_tp(self) -> None:
        """Decide ``trainer.model_parallel`` for the current model: its reason
        to fall back (``_tp_reason``), else the rank's ``model_group``, made here
        at one program point of every rank (None: no tensor parallelism)."""
        mp = self.model_parallel
        self._tp_reason = self._tp_unavailable_reason(mp) if mp > 1 else None
        self.model_group = model_group(mp) if mp > 1 and self._tp_reason is None else None

    def _place_frozen(self, frozen) -> Dict[str, Any]:
        """The frozen tree on the device; a tensor-parallel run's visual tower
        on the host, from which each rank cuts and uploads only its shard."""
        if self.model_group is None:
            return tree_to(frozen, self.device)
        clip = {k: (tree_to(v, "cpu") if k == "visual" else tree_to(v, self.device))
                for k, v in frozen["clip"].items()}
        return {**frozen, "clip": clip}

    def _videos(self, loader_of: Callable, limit: Optional[int]):
        """This rank's share of a pass over videos, ``loader_of(limit=...,
        shard=...)`` -> (loader, whether its outputs count). Data parallel: the
        ranks stride the videos. Tensor parallel: the model groups do, every
        rank of a group scores the group's videos and only its first rank's
        outputs count; a rank in no whole group scores none."""
        mg = self.model_group
        if mg is None:
            return loader_of(limit=limit, shard=(rank(), world_size())), True
        if not mg.active:
            return loader_of(limit=0, shard=(0, mg.groups)), False
        return loader_of(limit=limit, shard=(mg.index, mg.groups)), mg.member == 0

    def _stop_poll(self, should_stop: Optional[Callable[[], bool]]) -> Optional[Callable[[], bool]]:
        """A tensor-parallel group scores each video together, so a stop before
        a video is the group's decision, or one rank would leave its peers in
        the tower's all-reduce."""
        if should_stop is None or self.model_group is None:
            return should_stop
        group = self.model_group.group
        return lambda: any_rank(should_stop(), group=group)

    def _encode_fn(self) -> Callable:
        """The frame encoder (frozen, frames) -> features that the ncentroid
        pass and the scorer share, chosen at its first use and kept (JAX
        module.py:172-241): the tensor-parallel tower under
        ``trainer.model_parallel`` where ``_tp_unavailable_reason`` allows (an
        int8 tower encodes on the fp tower there), else the int8 tower when
        ``_int8_serving_active``, else ``AnomalyCLIP.encode_frames``. A
        rejected ``model_parallel`` logs its reason and encodes on one device."""
        if self._encode_frames_fn is None:
            mp = self.model_parallel
            # the quantize knob is validated on every route
            int8 = self._int8_serving_active()
            if self.model_group is not None:
                if int8:
                    log.warning(
                        "model.net.quantize=int8 has no tensor-parallel path — "
                        f"trainer.model_parallel={mp} encodes on the fp tower"
                    )
                self._encode_frames_fn = self._tp_encode_fn(mp)
            else:
                if mp > 1:
                    log.warning(
                        f"trainer.model_parallel={mp} requested but {self._tp_reason} — "
                        "encoding on the single-device tower instead"
                    )
                self._encode_frames_fn = self._int8_encode_fn() if int8 else self.model.encode_frames
        return self._encode_frames_fn

    def _tp_encode_fn(self, mp: int) -> Callable:
        """(frozen, frames) -> (N, D) through this rank's shard of the visual
        tower (parallel/tp.py), cut from the host copy of the tower and uploaded
        alone; the ``frozen`` it is given is not read. ``_tp_placed`` keeps the
        shard."""
        mg = self.model_group
        if mg.groups * mp < world_size():
            log.warning(
                f"model_parallel={mp}: using {mg.groups * mp} of {world_size()} ranks "
                "(count does not divide evenly; remainder idles)"
            )
        encode = tp_image_encoder(self.frozen["clip"], self.model.clip_cfg, mp, self.device,
                                  self.model.cfg.dtype, chunk=self.model.ENCODE_CHUNK)
        log.info(f"TP encode: {mg.groups} model group(s) of {mp} ranks over {self.device.type}")
        self._tp_placed = encode.shard
        return encode

    def _int8_serving_active(self) -> bool:
        """Whether the W8A8 tower serves this encode (JAX module.py:243-267).
        ``quantize=int8`` is a serving knob: inside ``fit`` the fp tower encodes
        everything, the ncentroid pass included, so that training never mixes
        precisions; a ModifiedResNet tower has no int8 path and serves fp. Any
        value other than "none" and "int8" raises here, at the first encode."""
        quantize = self.net_cfg.quantize
        if quantize == "none":
            return False
        if quantize != "int8":
            raise ValueError(f"model.net.quantize={quantize!r}: expected 'none' or 'int8'")
        if self.model.clip_cfg.is_resnet:
            log.warning("model.net.quantize=int8 has no ResNet-tower path — serving the fp tower instead")
            return False
        if self._in_fit:
            log.warning(
                "model.net.quantize=int8 is serving-only: the training run "
                "(incl. its ncentroid bootstrap) uses the fp tower"
            )
            return False
        return True

    def _int8_encode_fn(self) -> Callable:
        """The W8A8 serving encoder (models/clip/quant.py): the frozen visual
        tower quantized once, here, on the device it lies on; activations
        quantized per token at each GEMM; chunked as
        ``AnomalyCLIP.encode_frames`` chunks, in the model's compute dtype. The
        returned function ignores the ``frozen`` it is given, as the JAX
        module's does: it holds its own tower."""
        qvisual = quantize_clip_visual(self.frozen["clip"])
        clip_cfg, chunk, dtype = self.model.clip_cfg, self.model.ENCODE_CHUNK, self.model.cfg.dtype

        def encode(_frozen, frames: torch.Tensor) -> torch.Tensor:
            n = frames.shape[0]
            if n > chunk and n % chunk == 0:
                return torch.cat([encode_image_int8(qvisual, clip_cfg, c, dtype) for c in frames.split(chunk)])
            return encode_image_int8(qvisual, clip_cfg, frames, dtype)

        log.info("encode path: int8 (W8A8) serving tower")
        encode.int8 = True
        return encode

    def _frame_features(self, frames: np.ndarray) -> np.ndarray:
        """CLIP-encode raw frames for the ncentroid pass (the frames path),
        through the routed encoder (``_encode_fn``)."""
        encode = self._encode_fn()
        return encode_frames_chunked(lambda part: encode(self.frozen, part), frames, self.device)

    def compute_ncentroid(self, limit: Optional[int] = None) -> np.ndarray:
        """Mean CLIP feature over every frame of the normal training videos
        (anomaly_clip_module.py:134-171), cached as ncentroid.npy. A limited pass
        (fast_dev_run) neither trusts nor writes the cache."""
        cached = load_ncentroid(self.save_dir)
        # in a group the cache-hit decision is global: the pass below ends in a
        # collective (JAX module.py:417-470)
        if not every_rank(cached is not None):
            cached = None
        if cached is not None and limit is None:
            self.ncentroid = cached
            return cached
        log.info("computing ncentroid over normal training videos ...")
        # each rank sums its stride of the videos in fp64, then one all-reduce
        videos, contribute = self._videos(self.datamodule.train_dataloader_test_mode, limit)
        sums = ncentroid_sums(
            videos, self.model.embedding_dim,
            encode=None if self.net_cfg.load_from_features else self._frame_features,
        )
        ncentroid = centroid_of(sum_f64(sums if contribute else np.zeros_like(sums)))
        if limit is None and is_host_zero():
            save_ncentroid(self.save_dir, ncentroid)
        self.ncentroid = ncentroid
        return ncentroid

    # ----------------------------------------------------------------- train

    def _build_train_step(self):
        return build_train_step(self.model, self.loss_cfg, dp=self.dp)

    def _optimizer_cfgs(self) -> Tuple[Dict, Dict, Dict]:
        model_cfg = self.cfg["model"]
        return (
            dict(model_cfg["solver"]),
            dict(model_cfg.get("optimizer") or {}),
            dict(model_cfg.get("scheduler") or {}),
        )

    def init_state(self, steps_per_epoch: int) -> TrainState:
        """The seeded initial state on the device: trainable parameters from a
        generator seeded with ``seed``, a fresh BN state, a fresh optimizer."""
        trainable, bn_state = self.model.init_trainable(
            torch.Generator().manual_seed(self.seed), self.frozen
        )
        return init_state(
            tree_to(trainable, self.device), bn_state.to(self.device),
            *self._optimizer_cfgs(), steps_per_epoch,
        )

    def _log_model_summary(self, state: TrainState) -> None:
        """Parameter counts per optimizer group + frozen CLIP (the reference's
        log_hyperparameters, src/utils/logging_utils.py:9-50)."""

        def count(tree) -> int:
            return sum(t.numel() for t in tree_leaves(tree))

        frozen_n = count(self.frozen)
        groups = {k: count(v) for k, v in state.trainable.items()}
        trainable_n = sum(groups.values())
        per_group = ", ".join(f"{k}={v:,}" for k, v in groups.items())
        log.info(
            f"model summary: trainable={trainable_n:,} ({per_group}); "
            f"frozen CLIP={frozen_n:,}; total={trainable_n + frozen_n:,}"
        )
        self.loggers.log_metrics(
            {
                "model/params_trainable": float(trainable_n),
                "model/params_frozen": float(frozen_n),
                "model/params_total": float(trainable_n + frozen_n),
            },
            step=0,
        )

    def _run_task(self, fn):
        """task_wrapper analogue (reference: src/utils/utils.py:42-92): exceptions
        are appended to <run_dir>/exception.log and re-raised; metric loggers are
        always finalized so a crashed run keeps its buffered metrics."""
        try:
            return fn()
        except Exception:
            if is_host_zero():
                path = self.save_dir / "exception.log"
                with open(path, "a") as f:
                    f.write(traceback.format_exc() + "\n")
                log.error(f"task failed; traceback saved to {path}")
            raise
        finally:
            self.loggers.finalize()

    def fit(self) -> Dict[str, Any]:
        return self._run_task(self._fit)

    def _fit(self) -> Dict[str, Any]:
        trace = None
        # quantize=int8 is serving-only (_int8_serving_active): the encoder is
        # kept, directly and inside the cached scorer, so the fp routing of the
        # fit must not leak into a later test() or predict(), nor a pre-fit
        # int8 encoder into the fit: both caches go at both edges
        self._in_fit = True
        if self.net_cfg.quantize != "none":
            self._encode_frames_fn = self._scorer_cache = None
        try:
            # trainer.profiler "jax" (configs/debug/profiler.yaml; the config
            # tree is the JAX package's) traces the whole fit on rank 0; any
            # other value traces nothing
            if (self.cfg.get("trainer") or {}).get("profiler") == "jax" and is_host_zero():
                trace = start_fit_trace(self.device)
            return self._fit_body()
        finally:
            try:
                # stopped on the exception path too: a crashed profiled run
                # keeps its trace (the crashing step is the one to read)
                if trace is not None:
                    stop_fit_trace(trace, self.save_dir / TRACE_DIR, self.device)
            finally:
                self._in_fit = False
                if self.net_cfg.quantize != "none":
                    self._encode_frames_fn = self._scorer_cache = None
                if self._train_loader is not None:
                    self._train_loader.close()
                    self._train_loader = None
                # restore even when the previous handler was None (installed from C)
                if self._sigterm_installed:
                    signal.signal(signal.SIGTERM, self._old_sigterm)
                    self._sigterm_installed = False
                    self._old_sigterm = None

    def _boundary(self, state: TrainState) -> Dict[str, Any]:
        """A resumable epoch boundary: a deep copy on the CPU of the trainable
        tree, the optimizer's state, its update count, the BN state and the step.
        The optimizer updates the trainable leaves and its moments in place, and
        ``state_dict()`` hands out the live tensors, so an alias would hold the
        state of a later step by the time it is saved."""
        return host_copy({
            "trainable": state.trainable,
            "optimizer": state.optimizer.optimizer.state_dict(),
            "count": state.optimizer.count,
            "bn_state": state.bn_state,
            "step": state.step,
        })

    def _train_frozen(self) -> Dict[str, Any]:
        """The frozen tree the training forward reads: the visual tower on the
        device when the forward encodes frames, even where a tensor-parallel
        run keeps it on the host to serve (JAX trains on the replicated tower
        under any model_parallel)."""
        if self.net_cfg.load_from_features or self.model_group is None:
            return self.frozen
        clip = self.frozen["clip"]
        return {**self.frozen, "clip": {**clip, "visual": tree_to(clip["visual"], self.device)}}

    def _resume(self, ckpt_path, steps_per_epoch: int) -> Tuple[TrainState, int]:
        """A checkpoint of the port, or an Orbax one of the JAX package's fit
        -> (the state on the device, its epoch). The optimizer's moments and
        steps come from the checkpoint, its hyperparameters from this
        session's config, as the JAX package resumes."""
        restored = self.ckpt.restore(ckpt_path, device="cpu")
        if restored["optimizer"] is None:
            raise ValueError(
                f"{ckpt_path} holds no optimizer state (a converted checkpoint): it restores for "
                "evaluation (eval_entry, predict, serve, export), not to resume a fit")
        state = init_state(
            tree_to(restored["trainable"], self.device), restored["bn_state"].to(self.device),
            *self._optimizer_cfgs(), steps_per_epoch,
        )
        # the moments move to their parameters' device; AdamW's step counts stay
        # on the CPU, where an uninterrupted run keeps them
        optimizer = state.optimizer.optimizer
        optimizer.load_state_dict({"state": restored["optimizer"]["state"],
                                   "param_groups": optimizer.state_dict()["param_groups"]})
        state.optimizer.count = int(restored["count"])
        return dataclasses.replace(state, step=int(restored["step"])), int(restored["epoch"])

    def _fit_body(self) -> Dict[str, Any]:
        cfg = self.cfg
        trainer_cfg = cfg.get("trainer") or {}
        fast_dev_run = bool(trainer_cfg.get("fast_dev_run"))
        max_epochs = 1 if fast_dev_run else int(trainer_cfg.get("max_epochs", 50))

        self.compute_ncentroid(limit=1 if fast_dev_run else None)

        # kept on self so _fit's finally can join the worker pool even when an
        # epoch raises. In a group each rank loads its block of every global
        # batch (the loader's length, and so the steps, are the global ones)
        shard = {"shard": (rank(), world_size())} if self.dp is not None else {}
        train_loader = self._train_loader = self.datamodule.train_dataloader(**shard)
        overfit_batches = int(trainer_cfg.get("overfit_batches") or 0)
        steps_per_epoch = limit_count(len(train_loader), trainer_cfg.get("limit_train_batches"))
        if overfit_batches:
            # train on the same few batches every epoch (Lightning overfit_batches;
            # reference: configs/debug/overfit.yaml) — epoch shuffling is pinned
            steps_per_epoch = min(steps_per_epoch, overfit_batches)
        if fast_dev_run:
            steps_per_epoch = 1
        if steps_per_epoch == 0:
            raise RuntimeError("empty train loader (batch_size larger than dataset?)")

        solver_cfg, _, scheduler_cfg = self._optimizer_cfgs()
        lr_schedule = base_lr_schedule(solver_cfg, scheduler_cfg, steps_per_epoch)
        train_step = self._build_train_step()
        state = self.init_state(steps_per_epoch)
        start_epoch = 0
        ckpt_path = cfg.get("ckpt_path")
        if ckpt_path:
            state, epoch = self._resume(ckpt_path, steps_per_epoch)
            start_epoch = epoch + 1
            log.info(f"resumed from {ckpt_path} at epoch {start_epoch}")
        # every rank starts from rank 0's parameters and BN state
        broadcast_([*tree_leaves(state.trainable), *state.bn_state])
        ncentroid = torch.as_tensor(self.ncentroid, device=self.device)
        frozen = self._train_frozen()

        callbacks_cfg = cfg.get("callbacks") or {}
        if callbacks_cfg.get("model_summary", True):
            self._log_model_summary(state)

        # early stopping (reference: configs/callbacks/early_stopping.yaml)
        es_cfg = callbacks_cfg.get("early_stopping") or None
        es_monitor = es_cfg.get("monitor", "auc_roc") if es_cfg else None
        es_patience = int(es_cfg.get("patience", 3)) if es_cfg else 0
        es_mode = str(es_cfg.get("mode", "max")) if es_cfg else "max"
        es_min_delta = float(es_cfg.get("min_delta", 0.0)) if es_cfg else 0.0
        es_best: Optional[float] = None
        es_bad_epochs = 0

        # the selector's dropout masks: seeded at every fit() start, resume
        # included, as the JAX package's key is
        gen = torch.Generator().manual_seed(self.seed + 17)
        last_val: Dict[str, Any] = {}

        # ---- preemption safety -------------------------------------------
        # On SIGTERM, persist the newest *epoch-boundary* state as a normal
        # checkpoint and raise TrainingPreempted: resume via ckpt_path=.../last
        # re-runs the interrupted epoch from its start. Off switch:
        # trainer.preempt_save=false.
        preempt_flag = {"set": False}
        preempt_armed = bool(trainer_cfg.get("preempt_save", True)) and (
            threading.current_thread() is threading.main_thread()
        )
        if preempt_armed:

            def _on_sigterm(signum, frame):
                # async-signal-safe: only flip the flag — logging here can
                # re-enter a buffered stream mid-write
                preempt_flag["set"] = True

            # restored by _fit's finally (survives any exception below)
            self._old_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
            self._sigterm_installed = True

        # newest completed epoch boundary (a deep copy on the host, see
        # _boundary); the one before the first epoch is never saved
        boundary_epoch, boundary_state = start_epoch - 1, None
        last_saved_epoch = start_epoch - 1  # skip re-serializing in the grace window
        # in a group the stop decision is global and polled at one program point
        # of every rank: each poll is a collective, so every K steps
        # (JAX module.py:781-800, 865)
        poll_steps = max(1, int(trainer_cfg.get("preempt_poll_every_n_steps", 8))) if self.dp else 1

        def _handle_preempt(during_epoch: int) -> None:
            nonlocal last_saved_epoch
            if not any_rank(preempt_flag["set"]):
                return
            log.warning("SIGTERM received: checkpointing the last epoch boundary")
            if boundary_epoch >= 0 and boundary_epoch != last_saved_epoch:
                try:
                    self.ckpt.save_epoch(boundary_epoch, {**boundary_state, "epoch": boundary_epoch})
                except Exception as e:  # noqa: BLE001 — surfaced as the preemption's cause
                    log.error(f"preemption checkpoint save FAILED: {e!r}")
                    raise TrainingPreempted(
                        f"preempted during epoch {during_epoch} and the boundary "
                        f"checkpoint save failed: {e!r}"
                    ) from e
                last_saved_epoch = boundary_epoch
                log.warning(
                    f"preemption checkpoint saved at epoch {boundary_epoch}; "
                    f"resume with ckpt_path={self.ckpt.ckpt_dir / 'last'}"
                )
            if boundary_epoch < 0:
                raise TrainingPreempted(
                    f"preempted during epoch {during_epoch} before any epoch "
                    "completed — no checkpoint written; restart from scratch"
                )
            raise TrainingPreempted(
                f"preempted during epoch {during_epoch} "
                f"(saved boundary: epoch {boundary_epoch})"
            )

        def polled(epoch: int):
            """The epoch's batches, the preemption flag polled before each step."""
            for batch_idx, batch in enumerate(train_loader):
                if batch_idx >= steps_per_epoch:
                    return
                if batch_idx % poll_steps == 0:
                    _handle_preempt(epoch)
                yield batch

        for epoch in range(start_epoch, max_epochs):
            train_loader.set_epoch(0 if overfit_batches else epoch)
            t0 = time.time()
            # one epoch of fit_steps: its loss means reach the host once
            state, history = fit_steps(
                train_step, frozen, state, polled(epoch), ncentroid, gen,
                epochs=1, steps_per_epoch=steps_per_epoch, dp=self.dp,
            )
            # the epoch's steps all ran: this state is a resumable boundary,
            # copied to the host whenever preemption or a checkpoint may save it
            # (in a group always: another rank's SIGTERM may save it)
            boundary_epoch = epoch
            ckpt_due = not fast_dev_run and (epoch + 1) % self._ckpt_every_n_epochs == 0
            keep = preempt_armed or ckpt_due or self.dp is not None
            boundary_state = self._boundary(state) if keep else None
            _handle_preempt(epoch)
            epoch_metrics = dict(history[0]) if history else zero_metric_sums("cpu")
            epoch_metrics = {k: float(v) for k, v in epoch_metrics.items()}
            if callbacks_cfg.get("lr_logger", True):
                # reference: LearningRateMonitor (configs/callbacks/default.yaml);
                # the LR in effect during THIS epoch (per-epoch schedule)
                epoch_metrics["train/lr"] = float(lr_schedule(epoch * steps_per_epoch))
            epoch_metrics["train/epoch_time_s"] = time.time() - t0
            log.info(
                f"epoch {epoch}: loss={epoch_metrics.get('train/loss', float('nan')):.4f} "
                f"({state.step} steps so far, {epoch_metrics['train/epoch_time_s']:.1f}s)"
            )
            self.loggers.log_metrics(epoch_metrics, step=epoch)
            log_stage(f"epoch {epoch} trained ({state.step} steps)")

            # ---- validation (every epoch, like the reference) ----
            check_every = int(trainer_cfg.get("check_val_every_n_epoch", 1) or 1)
            validated_this_epoch = (epoch + 1) % check_every == 0
            if validated_this_epoch:
                val_limit = limit_count(
                    len(self.datamodule.val_dataloader()),
                    1 if fast_dev_run else trainer_cfg.get("limit_val_batches"),
                )
                # a SIGTERM mid-validation must not burn the grace period on
                # scoring: bail between videos; _handle_preempt below then
                # checkpoints the epoch boundary
                last_val = self.validate(
                    state, epoch, limit=val_limit, should_stop=lambda: preempt_flag["set"],
                )
                self.loggers.log_metrics(
                    {
                        f"test/{k}": last_val[j]
                        for k, j in [
                            ("AUC", "auc_roc"),
                            ("AP", "auc_pr"),
                            ("mAUC", "mean_mc_auroc"),
                            ("mAP", "mean_mc_aupr"),
                        ]
                        if j in last_val and np.isfinite(last_val[j])
                    },
                    step=epoch,
                )

            # early stopping counts only epochs with a FRESH validation — with
            # check_val_every_n_epoch > 1, stale metrics must not burn patience
            if es_monitor and last_val and validated_this_epoch:
                value = last_val.get(es_monitor)
                if value is not None and np.isfinite(value):
                    improved = es_best is None or (
                        value > es_best + es_min_delta
                        if es_mode == "max"
                        else value < es_best - es_min_delta
                    )
                    if improved:
                        es_best, es_bad_epochs = float(value), 0
                    else:
                        es_bad_epochs += 1

            if validated_this_epoch:
                log_stage(f"epoch {epoch} validated")
            if ckpt_due:
                self.ckpt.save_epoch(epoch, {**boundary_state, "epoch": epoch})
                last_saved_epoch = epoch
                log_stage(f"epoch {epoch} checkpoint written")

            _handle_preempt(epoch)  # a SIGTERM during validation lands here

            if es_monitor and es_bad_epochs >= es_patience > 0:
                log.info(
                    f"early stopping at epoch {epoch}: {es_monitor} did not improve "
                    f"for {es_bad_epochs} epochs (best {es_best:.4f})"
                )
                break

        self._final_state = state
        return last_val

    # ------------------------------------------------------------------ eval

    def _scorer(self, state: TrainState) -> GridScorer:
        """The one scorer of this model, built at its first use and then
        ``update``d from ``state``: the text features are computed from the text
        subtree of the frozen tree (``GridScorer.update``); the image tower,
        which only the frames path reads, stays where it is, and frames are
        encoded by the routed encoder (``_encode_fn``)."""
        ncentroid = torch.as_tensor(self.ncentroid, device=self.device)
        if self._scorer_cache is None or self._scorer_cache.model is not self.model:
            self._scorer_cache = GridScorer(
                self.model, self.frozen, state.trainable, state.bn_state, ncentroid,
                device=self.device, encode=self._encode_fn(),
            )
            return self._scorer_cache
        return self._scorer_cache.update(self.frozen, state.trainable, state.bn_state, ncentroid)

    def validate(
        self,
        state: TrainState,
        epoch: int,
        limit: Optional[int] = None,
        should_stop=None,
    ) -> Dict:
        """Validation epoch -> detection metrics + metrics_{epoch}.json
        (anomaly_clip_module.py:301-404). ``should_stop`` (polled between
        videos) aborts with {} — the preemption path; no partial metrics are
        written or logged."""
        scorer = self._scorer(state)
        # in a group each rank scores its share of the videos, and every rank
        # gets the whole set back (JAX module.py:1040-1045); a stop on any rank
        # stops them all before the gather
        videos, contribute = self._videos(self.datamodule.val_dataloader, limit)
        outputs = evaluate_videos(
            videos, scorer, self.model, should_stop=self._stop_poll(should_stop),
            gather_processes=True, contribute=contribute,
        )
        if not outputs:
            return {}
        det = detection_metrics(
            outputs["abnormal_scores"],
            outputs["labels"],
            outputs["class_probs"],
            self.net_cfg.normal_id,
            self.datamodule.num_classes,
        )
        metrics = {
            "epoch": epoch,
            "auc_roc": det["auc_roc"],
            "auc_pr": det["auc_pr"],
            "mean_mc_auroc": det["mean_mc_auroc"],
            "mean_mc_aupr": det["mean_mc_aupr"],
            "mc_auroc": det["mc_auroc"],
            "mc_aupr": det["mc_aupr"],
            "optimal_threshold": det["optimal_threshold"],
        }
        if is_host_zero():
            write_metrics_json(self.save_dir, metrics, epoch=epoch)
        log.info(
            f"val epoch {epoch}: AUC={det['auc_roc']:.4f} AP={det['auc_pr']:.4f} "
            f"mAUC={det['mean_mc_auroc']:.4f} mAP={det['mean_mc_aupr']:.4f}"
        )
        return metrics

    def load_state(self, ckpt_path) -> TrainState:
        """A checkpoint directory of the port or an Orbax one of the JAX
        package (an epoch's, its ``last``, or ``convert_ckpt``'s output), or a
        reference Lightning ``.ckpt`` -> a TrainState on the device, without
        optimizer. A ``.ckpt`` is converted in place and the model rebuilt
        around the checkpoint's own CLIP, whatever the session's
        ``clip_init``; a directory carries only the trainable tree and is
        scored with the session's CLIP."""
        path = Path(ckpt_path)
        if path.suffix == ".ckpt" and path.is_file():
            # released reference checkpoint (reference contract: src/eval.py:73,
            # README.md:72-76)
            from anomalyclip_tpu_torch.convert_ckpt import (
                convert_lightning_checkpoint,
                converted_clip_config,
                load_lightning_state_dict,
            )

            sd = load_lightning_state_dict(path)  # one disk load, shared
            frozen, trainable, bn_state = convert_lightning_checkpoint(sd)
            return self.adopt_converted_state(frozen, trainable, bn_state, converted_clip_config(sd))
        restored = self.ckpt.restore(path, device=self.device)
        ctx = restored["trainable"]["prompt_ctx"]
        if ctx.shape[-1] != self.model.prompt_spec.ctx_dim:
            raise ValueError(
                f"checkpoint prompt ctx dim {ctx.shape[-1]} does not match "
                f"the session's CLIP text width {self.model.prompt_spec.ctx_dim} "
                "— evaluate with the model config the checkpoint was trained with"
            )
        return TrainState(
            trainable=restored["trainable"],
            optimizer=None,
            bn_state=restored["bn_state"],
            step=int(restored["step"]),
        )

    def adopt_converted_state(self, frozen, trainable, bn_state: BNState, clip_cfg: CLIPConfig) -> TrainState:
        """Swap this module onto already-converted parameter trees of the port
        (``convert.params_from_jax`` of the JAX package's trees, say): rebuild
        the model around the trees' own CLIP and drop the cached scorer."""
        n_ctx = int(trainable["prompt_ctx"].shape[-2])
        # rebuild unconditionally: prompt_spec (token prefix/suffix, EOT
        # indices) is derived from the token embedding
        self.net_cfg = dataclasses.replace(self.net_cfg, n_ctx=n_ctx)
        self.model, frozen = AnomalyCLIP.build(self.net_cfg, frozen["clip"], clip_cfg)
        self._route_tp()
        self.frozen = self._place_frozen(frozen)
        self._encode_frames_fn = self._scorer_cache = None
        return TrainState(
            trainable=tree_to(trainable, self.device),
            optimizer=None,
            bn_state=bn_state.to(self.device),
            step=0,
        )

    def test(
        self,
        ckpt_path=None,
        state: Optional[TrainState] = None,
        limit: Optional[int] = None,
    ) -> Dict:
        """Full test pass + artifacts (anomaly_clip_module.py:459-691); with
        ``data.visualize``, an mp4 of each video that has frames
        (eval/visualizer.py)."""
        if state is None:
            if ckpt_path is None:
                raise ValueError("test() needs a checkpoint path or a TrainState")
            state = self.load_state(ckpt_path)
        if self.ncentroid is None:
            self.compute_ncentroid()

        trainer_cfg = self.cfg.get("trainer") or {}
        limit = limit if limit is not None else trainer_cfg.get("limit_test_batches")
        test_loader, contribute = self._videos(
            self.datamodule.test_dataloader, limit_count(len(self.datamodule.test_dataloader()), limit)
        )
        on_video = None
        if self.datamodule.cfg.visualize and contribute:
            from anomalyclip_tpu_torch.eval.visualizer import Visualizer

            viz = Visualizer(
                normal_id=self.net_cfg.normal_id,
                labels_file=self.datamodule.cfg.labels_file,
                image_tmpl=self.datamodule.cfg.image_tmpl,
                save_dir=self.save_dir,
                frame_step=self.datamodule.cfg.visualize_frame_step,
            )
            on_video = viz.process_video

        outputs = evaluate_videos(test_loader, self._scorer(state), self.model, on_video=on_video,
                                  gather_processes=True, contribute=contribute)
        if not outputs:
            # empty test pass (limit_test_batches=0 / empty annotation file)
            log.warning("test pass scored zero videos — no metrics written")
            return {}
        log_stage(f"test scored {len(outputs['labels'])} frames")
        metrics = write_test_artifacts(
            self.save_dir,
            outputs["abnormal_scores"],
            outputs["labels"],
            outputs["class_probs"],
            self.net_cfg.normal_id,
            self.datamodule.num_classes,
            read_classnames(self.datamodule.cfg.labels_file),
            write_files=is_host_zero(),
        )
        if is_host_zero():
            log.info(
                f"test: AUC={metrics['auc_roc']:.4f} AP={metrics['auc_pr']:.4f} "
                f"(artifacts in {self.save_dir})"
            )
        return metrics
