"""The AnomalyCLIP composite model: CLIP features -> text-driven direction
scores -> MIL selection -> axial temporal scores. The counterpart of
anomalyclip_tpu/models/anomaly_clip.py (forward_train, forward_test and the
pieces they run).

Parameters are split as in the JAX package: ``frozen`` ({"clip": CLIP params},
never requiring grad), ``trainable`` ({"prompt_ctx", "text_projection",
"temporal"}, the leaves the optimizer updates) and the selector's ``BNState``.
"""

from __future__ import annotations

import csv
import dataclasses
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from anomalyclip_tpu_torch.eval.grids import ENCODE_CHUNK as _ENCODE_CHUNK
from anomalyclip_tpu_torch.models.clip.model import (
    CLIPConfig,
    encode_image,
    text_transformer_on_embeddings,
)
from anomalyclip_tpu_torch.models.prompt_learner import (
    PromptSpec,
    assemble_prompts,
    build_prompt_spec,
    init_prompt_params,
)
from anomalyclip_tpu_torch.models.selector import (
    BNState,
    SelectorConfig,
    selector_test,
    selector_train,
)
from anomalyclip_tpu_torch.models.temporal import (
    TemporalConfig,
    init_temporal_params,
    temporal_scores,
)
from anomalyclip_tpu_torch.numerics import matmul_precision_for

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def read_classnames(labels_file: str | Path) -> List[str]:
    """Classnames sorted alphabetically (the shipped label tables already are)."""
    with open(labels_file) as f:
        rows = list(csv.DictReader(f))
    return sorted(row["name"] for row in rows)


@dataclasses.dataclass(frozen=True)
class AnomalyCLIPConfig:
    """The JAX package's AnomalyCLIPConfig (the `net:` config block)."""

    arch: str = "ViT-B/16"
    labels_file: str = ""
    emb_size: int = 256
    depth: int = 1
    heads: int = 8
    dim_heads: Optional[int] = None
    num_segments: int = 32
    seg_length: int = 16
    concat_features: bool = False
    normal_id: int = 7
    stride: int = 1
    load_from_features: bool = True
    select_idx_dropout_topk: float = 0.7
    select_idx_dropout_bottomk: float = 0.7
    ncrops: int = 1
    num_topk: int = 3
    num_bottomk: int = 3
    n_ctx: int = 8
    shared_context: bool = False
    ctx_init: str = ""
    class_token_position: str = "end"
    # "none" | "int8": the frozen visual tower's GEMMs in int8 for serving
    # (W8A8, models/clip/quant.py). Serving only: the module routes fit(), its
    # ncentroid pass included, through the fp tower
    # (train/module.py:_int8_serving_active)
    quantize: str = "none"
    compute_dtype: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


class TrainOutput(NamedTuple):
    """Training forward outputs."""

    logits: torch.Tensor  # (b*n*l, C-1)
    logits_topk: torch.Tensor  # (b*k*l, C-1)
    scores: torch.Tensor  # (b*n*l,)
    idx_topk_abn: torch.Tensor
    idx_topk_nor: torch.Tensor
    idx_bottomk_abn: torch.Tensor


class AnomalyCLIP:
    """Static model description (configs, prompt spec, classnames) and the
    forwards as functions over the parameter trees."""

    # frames per image-encoder call (anomaly_clip.py:221): the chunked encode
    # loop's (eval/grids.py), so that every encoder call sees one static shape
    ENCODE_CHUNK = _ENCODE_CHUNK

    def __init__(
        self,
        cfg: AnomalyCLIPConfig,
        clip_cfg: CLIPConfig,
        classnames: List[str],
        prompt_spec: PromptSpec,
    ):
        self.cfg = cfg
        self.clip_cfg = clip_cfg
        self.classnames = classnames
        self.prompt_spec = prompt_spec
        self.embedding_dim = clip_cfg.embed_dim
        self.selector_cfg = SelectorConfig(
            normal_id=cfg.normal_id,
            num_segments=cfg.num_segments,
            seg_length=cfg.seg_length,
            select_idx_dropout_topk=cfg.select_idx_dropout_topk,
            select_idx_dropout_bottomk=cfg.select_idx_dropout_bottomk,
            num_topk=cfg.num_topk,
            num_bottomk=cfg.num_bottomk,
        )
        n_cls = len(classnames)
        self.temporal_cfg = TemporalConfig(
            input_size=clip_cfg.embed_dim + (n_cls - 1) * int(cfg.concat_features),
            emb_size=cfg.emb_size,
            depth=cfg.depth,
            heads=cfg.heads,
            dim_heads=cfg.dim_heads,
            num_segments=cfg.num_segments,
            seg_length=cfg.seg_length,
        )

    @staticmethod
    def build(
        cfg: AnomalyCLIPConfig, clip_params: Params, clip_cfg: CLIPConfig
    ) -> Tuple["AnomalyCLIP", Params]:
        """The static model from CLIP parameters -> (model, frozen)."""
        classnames = read_classnames(cfg.labels_file)
        spec = build_prompt_spec(
            classnames,
            clip_params["text"]["token_embedding"].cpu().numpy(),
            n_ctx=cfg.n_ctx,
            shared_context=cfg.shared_context,
            ctx_init=cfg.ctx_init,
            class_token_position=cfg.class_token_position,
        )
        return AnomalyCLIP(cfg, clip_cfg, classnames, spec), {"clip": clip_params}

    def init_trainable(self, gen: torch.Generator, frozen: Params) -> Tuple[Params, BNState]:
        """Seeded trainable parameters (on the CPU) and a fresh BN state."""
        token_embedding = frozen["clip"]["text"]["token_embedding"].cpu().numpy()
        trainable = {
            "prompt_ctx": init_prompt_params(
                gen, self.prompt_spec, token_embedding, self.cfg.ctx_init
            ),
            "text_projection": frozen["clip"]["text"]["text_projection"].float().cpu().clone(),
            "temporal": init_temporal_params(gen, self.temporal_cfg),
        }
        return trainable, BNState.create(len(self.classnames) - 1)

    # -- forward pieces -----------------------------------------------------

    def text_features(self, frozen: Params, trainable: Params) -> torch.Tensor:
        """Prompt assembly -> text transformer -> (n_cls, embed_dim)."""
        ctx = trainable["prompt_ctx"]
        prompts = assemble_prompts(ctx, self.prompt_spec)
        eot = torch.as_tensor(self.prompt_spec.eot_indices, dtype=torch.long, device=ctx.device)
        return text_transformer_on_embeddings(
            frozen["clip"],
            self.clip_cfg,
            prompts,
            eot,
            text_projection=trainable["text_projection"],
            compute_dtype=self.cfg.dtype,
        )

    def encode_frames(self, frozen: Params, frames: torch.Tensor) -> torch.Tensor:
        """Frozen CLIP image encoding of (N, H, W, 3) frames, in ENCODE_CHUNK
        calls when N is a multiple of it."""
        n, chunk = frames.shape[0], self.ENCODE_CHUNK
        with torch.no_grad():
            if n > chunk and n % chunk == 0:
                return torch.cat(
                    [
                        encode_image(frozen["clip"], self.clip_cfg, c, self.cfg.dtype)
                        for c in frames.split(chunk)
                    ]
                )
            return encode_image(frozen["clip"], self.clip_cfg, frames, self.cfg.dtype)

    def _temporal_input(
        self, image_features: torch.Tensor, similarity: torch.Tensor, ncentroid: torch.Tensor
    ) -> torch.Tensor:
        """Re-center; optionally prepend the similarity logits."""
        recentered = image_features - ncentroid
        if self.cfg.concat_features:
            return torch.cat([similarity, recentered], dim=-1)
        return recentered

    def forward_train(
        self,
        frozen: Params,
        trainable: Params,
        bn_state: BNState,
        image_features: torch.Tensor,
        labels: torch.Tensor,
        ncentroid: torch.Tensor,
        gen: torch.Generator,
        dp: Optional[Tuple[int, int]] = None,
    ) -> Tuple[TrainOutput, BNState]:
        """Training forward, differentiable in ``trainable``.

        image_features: (b, t=n*l, D) CLIP features, abnormal half first, or
        (b, t, H, W, 3) frames when load_from_features is False (encoded by the
        frozen tower, without gradient); labels: (b,). ``gen`` draws the
        selector's segment-dropout masks. ``dp=(rank, ranks)``: the batch is
        this rank's block of a data-parallel global batch (``selector_train``)."""
        with matmul_precision_for(self.cfg.dtype):
            if not self.cfg.load_from_features:
                b, t = image_features.shape[:2]
                frames = image_features.reshape((-1,) + tuple(image_features.shape[2:]))
                image_features = self.encode_frames(frozen, frames).reshape(b, t, -1)

            flat = image_features.reshape(-1, image_features.shape[-1])
            text_features = self.text_features(frozen, trainable)
            selection, new_bn = selector_train(
                flat, text_features, labels, ncentroid, bn_state, gen, self.selector_cfg, dp=dp
            )
            features = self._temporal_input(flat, selection.logits, ncentroid)
            scores = temporal_scores(
                features, trainable["temporal"], self.temporal_cfg, test_mode=False
            ).reshape(-1)
            output = TrainOutput(
                logits=selection.logits,
                logits_topk=selection.logits_topk,
                scores=scores,
                idx_topk_abn=selection.idx_topk_abn,
                idx_topk_nor=selection.idx_topk_nor,
                idx_bottomk_abn=selection.idx_bottomk_abn,
            )
            return output, new_bn

    def forward_test(
        self,
        frozen: Params,
        trainable: Params,
        bn_state: BNState,
        image_features: torch.Tensor,
        ncentroid: torch.Tensor,
        segment_size: int,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Test forward for one padded video.

        image_features: (b, t, D) with t = num_segments * segment_size * seg_length,
        or (b, t, H, W, 3) frames when load_from_features is False.
        Returns (similarity (t*stride, C-1), scores (t*stride,))."""
        with torch.no_grad(), matmul_precision_for(self.cfg.dtype):
            if not self.cfg.load_from_features:
                b, t = image_features.shape[:2]
                frames = image_features.reshape((-1,) + tuple(image_features.shape[2:]))
                image_features = self.encode_frames(frozen, frames).reshape(b, t, -1)

            flat = image_features.reshape(-1, image_features.shape[-1])
            text_features = self.text_features(frozen, trainable)
            similarity = selector_test(
                flat, text_features, ncentroid, bn_state, self.selector_cfg
            )
            features = self._temporal_input(flat, similarity, ncentroid)
            scores = temporal_scores(
                features,
                trainable["temporal"],
                self.temporal_cfg,
                segment_size=segment_size,
                test_mode=True,
            ).reshape(-1)
            similarity = similarity.repeat_interleave(self.cfg.stride, dim=0)
            scores = scores.repeat_interleave(self.cfg.stride, dim=0)
            return similarity, scores
