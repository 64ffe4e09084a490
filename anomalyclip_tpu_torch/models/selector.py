"""Direction scoring and the eval-mode BatchNorm of the selector: the test branch
of anomalyclip_tpu/models/selector.py (:32-124, :259-270). The training branch
(top-k/bottom-k selection, dropout masks, BN statistics updates) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from anomalyclip_tpu_torch.numerics import full_fp32


class BNState(NamedTuple):
    """Running statistics of the non-affine BatchNorm over the (n_cls-1) logit
    channels."""

    mean: torch.Tensor  # (n_cls - 1,)
    var: torch.Tensor  # (n_cls - 1,)

    @staticmethod
    def create(num_channels: int) -> "BNState":
        return BNState(mean=torch.zeros(num_channels), var=torch.ones(num_channels))

    def to(self, device) -> "BNState":
        return BNState(mean=self.mean.to(device), var=self.var.to(device))


@dataclasses.dataclass(frozen=True)
class SelectorConfig:
    normal_id: int
    num_segments: int = 32
    seg_length: int = 16
    select_idx_dropout_topk: float = 0.7
    select_idx_dropout_bottomk: float = 0.7
    num_topk: int = 3
    num_bottomk: int = 3
    bn_momentum: float = 0.1
    bn_eps: float = 1e-5


def direction_logits(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    ncentroid: torch.Tensor,
    normal_id: int,
) -> torch.Tensor:
    """Scalar projection of re-centered image features (T, D) onto the
    re-centered, L2-normalized abnormal-class text directions -> (T, C-1).
    fp32 operands get full fp32 products, as the JAX package's
    Precision.HIGHEST does."""
    text = torch.cat([text_features[:normal_id], text_features[normal_id + 1 :]], dim=0)
    text = text - ncentroid
    text = text / torch.linalg.vector_norm(text, dim=-1, keepdim=True)
    image = image_features - ncentroid
    if image.dtype == torch.float32:
        with full_fp32():
            return image @ text.T.to(image.dtype)
    return image @ text.T.to(image.dtype)


def batch_norm_apply(logits: torch.Tensor, state: BNState, eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode non-affine BatchNorm1d over channels, with running statistics."""
    return (logits - state.mean) * torch.rsqrt(state.var + eps)


def selector_test(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    ncentroid: torch.Tensor,
    bn_state: BNState,
    cfg: SelectorConfig,
) -> torch.Tensor:
    """Test-mode selector: normalized direction logits only."""
    raw = direction_logits(image_features, text_features, ncentroid, cfg.normal_id)
    return batch_norm_apply(raw, bn_state, eps=cfg.bn_eps)
