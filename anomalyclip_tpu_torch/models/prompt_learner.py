"""CoOp prompt learner: the counterpart of anomalyclip_tpu/models/prompt_learner.py.

The frozen pieces (SOS prefix embedding, classname+EOT suffix embeddings,
tokenized prompt ids) are built once into a static :class:`PromptSpec` with
numpy; the only trainable tensor is ``ctx``. ``assemble_prompts`` concatenates
[prefix, ctx, suffix] for class_token_position="end", and applies the spec's
per-class row permutation for "middle" and "front".
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from anomalyclip_tpu_torch.models.clip.tokenizer import (
    ClipTokenizer,
    _get_default_tokenizer,
    tokenize,
)


@dataclasses.dataclass(frozen=True)
class PromptSpec:
    token_prefix: np.ndarray  # (n_cls, 1, dim) SOS embedding
    token_suffix: np.ndarray  # (n_cls, 77 - 1 - n_ctx, dim) classname + EOT + pad
    tokenized_prompts: np.ndarray  # (n_cls, 77) int32, for the EOT argmax gather
    n_cls: int
    n_ctx: int
    ctx_dim: int
    shared_context: bool
    class_token_position: str = "end"
    position_perm: Optional[np.ndarray] = None  # (n_cls, 77) for "middle"/"front"
    name_lens: Optional[np.ndarray] = None  # (n_cls,) classname token counts

    @property
    def eot_indices(self) -> np.ndarray:
        return self.tokenized_prompts.argmax(axis=-1)


def _position_perm(
    position: str, n_ctx: int, name_lens: np.ndarray, context_length: int
) -> Optional[np.ndarray]:
    """(n_cls, 77) row permutation turning the "end" layout
    [SOS, ctx x n_ctx, suffix...] into the "middle"/"front" orderings. Only rows
    before the "." token move, so the EOT index is unchanged."""
    if position == "end":
        return None
    perms = []
    for name_len in np.asarray(name_lens, dtype=np.int64):
        sos = [0]
        ctx_rows = list(range(1, 1 + n_ctx))
        cls_rows = list(range(1 + n_ctx, 1 + n_ctx + name_len))
        rest = list(range(1 + n_ctx + name_len, context_length))
        if position == "middle":
            half = n_ctx // 2
            order = sos + ctx_rows[:half] + cls_rows + ctx_rows[half:] + rest
        elif position == "front":
            order = sos + cls_rows + ctx_rows + rest
        else:
            raise ValueError(f"unknown class_token_position {position!r}")
        perms.append(order)
    return np.asarray(perms, dtype=np.int32)


def build_prompt_spec(
    classnames: List[str],
    token_embedding: np.ndarray,
    n_ctx: int = 8,
    shared_context: bool = False,
    ctx_init: str = "",
    tokenizer: Optional[ClipTokenizer] = None,
    class_token_position: str = "end",
) -> PromptSpec:
    """Tokenize "X ... X <classname>." prompts and slice out the frozen embeddings."""
    if ctx_init:
        prompt_prefix = ctx_init.replace("_", " ")
        n_ctx = len(prompt_prefix.split(" "))
    else:
        prompt_prefix = " ".join(["X"] * n_ctx)

    classnames = [name.replace("_", " ") for name in classnames]
    prompts = [f"{prompt_prefix} {name}." for name in classnames]
    tokenized = tokenize(prompts, tokenizer=tokenizer)
    tok = tokenizer or _get_default_tokenizer()
    name_lens = np.asarray([len(tok.encode(name)) for name in classnames], np.int32)

    embedding = np.asarray(token_embedding)[tokenized]  # (n_cls, 77, dim)
    return PromptSpec(
        token_prefix=embedding[:, :1, :],
        token_suffix=embedding[:, 1 + n_ctx :, :],
        tokenized_prompts=tokenized,
        n_cls=len(classnames),
        n_ctx=n_ctx,
        ctx_dim=embedding.shape[-1],
        shared_context=shared_context,
        class_token_position=class_token_position,
        position_perm=_position_perm(
            class_token_position, n_ctx, name_lens, tokenized.shape[1]
        ),
        name_lens=name_lens,
    )


def init_prompt_params(
    gen: torch.Generator,
    spec: PromptSpec,
    token_embedding: Optional[np.ndarray] = None,
    ctx_init: str = "",
    tokenizer: Optional[ClipTokenizer] = None,
) -> torch.Tensor:
    """The trainable context tensor ``ctx``: the ``ctx_init`` words' embeddings,
    or normal with std 0.02 (the distribution of init_prompt_params)."""
    if ctx_init:
        prompt = tokenize(ctx_init.replace("_", " "), tokenizer=tokenizer)
        vectors = np.asarray(token_embedding)[prompt[0, 1 : 1 + spec.n_ctx]]
        ctx = torch.as_tensor(vectors, dtype=torch.float32)
        if not spec.shared_context:
            ctx = ctx[None].repeat(spec.n_cls, 1, 1)
        return ctx
    shape = (
        (spec.n_ctx, spec.ctx_dim)
        if spec.shared_context
        else (spec.n_cls, spec.n_ctx, spec.ctx_dim)
    )
    return 0.02 * torch.randn(shape, generator=gen, dtype=torch.float32)


def assemble_prompts(ctx: torch.Tensor, spec: PromptSpec) -> torch.Tensor:
    """[prefix, ctx, suffix] -> (n_cls, 77, dim) prompt embeddings, permuted per
    class for the "middle"/"front" positions."""
    if ctx.ndim == 2:
        ctx = ctx[None].expand(spec.n_cls, spec.n_ctx, spec.ctx_dim)
    prefix = torch.as_tensor(spec.token_prefix, dtype=ctx.dtype, device=ctx.device)
    suffix = torch.as_tensor(spec.token_suffix, dtype=ctx.dtype, device=ctx.device)
    prompts = torch.cat([prefix, ctx, suffix], dim=1)
    if spec.position_perm is not None:
        perm = torch.as_tensor(spec.position_perm, dtype=torch.long, device=ctx.device)
        prompts = torch.gather(prompts, 1, perm[:, :, None].expand_as(prompts))
    return prompts
