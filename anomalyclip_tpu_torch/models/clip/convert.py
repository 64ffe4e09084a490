"""OpenAI CLIP checkpoint -> the port's CLIP parameter tree: the counterpart of
anomalyclip_tpu/models/clip/convert.py.

Replaces the reference's ``clip.load`` + ``build_model`` path (reference:
src/models/components/clip/clip.py:108-222, model.py:462-519): the architecture is
inferred from state-dict shapes and the tensors are laid out as the port's tree
(models/clip/model.py): each transformer's ``blocks`` a list with one
dictionary per layer, linear weights transposed for right-multiplication
(``qkv_w`` (D, 3D)), the patch embedding (3*p*p, width) in channel-major order,
every leaf an fp32 tensor on the CPU. fp16 files, as OpenAI released them, are
upcast exactly.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from anomalyclip_tpu_torch.convert import params_from_jax
from anomalyclip_tpu_torch.models.clip.model import CLIPConfig, Params


def _to_numpy(t: Any) -> np.ndarray:
    return np.asarray(t.detach().cpu().float().numpy())


def load_torch_state_dict(path: str | Path) -> Dict[str, np.ndarray]:
    """Load a CLIP checkpoint (TorchScript archive or plain state dict) to fp32
    numpy."""
    path = str(path)
    try:
        model = torch.jit.load(path, map_location="cpu")
        state_dict = model.state_dict()
    except RuntimeError:
        state_dict = torch.load(path, map_location="cpu")
        if hasattr(state_dict, "state_dict"):
            state_dict = state_dict.state_dict()
    return {k: _to_numpy(v) for k, v in state_dict.items()}


def config_from_state_dict(sd: Dict[str, np.ndarray]) -> CLIPConfig:
    """Infer CLIPConfig from checkpoint shapes (model.py:462-499): ViT when
    ``visual.proj`` exists, ModifiedResNet otherwise."""
    if "visual.proj" in sd:
        vision_width = sd["visual.conv1.weight"].shape[0]
        vision_layers = len(
            [k for k in sd if k.startswith("visual.") and k.endswith(".attn.in_proj_weight")]
        )
        vision_patch_size = sd["visual.conv1.weight"].shape[-1]
        grid_size = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
        image_resolution = vision_patch_size * grid_size
    else:
        vision_layers = tuple(
            len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{b}")})
            for b in (1, 2, 3, 4)
        )
        vision_width = sd["visual.layer1.0.conv1.weight"].shape[0]
        output_width = round(
            (sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5
        )
        vision_patch_size = None
        image_resolution = output_width * 32
    return CLIPConfig(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=image_resolution,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=vision_patch_size,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=sd["ln_final.weight"].shape[0],
        transformer_heads=sd["ln_final.weight"].shape[0] // 64,
        transformer_layers=len(
            {k.split(".")[2] for k in sd if k.startswith("transformer.resblocks")}
        ),
    )


def _t(x: np.ndarray) -> torch.Tensor:
    """An fp32 CPU tensor with its own contiguous copy of ``x``."""
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _blocks(sd: Dict[str, np.ndarray], prefix: str, layers: int) -> List[Params]:
    """Per-layer resblock weights, one dictionary a layer, linear weights
    transposed for right-multiplication."""
    out = []
    for i in range(layers):
        p = f"{prefix}.resblocks.{i}"
        out.append({
            "ln_1": {"scale": _t(sd[f"{p}.ln_1.weight"]), "bias": _t(sd[f"{p}.ln_1.bias"])},
            "attn": {
                "qkv_w": _t(sd[f"{p}.attn.in_proj_weight"].T),
                "qkv_b": _t(sd[f"{p}.attn.in_proj_bias"]),
                "out_w": _t(sd[f"{p}.attn.out_proj.weight"].T),
                "out_b": _t(sd[f"{p}.attn.out_proj.bias"]),
            },
            "ln_2": {"scale": _t(sd[f"{p}.ln_2.weight"]), "bias": _t(sd[f"{p}.ln_2.bias"])},
            "mlp": {
                "fc_w": _t(sd[f"{p}.mlp.c_fc.weight"].T),
                "fc_b": _t(sd[f"{p}.mlp.c_fc.bias"]),
                "proj_w": _t(sd[f"{p}.mlp.c_proj.weight"].T),
                "proj_b": _t(sd[f"{p}.mlp.c_proj.bias"]),
            },
        })
    return out


def _conv_hwio(w: np.ndarray) -> np.ndarray:
    """torch OIHW conv kernel -> HWIO."""
    return w.transpose(2, 3, 1, 0).copy()


def _bn_params(sd: Dict[str, np.ndarray], prefix: str) -> Params:
    return {
        "scale": sd[f"{prefix}.weight"],
        "bias": sd[f"{prefix}.bias"],
        "mean": sd[f"{prefix}.running_mean"],
        "var": sd[f"{prefix}.running_var"],
    }


def _resnet_visual_params(sd: Dict[str, np.ndarray], cfg: CLIPConfig) -> Params:
    """ModifiedResNet weights -> the JAX package's numpy layout of that tower
    (anomalyclip_tpu/models/clip/resnet.py); the port has no ResNet tower yet
    (ROADMAP.md section 1, item 7)."""

    def bottleneck(prefix: str) -> Params:
        p = {
            "conv1_w": _conv_hwio(sd[f"{prefix}.conv1.weight"]),
            "bn1": _bn_params(sd, f"{prefix}.bn1"),
            "conv2_w": _conv_hwio(sd[f"{prefix}.conv2.weight"]),
            "bn2": _bn_params(sd, f"{prefix}.bn2"),
            "conv3_w": _conv_hwio(sd[f"{prefix}.conv3.weight"]),
            "bn3": _bn_params(sd, f"{prefix}.bn3"),
        }
        if f"{prefix}.downsample.0.weight" in sd:
            p["down_conv_w"] = _conv_hwio(sd[f"{prefix}.downsample.0.weight"])
            p["down_bn"] = _bn_params(sd, f"{prefix}.downsample.1")
        return p

    visual: Params = {
        "stem": {
            "conv1_w": _conv_hwio(sd["visual.conv1.weight"]),
            "bn1": _bn_params(sd, "visual.bn1"),
            "conv2_w": _conv_hwio(sd["visual.conv2.weight"]),
            "bn2": _bn_params(sd, "visual.bn2"),
            "conv3_w": _conv_hwio(sd["visual.conv3.weight"]),
            "bn3": _bn_params(sd, "visual.bn3"),
        },
        "attnpool": {
            "positional_embedding": sd["visual.attnpool.positional_embedding"],
            "q_w": sd["visual.attnpool.q_proj.weight"].T.copy(),
            "q_b": sd["visual.attnpool.q_proj.bias"],
            "k_w": sd["visual.attnpool.k_proj.weight"].T.copy(),
            "k_b": sd["visual.attnpool.k_proj.bias"],
            "v_w": sd["visual.attnpool.v_proj.weight"].T.copy(),
            "v_b": sd["visual.attnpool.v_proj.bias"],
            "c_w": sd["visual.attnpool.c_proj.weight"].T.copy(),
            "c_b": sd["visual.attnpool.c_proj.bias"],
        },
    }
    for li, blocks in enumerate(cfg.vision_layers, start=1):
        visual[f"layer{li}"] = [
            bottleneck(f"visual.layer{li}.{bi}") for bi in range(blocks)
        ]
    return visual


def torch_state_dict_to_params(
    sd: Dict[str, np.ndarray],
) -> Tuple[Params, CLIPConfig]:
    """Convert an OpenAI CLIP state dict (numpy values) into the port's tree
    (fp32 tensors on the CPU) and its config."""
    cfg = config_from_state_dict(sd)
    if cfg.is_resnet:
        # as convert.params_from_jax carries the JAX package's ResNet tree
        visual = params_from_jax(_resnet_visual_params(sd, cfg), device="cpu")
    else:
        conv = sd["visual.conv1.weight"]  # (width, 3, p, p), flattens channel-major
        visual = {
            "patch_embed": _t(conv.reshape(cfg.vision_width, -1).T),
            "class_embedding": _t(sd["visual.class_embedding"]),
            "positional_embedding": _t(sd["visual.positional_embedding"]),
            "ln_pre": {"scale": _t(sd["visual.ln_pre.weight"]), "bias": _t(sd["visual.ln_pre.bias"])},
            "blocks": _blocks(sd, "visual.transformer", cfg.vision_layers),
            "ln_post": {"scale": _t(sd["visual.ln_post.weight"]), "bias": _t(sd["visual.ln_post.bias"])},
            "proj": _t(sd["visual.proj"]),
        }
    text = {
        "token_embedding": _t(sd["token_embedding.weight"]),
        "positional_embedding": _t(sd["positional_embedding"]),
        "blocks": _blocks(sd, "transformer", cfg.transformer_layers),
        "ln_final": {"scale": _t(sd["ln_final.weight"]), "bias": _t(sd["ln_final.bias"])},
        "text_projection": _t(sd["text_projection"]),
    }
    params: Params = {
        "visual": visual,
        "text": text,
        "logit_scale": _t(sd["logit_scale"]),
    }
    return params, cfg


def load_torch_clip_checkpoint(path: str | Path) -> Tuple[Params, CLIPConfig]:
    """One-call loader: torch checkpoint file -> (the port's tree, config)."""
    return torch_state_dict_to_params(load_torch_state_dict(path))


def state_dict_from_params(params: Params) -> Dict[str, torch.Tensor]:
    """The inverse of ``torch_state_dict_to_params`` for a ViT tree: the
    port's CLIP tree -> a state dict in OpenAI's key layout, fp32 tensors on
    the CPU (what ``torch.save`` of an OpenAI CLIP's ``state_dict()`` holds)."""
    sd: Dict[str, torch.Tensor] = {}

    def c(t: torch.Tensor) -> torch.Tensor:
        return t.detach().float().cpu().contiguous().clone()

    def blocks(prefix: str, layers: List[Params]) -> None:
        for i, b in enumerate(layers):
            p = f"{prefix}.resblocks.{i}"
            sd[f"{p}.attn.in_proj_weight"] = c(b["attn"]["qkv_w"].T)
            sd[f"{p}.attn.in_proj_bias"] = c(b["attn"]["qkv_b"])
            sd[f"{p}.attn.out_proj.weight"] = c(b["attn"]["out_w"].T)
            sd[f"{p}.attn.out_proj.bias"] = c(b["attn"]["out_b"])
            sd[f"{p}.ln_1.weight"], sd[f"{p}.ln_1.bias"] = c(b["ln_1"]["scale"]), c(b["ln_1"]["bias"])
            sd[f"{p}.mlp.c_fc.weight"] = c(b["mlp"]["fc_w"].T)
            sd[f"{p}.mlp.c_fc.bias"] = c(b["mlp"]["fc_b"])
            sd[f"{p}.mlp.c_proj.weight"] = c(b["mlp"]["proj_w"].T)
            sd[f"{p}.mlp.c_proj.bias"] = c(b["mlp"]["proj_b"])
            sd[f"{p}.ln_2.weight"], sd[f"{p}.ln_2.bias"] = c(b["ln_2"]["scale"]), c(b["ln_2"]["bias"])

    visual, text = params["visual"], params["text"]
    if "patch_embed" not in visual:
        raise NotImplementedError("the ModifiedResNet tower is not ported yet (ROADMAP.md section 1, item 7)")
    width = visual["patch_embed"].shape[1]
    patch = round((visual["patch_embed"].shape[0] // 3) ** 0.5)
    sd["visual.class_embedding"] = c(visual["class_embedding"])
    sd["visual.positional_embedding"] = c(visual["positional_embedding"])
    sd["visual.proj"] = c(visual["proj"])
    sd["visual.conv1.weight"] = c(visual["patch_embed"].T.reshape(width, 3, patch, patch))
    sd["visual.ln_pre.weight"], sd["visual.ln_pre.bias"] = c(visual["ln_pre"]["scale"]), c(visual["ln_pre"]["bias"])
    blocks("visual.transformer", visual["blocks"])
    sd["visual.ln_post.weight"], sd["visual.ln_post.bias"] = c(visual["ln_post"]["scale"]), c(visual["ln_post"]["bias"])
    sd["positional_embedding"] = c(text["positional_embedding"])
    sd["text_projection"] = c(text["text_projection"])
    sd["logit_scale"] = c(params["logit_scale"])
    blocks("transformer", text["blocks"])
    sd["token_embedding.weight"] = c(text["token_embedding"])
    sd["ln_final.weight"], sd["ln_final.bias"] = c(text["ln_final"]["scale"]), c(text["ln_final"]["bias"])
    return sd
