"""OpenAI CLIP checkpoint -> the port's CLIP parameter tree: the counterpart of
anomalyclip_tpu/models/clip/convert.py.

Replaces the reference's ``clip.load`` + ``build_model`` path (reference:
src/models/components/clip/clip.py:108-222, model.py:462-519): the architecture is
inferred from state-dict shapes and the tensors are laid out as the port's tree
(models/clip/model.py): each transformer's ``blocks`` a list with one
dictionary per layer, linear weights transposed for right-multiplication
(``qkv_w`` (D, 3D)), the patch embedding (3*p*p, width) in channel-major order,
the ModifiedResNet's conv kernels OIHW as the file holds them, every leaf an
fp32 tensor on the CPU. fp16 files, as OpenAI released them, are
upcast exactly.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

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


def _bn_params(sd: Dict[str, np.ndarray], prefix: str) -> Params:
    return {
        "scale": _t(sd[f"{prefix}.weight"]),
        "bias": _t(sd[f"{prefix}.bias"]),
        "mean": _t(sd[f"{prefix}.running_mean"]),
        "var": _t(sd[f"{prefix}.running_var"]),
    }


# the three convs, each with its BN, of the ModifiedResNet's stem
# (``visual.<name>``) and of each bottleneck: (key in the port's tree, name in
# the state dict)
_CONVS = (("conv1_w", "conv1"), ("conv2_w", "conv2"), ("conv3_w", "conv3"))
_ATTNPOOL_LINEARS = (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("c", "c_proj"))


def _resnet_visual_params(sd: Dict[str, np.ndarray], cfg: CLIPConfig) -> Params:
    """ModifiedResNet weights -> the port's tree of that tower
    (models/clip/resnet.py): conv kernels OIHW as the state dict holds them,
    BN parameters with their running statistics, the attention pool's linear
    weights transposed for right-multiplication."""

    def conv_bn(prefix: str) -> Params:
        p: Params = {}
        for i, (key, name) in enumerate(_CONVS, start=1):
            p[key] = _t(sd[f"{prefix}.{name}.weight"])
            p[f"bn{i}"] = _bn_params(sd, f"{prefix}.bn{i}")
        return p

    def bottleneck(prefix: str) -> Params:
        p = conv_bn(prefix)
        if f"{prefix}.downsample.0.weight" in sd:
            p["down_conv_w"] = _t(sd[f"{prefix}.downsample.0.weight"])
            p["down_bn"] = _bn_params(sd, f"{prefix}.downsample.1")
        return p

    attnpool: Params = {"positional_embedding": _t(sd["visual.attnpool.positional_embedding"])}
    for key, name in _ATTNPOOL_LINEARS:
        attnpool[f"{key}_w"] = _t(sd[f"visual.attnpool.{name}.weight"].T)
        attnpool[f"{key}_b"] = _t(sd[f"visual.attnpool.{name}.bias"])
    visual: Params = {"stem": conv_bn("visual")}
    for li, blocks in enumerate(cfg.vision_layers, start=1):
        visual[f"layer{li}"] = [bottleneck(f"visual.layer{li}.{bi}") for bi in range(blocks)]
    visual["attnpool"] = attnpool
    return visual


def torch_state_dict_to_params(
    sd: Dict[str, np.ndarray],
) -> Tuple[Params, CLIPConfig]:
    """Convert an OpenAI CLIP state dict (numpy values) into the port's tree
    (fp32 tensors on the CPU) and its config."""
    cfg = config_from_state_dict(sd)
    if cfg.is_resnet:
        visual = _resnet_visual_params(sd, cfg)
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
    """The inverse of ``torch_state_dict_to_params``, ViT or ModifiedResNet:
    the port's CLIP tree -> a state dict in OpenAI's key layout, fp32 tensors
    on the CPU (what ``torch.save`` of an OpenAI CLIP's ``state_dict()``
    holds, without the BN layers' ``num_batches_tracked``, which no
    conversion reads)."""
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

    def bn(prefix: str, p: Params) -> None:
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = c(p["scale"]), c(p["bias"])
        sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"] = c(p["mean"]), c(p["var"])

    def conv_bn(prefix: str, p: Params) -> None:
        for i, (key, name) in enumerate(_CONVS, start=1):
            sd[f"{prefix}.{name}.weight"] = c(p[key])
            bn(f"{prefix}.bn{i}", p[f"bn{i}"])

    visual, text = params["visual"], params["text"]
    if "stem" in visual:
        conv_bn("visual", visual["stem"])
        for li in range(1, 5):
            for bi, block in enumerate(visual[f"layer{li}"]):
                prefix = f"visual.layer{li}.{bi}"
                conv_bn(prefix, block)
                if "down_conv_w" in block:
                    sd[f"{prefix}.downsample.0.weight"] = c(block["down_conv_w"])
                    bn(f"{prefix}.downsample.1", block["down_bn"])
        pool = visual["attnpool"]
        sd["visual.attnpool.positional_embedding"] = c(pool["positional_embedding"])
        for key, name in _ATTNPOOL_LINEARS:
            sd[f"visual.attnpool.{name}.weight"] = c(pool[f"{key}_w"].T)
            sd[f"visual.attnpool.{name}.bias"] = c(pool[f"{key}_b"])
    else:
        width = visual["patch_embed"].shape[1]
        patch = round((visual["patch_embed"].shape[0] // 3) ** 0.5)
        sd["visual.class_embedding"] = c(visual["class_embedding"])
        sd["visual.positional_embedding"] = c(visual["positional_embedding"])
        sd["visual.proj"] = c(visual["proj"])
        sd["visual.conv1.weight"] = c(visual["patch_embed"].T.reshape(width, 3, patch, patch))
        sd["visual.ln_pre.weight"], sd["visual.ln_pre.bias"] = c(visual["ln_pre"]["scale"]), c(visual["ln_pre"]["bias"])
        blocks("visual.transformer", visual["blocks"])
        sd["visual.ln_post.weight"] = c(visual["ln_post"]["scale"])
        sd["visual.ln_post.bias"] = c(visual["ln_post"]["bias"])
    sd["positional_embedding"] = c(text["positional_embedding"])
    sd["text_projection"] = c(text["text_projection"])
    sd["logit_scale"] = c(params["logit_scale"])
    blocks("transformer", text["blocks"])
    sd["token_embedding.weight"] = c(text["token_embedding"])
    sd["ln_final.weight"], sd["ln_final.bias"] = c(text["ln_final"]["scale"]), c(text["ln_final"]["bias"])
    return sd
