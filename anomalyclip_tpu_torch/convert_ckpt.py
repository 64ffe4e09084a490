"""Released-AnomalyCLIP-checkpoint converter: Lightning ``.ckpt`` -> the port's
trees. The counterpart of anomalyclip_tpu/convert_ckpt.py.

The reference evaluates released PyTorch-Lightning checkpoints
(reference: README.md:72-76, src/eval.py:73). This module maps such a checkpoint's
``state_dict`` — keys rooted at the LightningModule's ``net.`` attribute tree
(src/models/anomaly_clip_module.py:60, src/models/components/anomaly_clip.py:73-105) —
onto the port's three trees, fp32 tensors on the CPU:

    frozen["clip"]   CLIP visual/text weights (``net.image_encoder.*``,
                     ``net.text_encoder.*``, ``net.token_embedding.*``), via the
                     OpenAI-checkpoint converter (models/clip/convert.py)
    trainable        prompt_ctx            <- net.prompt_learner.ctx (coop.py:49)
                     text_projection       <- net.text_encoder.text_projection
                                              (trainable, anomaly_clip_module.py:72)
                     temporal              <- net.temporal_model.* incl. the
                                              lucidrains AxialImageTransformer
                                              weights (temporal_model.py:31-39)
    bn_state         selector BN running stats <- net.selector_model.bn_layer.*
                                              (selector_model.py:30)

Axial-attention key layout (the parameter paths of the pip package):

    axial_attn.pos_emb.param_{0,1}                   (1,d,n,1) / (1,d,1,l)
    axial_attn.layers.blocks.{2i}.f.net.fn.norm.*    pre-LN of the segment-axis attn
    axial_attn.layers.blocks.{2i}.f.net.fn.fn.to_{q,kv,out}.*
    axial_attn.layers.blocks.{2i}.g.net....          frame-axis attn
    axial_attn.layers.blocks.{2i+1}.{f,g}.net.{0.g,0.b,1.*,3.*}   conv feed-forwards

The temporal model's conv kernels keep torch's OIHW layout, the one the port's
``F.conv2d`` takes. fp16-stored checkpoints are upcast to fp32 (the released
models are fp16, reference model.py:433-459).

    python -m anomalyclip_tpu_torch.convert_ckpt released.ckpt out_dir

writes a checkpoint directory of the port (``out_dir/state.pt``, epoch -1,
step 0) that ``eval_entry ckpt_path=out_dir`` reads. ``lightning_state_dict``
is the inverse of the conversion: the port's trees -> the ``net.`` keys it
reads, for writing a reference-layout ``.ckpt`` from weights of the port.

    python -m anomalyclip_tpu_torch.convert_ckpt <orbax dir> out_dir

does the same for an Orbax checkpoint directory of the JAX package (a fit's
``epoch_NNN`` or ``last``, or the JAX converter's output), read without orbax
(``train/orbax_reader.py``): ``out_dir/state.pt`` holds its trainable tree, BN
state, step and epoch and, from a fit, its optimizer state, so that a run
trained by the JAX package evaluates and resumes from the port's own format
and pays for the decode once.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from anomalyclip_tpu_torch.models.clip.convert import (
    config_from_state_dict,
    state_dict_from_params,
    torch_state_dict_to_params,
)
from anomalyclip_tpu_torch.models.selector import BNState

Params = Dict[str, Any]


def load_lightning_state_dict(path: str | Path) -> Dict[str, np.ndarray]:
    """Load a Lightning ``.ckpt`` (or a bare torch state dict) to fp32 numpy,
    with the ``net.`` module prefix stripped.

    ``weights_only=False``: a Lightning checkpoint pickles more than tensors
    (hyper-parameters, callback and loop state), which the weights-only
    unpickler refuses. Unpickling runs code from the file, so read only
    checkpoints from a source you trust, as the reference's ``torch.load`` did."""
    raw = torch.load(str(path), map_location="cpu", weights_only=False)
    sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    out = {}
    for k, v in sd.items():
        if k.startswith("net."):
            k = k[len("net."):]
        out[k] = np.asarray(v.detach().cpu().float().numpy())
    return out


# ---------------------------------------------------------------------------
# CLIP block: net.image_encoder / net.text_encoder / net.token_embedding
# ---------------------------------------------------------------------------


def clip_state_dict_from_lightning(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Re-root the CLIP weights to OpenAI-checkpoint names so the standard CLIP
    converter applies (AnomalyCLIP splits clip_model across three attributes,
    anomaly_clip.py:73-78)."""
    clip_sd: Dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if k.startswith("image_encoder."):
            clip_sd["visual." + k[len("image_encoder."):]] = v
        elif k.startswith("text_encoder.transformer."):
            clip_sd["transformer." + k[len("text_encoder.transformer."):]] = v
        elif k == "text_encoder.positional_embedding":
            clip_sd["positional_embedding"] = v
        elif k.startswith("text_encoder.ln_final."):
            clip_sd["ln_final." + k[len("text_encoder.ln_final."):]] = v
        elif k == "text_encoder.text_projection":
            clip_sd["text_projection"] = v
        elif k == "token_embedding.weight":
            clip_sd["token_embedding.weight"] = v
    # logit_scale rides on the selector (selector_model.py:12 logit_scale param)
    if "selector_model.logit_scale" in sd:
        clip_sd["logit_scale"] = sd["selector_model.logit_scale"]
    else:
        clip_sd["logit_scale"] = np.asarray(np.log(1 / 0.07), dtype=np.float32)
    return clip_sd


# ---------------------------------------------------------------------------
# Temporal model: net.temporal_model.*
# ---------------------------------------------------------------------------


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _axial_attn_params(sd: Dict[str, np.ndarray], prefix: str) -> Params:
    """One PreNorm'ed SelfAttention under ``{prefix}`` (= ....{f|g}.net.fn)."""
    return {
        "ln": {
            "scale": _t(sd[prefix + ".norm.weight"]),
            "bias": _t(sd[prefix + ".norm.bias"]),
        },
        "to_q": _t(sd[prefix + ".fn.to_q.weight"].T),
        "to_kv": _t(sd[prefix + ".fn.to_kv.weight"].T),
        "to_out_w": _t(sd[prefix + ".fn.to_out.weight"].T),
        "to_out_b": _t(sd[prefix + ".fn.to_out.bias"]),
    }


def _conv_ff_params(sd: Dict[str, np.ndarray], prefix: str) -> Params:
    """One conv feed-forward Sequential under ``{prefix}`` (= ....{f|g}.net),
    its Conv2d kernels in torch's (O, I, kh, kw)."""
    return {
        "ln_g": _t(sd[prefix + ".0.g"].reshape(-1)),
        "ln_b": _t(sd[prefix + ".0.b"].reshape(-1)),
        "conv1_w": _t(sd[prefix + ".1.weight"]),
        "conv1_b": _t(sd[prefix + ".1.bias"]),
        "conv2_w": _t(sd[prefix + ".3.weight"]),
        "conv2_b": _t(sd[prefix + ".3.bias"]),
    }


def temporal_params_from_torch(
    sd: Dict[str, np.ndarray], prefix: str = "temporal_model."
) -> Params:
    """net.temporal_model.* -> the port's tree of models/temporal.py."""
    p = prefix
    block_ids = sorted(
        {
            int(k[len(p + "axial_attn.layers.blocks."):].split(".")[0])
            for k in sd
            if k.startswith(p + "axial_attn.layers.blocks.")
        }
    )
    depth = (max(block_ids) + 1) // 2 if block_ids else 0
    layers = []
    for i in range(depth):
        attn_blk = f"{p}axial_attn.layers.blocks.{2 * i}"
        conv_blk = f"{p}axial_attn.layers.blocks.{2 * i + 1}"
        layers.append(
            {
                # f = attention along the segment axis, g = along the frame axis
                # (calculate_permutations order for channels-first input)
                "attn_n": _axial_attn_params(sd, attn_blk + ".f.net.fn"),
                "attn_l": _axial_attn_params(sd, attn_blk + ".g.net.fn"),
                "ff1": _conv_ff_params(sd, conv_blk + ".f.net"),
                "ff2": _conv_ff_params(sd, conv_blk + ".g.net"),
            }
        )
    # (1, d, n, 1) / (1, d, 1, l) broadcast params -> (n, d) / (l, d)
    pos_n = sd[p + "axial_attn.pos_emb.param_0"][0, :, :, 0].T
    pos_l = sd[p + "axial_attn.pos_emb.param_1"][0, :, 0, :].T
    return {
        "projection": {
            "w": _t(sd[p + "projection.weight"].T),
            "b": _t(sd[p + "projection.bias"]),
        },
        "pos_n": _t(pos_n),
        "pos_l": _t(pos_l),
        "layers": layers,
        "head": {
            "ln": {
                "scale": _t(sd[p + "classifier.layer_norm.weight"]),
                "bias": _t(sd[p + "classifier.layer_norm.bias"]),
            },
            "w": _t(sd[p + "classifier.linear.weight"].T),
            "b": _t(sd[p + "classifier.linear.bias"]),
        },
    }


# ---------------------------------------------------------------------------
# Full checkpoint
# ---------------------------------------------------------------------------


def convert_lightning_checkpoint(
    path_or_sd: str | Path | Dict[str, np.ndarray],
) -> Tuple[Params, Params, BNState]:
    """Lightning .ckpt -> (frozen, trainable, bn_state), fp32 tensors on the CPU.

    ``frozen["clip"]`` carries the checkpoint's own CLIP weights (bit-identical to
    OpenAI's for released checkpoints, since the reference freezes them).
    """
    sd = (
        path_or_sd
        if isinstance(path_or_sd, dict)
        else load_lightning_state_dict(path_or_sd)
    )
    clip_sd = clip_state_dict_from_lightning(sd)
    clip_params, _ = torch_state_dict_to_params(clip_sd)
    frozen = {"clip": clip_params}
    trainable = {
        "prompt_ctx": _t(sd["prompt_learner.ctx"]),
        "text_projection": _t(sd["text_encoder.text_projection"]),
        "temporal": temporal_params_from_torch(sd),
    }
    bn_state = BNState(
        mean=_t(sd["selector_model.bn_layer.running_mean"]),
        var=_t(sd["selector_model.bn_layer.running_var"]),
    )
    return frozen, trainable, bn_state


def converted_clip_config(path_or_sd):
    """CLIPConfig inferred from the checkpoint's own CLIP shapes."""
    sd = (
        path_or_sd
        if isinstance(path_or_sd, dict)
        else load_lightning_state_dict(path_or_sd)
    )
    return config_from_state_dict(clip_state_dict_from_lightning(sd))


def _c(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().cpu().contiguous().clone()


def temporal_state_dict(temporal: Params, prefix: str = "temporal_model.") -> Dict[str, torch.Tensor]:
    """The inverse of ``temporal_params_from_torch``: the port's temporal tree
    -> the lucidrains package's keys under ``prefix``."""
    p, sd = prefix, {}

    def attn(key: str, a: Params) -> None:
        sd[key + ".norm.weight"], sd[key + ".norm.bias"] = _c(a["ln"]["scale"]), _c(a["ln"]["bias"])
        sd[key + ".fn.to_q.weight"], sd[key + ".fn.to_kv.weight"] = _c(a["to_q"].T), _c(a["to_kv"].T)
        sd[key + ".fn.to_out.weight"], sd[key + ".fn.to_out.bias"] = _c(a["to_out_w"].T), _c(a["to_out_b"])

    def conv_ff(key: str, f: Params) -> None:
        sd[key + ".0.g"], sd[key + ".0.b"] = _c(f["ln_g"].reshape(1, -1, 1, 1)), _c(f["ln_b"].reshape(1, -1, 1, 1))
        sd[key + ".1.weight"], sd[key + ".1.bias"] = _c(f["conv1_w"]), _c(f["conv1_b"])
        sd[key + ".3.weight"], sd[key + ".3.bias"] = _c(f["conv2_w"]), _c(f["conv2_b"])

    sd[p + "projection.weight"], sd[p + "projection.bias"] = (_c(temporal["projection"]["w"].T),
                                                              _c(temporal["projection"]["b"]))
    sd[p + "axial_attn.pos_emb.param_0"] = _c(temporal["pos_n"].T[None, :, :, None])
    sd[p + "axial_attn.pos_emb.param_1"] = _c(temporal["pos_l"].T[None, :, None, :])
    for i, layer in enumerate(temporal["layers"]):
        blocks = f"{p}axial_attn.layers.blocks."
        attn(f"{blocks}{2 * i}.f.net.fn", layer["attn_n"])
        attn(f"{blocks}{2 * i}.g.net.fn", layer["attn_l"])
        conv_ff(f"{blocks}{2 * i + 1}.f.net", layer["ff1"])
        conv_ff(f"{blocks}{2 * i + 1}.g.net", layer["ff2"])
    head = temporal["head"]
    sd[p + "classifier.layer_norm.weight"] = _c(head["ln"]["scale"])
    sd[p + "classifier.layer_norm.bias"] = _c(head["ln"]["bias"])
    sd[p + "classifier.linear.weight"], sd[p + "classifier.linear.bias"] = _c(head["w"].T), _c(head["b"])
    return sd


def lightning_state_dict(frozen: Params, trainable: Params, bn_state: BNState) -> Dict[str, torch.Tensor]:
    """The inverse of ``convert_lightning_checkpoint``: the port's trees -> a
    reference Lightning ``state_dict`` holding the ``net.`` keys the
    conversion reads, fp32 tensors on the CPU. A reference checkpoint holds
    one text projection, which both trees read: it is the trainable one."""
    sd = {}
    for k, v in state_dict_from_params(frozen["clip"]).items():
        if k.startswith("visual."):
            sd["image_encoder." + k[len("visual."):]] = v
        elif k.startswith(("transformer.", "ln_final.")) or k == "positional_embedding":
            sd["text_encoder." + k] = v
        elif k == "token_embedding.weight":
            sd[k] = v
        elif k == "logit_scale":
            sd["selector_model.logit_scale"] = v
    sd["text_encoder.text_projection"] = _c(trainable["text_projection"])
    sd["prompt_learner.ctx"] = _c(trainable["prompt_ctx"])
    sd["selector_model.bn_layer.running_mean"] = _c(bn_state.mean)
    sd["selector_model.bn_layer.running_var"] = _c(bn_state.var)
    sd.update(temporal_state_dict(trainable["temporal"]))
    return {"net." + k: v for k, v in sd.items()}


def main(argv=None) -> None:
    """CLI: convert a Lightning .ckpt, or an Orbax checkpoint directory of the
    JAX package, into a checkpoint directory of the port usable as
    ``eval_entry ckpt_path=<out_dir>`` (and, from an Orbax fit, as a resume
    point; eval_entry also reads both inputs directly)."""
    import argparse

    from anomalyclip_tpu_torch.convert import tree_leaves
    from anomalyclip_tpu_torch.train.checkpoint import restore_state, write_state

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("ckpt", help="reference Lightning .ckpt file, or an Orbax checkpoint directory")
    ap.add_argument("out_dir", help="output checkpoint directory")
    args = ap.parse_args(argv)

    if Path(args.ckpt).is_dir():
        state = restore_state(args.ckpt)
    else:
        _, trainable, bn_state = convert_lightning_checkpoint(args.ckpt)
        state = {"trainable": trainable, "optimizer": None, "count": 0, "bn_state": bn_state,
                 "step": 0, "epoch": -1}
    write_state(Path(args.out_dir), state)
    n_params = sum(t.numel() for t in tree_leaves(state["trainable"]))
    print(f"converted {args.ckpt} -> {args.out_dir} ({n_params:,} trainable params)")


if __name__ == "__main__":
    main()
