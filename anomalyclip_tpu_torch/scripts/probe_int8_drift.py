"""Where the int8 tower's kernel run and its plain-attention run part, layer by
layer.

    python -m anomalyclip_tpu_torch.scripts.probe_int8_drift [--arch b16|l14@336]
        [--frames N] [--dtype fp32|bf16] [--device cpu]

For seeded weights and uint8 frames the script runs the int8 tower
(models/clip/quant.py) under the CUDA kernels and under the plain attention,
and prints per layer:

  local     the attention under the kernels against the plain version on the
            kernel run's own qkv: what a kernel contributes in one layer;
  flipped   the share of the int8 codes of each of the layer's four GEMM
            inputs (qkv, out, fc, proj) that differ between the two runs.

Then, for the features: the kernel run against the plain run; the plain run
against itself on an input nudged by one fp32 ulp (the normalized frames times
1 + 2^-23; in bf16 the nudge rounds away); and the int8 tower against the fp
tower (under the kernels).

Read it so: if the local gap stays at the kernels' limits while the flipped
share grows layer by layer, and the kernel run parts from the plain run as far
as the nudge moves the plain run, then per-token rounding to int8 turns any
ulp into a quantization step, and the end-to-end gap is the int8 tower's own
rounding noise, not a kernel's fault.

``main`` returns the readings: per layer the local gap and the flipped shares,
then the features' gaps and cosines. ``--device cpu`` runs the tiny tower at 2
frames; the kernel form is then the plain one and its gaps are 0.
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch

from anomalyclip_tpu_torch.convert import tree_to
from anomalyclip_tpu_torch.models.clip import model as clip_model
from anomalyclip_tpu_torch.models.clip import quant
from anomalyclip_tpu_torch.ops.attention import attention_impl
from anomalyclip_tpu_torch.scripts._bench_util import announce_device

ARCHS = {"b16": clip_model.CLIPConfig.vit_b16, "l14@336": clip_model.CLIPConfig.vit_l14_336}
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
GEMMS = ("qkv", "out", "fc", "proj")


@contextlib.contextmanager
def recorded_layers(layers: list):
    """The int8 tower with each block's GEMM inputs (their int8 codes) and its
    qkv and attention output appended to ``layers``, one dict a block."""
    real_linear, real_attention = quant.int8_linear, quant.attention_from_qkv

    def linear(x, qlin, bias=None, gelu=False):
        for name in GEMMS:
            if qlin is getattr(linear, "block", {}).get(name):
                layers[-1]["codes"][name] = quant.quantize_rows(x)[0]
        return real_linear(x, qlin, bias, gelu)

    def attention(qkv, num_heads, causal=False):
        out = real_attention(qkv, num_heads, causal)
        layers[-1].update(qkv=qkv, attn=out)
        return out

    real_block = quant._block_apply_q

    def block(x, blk, num_heads):
        linear.block = {"qkv": blk["attn"]["qkv"], "out": blk["attn"]["out"],
                        "fc": blk["mlp"]["fc"], "proj": blk["mlp"]["proj"]}
        layers.append({"codes": {}})
        return real_block(x, blk, num_heads)

    quant.int8_linear, quant.attention_from_qkv, quant._block_apply_q = linear, attention, block
    try:
        yield
    finally:
        quant.int8_linear, quant.attention_from_qkv, quant._block_apply_q = real_linear, real_attention, real_block


def run_int8(qvisual, cfg, images: torch.Tensor, dtype: torch.dtype, impl: str) -> tuple:
    """The int8 tower on normalized ``images`` under ``impl`` -> (features, layers)."""
    layers = []
    with recorded_layers(layers), attention_impl(impl):
        feats = quant.encode_image_int8(qvisual, cfg, images, dtype)
    return feats, layers


def local_gaps(layers: list, num_heads: int) -> list:
    """Per layer of a recorded run: its attention output against the plain
    version on the same qkv, max|diff|."""
    gaps = []
    for layer in layers:
        with attention_impl("reference"):
            plain = quant.attention_from_qkv(layer["qkv"], num_heads)
        gaps.append((layer["attn"].float() - plain.float()).abs().max().item())
    return gaps


def gap(a: torch.Tensor, b: torch.Tensor) -> dict:
    a, b = a.double(), b.double()
    cos = ((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min().item()
    return {"max": (a - b).abs().max().item(), "relative": ((a - b).norm() / b.norm()).item(), "cosine": cos}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="b16", choices=sorted(ARCHS))
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--dtype", default="fp32", choices=sorted(DTYPES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: the plain form on the tiny tower at 2 frames")
    args = ap.parse_args(argv)
    on_card = announce_device("probe_int8_drift", args.device, "plain form, tiny tower, 2 frames")
    cfg = ARCHS[args.arch]() if on_card else clip_model.CLIPConfig.tiny()
    n, dtype = (args.frames if on_card else 2), DTYPES[args.dtype]
    params = clip_model.init_clip_params(torch.Generator().manual_seed(args.seed), cfg)
    params = tree_to({"visual": params["visual"]}, args.device)
    qvisual = quant.quantize_clip_visual(params)
    res = cfg.image_resolution
    frames = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, 256, (n, res, res, 3), dtype=np.uint8)).to(args.device)
    images = clip_model.normalize_frames_on_device(frames)

    kernel, kernel_layers = run_int8(qvisual, cfg, images, dtype, "kernel")
    plain, plain_layers = run_int8(qvisual, cfg, images, dtype, "reference")
    nudged, _ = run_int8(qvisual, cfg, images * (1 + 2.0**-23), dtype, "reference")
    with torch.no_grad():
        fp = clip_model.encode_image(params, cfg, images, dtype)
    print(f"{args.arch if on_card else 'tiny'}, {n} frames, {args.dtype}: by layer, the attention's local gap "
          f"(kernel vs plain on the kernel run's qkv) and the share of int8 codes that differ between the kernel "
          f"run and the plain run at each GEMM's input ({', '.join(GEMMS)})", flush=True)
    layers = []
    locals_ = local_gaps(kernel_layers, cfg.vision_heads)
    for i, (k, p, local) in enumerate(zip(kernel_layers, plain_layers, locals_), start=1):
        flipped = {g: (k["codes"][g] != p["codes"][g]).float().mean().item() for g in GEMMS}
        layers.append({"layer": i, "local_gap": local, "flipped": flipped})
        print(f"{i:5d}  {local:10.3e}   " + "  ".join(f"{flipped[g]:8.4%}" for g in GEMMS), flush=True)
    features = {"kernel_vs_plain": gap(kernel, plain), "nudged_vs_plain": gap(nudged, plain),
                "int8_vs_fp": gap(kernel, fp)}
    for name, g in features.items():
        print(f"features, {name.replace('_', ' ')}: max|diff| {g['max']:.3e}, relative {g['relative']:.3e}, "
              f"min cosine {g['cosine']:.6f}", flush=True)
    return {"arch": args.arch if on_card else "tiny", "frames": n, "dtype": args.dtype, "layers": layers,
            "features": features}


if __name__ == "__main__":
    main()
