"""Where the bf16 gap between the kernel path and the plain-attention path of an
image tower comes from, layer by layer.

    python -m anomalyclip_tpu_torch.scripts.probe_bf16_drift [--arch l14@336|b16]
        [--frames N] [--seeds K] [--device cpu]

The chip smoke run holds a bf16 scoring pass under the kernels against the same
pass under the plain attention, end to end. This script takes the image tower
of such a pass apart. For each seed (weights and uint8 frames are seeded) it
runs the tower in bf16 under four forms of the attention, which differ in
nothing but where fp32 sums are ordered and bf16 roundings fall:

  kernel      the CUDA kernels (in bf16 at head dim 64: ops/csrc/mha_tc.cu);
  blocked     the kernels' plain version: online softmax over blocks of 64 keys;
  blocked128  the same plain version at 128 keys a block;
  whole       the whole-row plain version;

and once in fp32 under the whole-row plain version. It prints, per layer, the
largest difference of the residual stream from the ``blocked`` run's, and for
the kernel also the local gap: one block applied to the ``blocked`` run's own
input under the kernels against the same block under ``blocked``. The local gap
is what a kernel contributes in one layer; the difference of the streams is
what the layers after it make of every such contribution. Then, per seed, the
gap of the tower's output (the image embedding) between each form and
``blocked``, and of each form from the fp32 run.

Read it so: if the kernel's local gap stays at one or two bf16 steps of the
stream at every layer, and the two other plain forms, which contain no kernel,
drift from ``blocked`` as far as the kernel does, then the end-to-end gap is
the tower's amplification of rounding differences that any order of the sums
makes, and not a fault of the kernel or of its plain form.

``main`` returns what it printed as numbers, one entry a seed: per layer the
stream's max, the local gap, the bf16 step of the stream there and the streams'
gaps, then the embedding's gaps. ``local_gap_readings`` is the part of it the
chip smoke run asserts on: the kernel's local gap at every layer, in bf16 steps
of that layer's stream.

``--device cpu`` runs the plain forms on the tiny tower at 2 frames; the kernel
form is then the ``blocked`` one and its gaps are 0.
"""

from __future__ import annotations

import argparse
import contextlib
import math

import numpy as np
import torch

from anomalyclip_tpu_torch.models.clip import model as clip_model
from anomalyclip_tpu_torch.ops import attention as A
from anomalyclip_tpu_torch.scripts._bench_util import announce_device

ARCHS = {"l14@336": clip_model.CLIPConfig.vit_l14_336, "b16": clip_model.CLIPConfig.vit_b16}
# form -> (attention_impl, the plain version's KV block: None for whole rows)
FORMS = {"kernel": ("kernel", A.MHA_TC_BLOCK_KV), "blocked": ("reference", A.MHA_TC_BLOCK_KV),
         "blocked128": ("reference", 128), "whole": ("reference", None)}


@contextlib.contextmanager
def attention_form(form: str, dtype: torch.dtype):
    """Run the attention entries under ``form``. The plain version's block is
    the entries' own choice (``reference_block``) in bf16 at head dim 64, and is
    replaced here for the two other plain forms; in fp32 it is whole rows."""
    impl, block = FORMS[form]
    chosen = A.reference_block
    if impl == "reference" and dtype == torch.bfloat16:
        A.reference_block = lambda dtype, dh: block
    try:
        with A.attention_impl(impl):
            yield
    finally:
        A.reference_block = chosen


def tower_input(params, cfg, frames: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The residual stream before the first block, as ``encode_image`` makes it."""
    visual = params["visual"]
    x = clip_model.patchify(clip_model.normalize_frames_on_device(frames).to(dtype),
                            cfg.vision_patch_size)
    x = x @ visual["patch_embed"].to(dtype)
    cls = visual["class_embedding"].to(dtype).expand(x.shape[0], 1, cfg.vision_width)
    x = torch.cat([cls, x], dim=1) + visual["positional_embedding"].to(dtype)
    return clip_model.layer_norm(x, visual["ln_pre"]["scale"], visual["ln_pre"]["bias"])


def tower_output(params, x: torch.Tensor) -> torch.Tensor:
    visual = params["visual"]
    x = clip_model.layer_norm(x[:, 0, :], visual["ln_post"]["scale"], visual["ln_post"]["bias"])
    return x @ visual["proj"].to(x.dtype)


def run_tower(params, cfg, frames, dtype, form: str) -> tuple:
    """-> (the residual stream after each block, the image embedding)."""
    streams = []
    with torch.no_grad(), clip_model.matmul_precision_for(dtype), attention_form(form, dtype):
        x = tower_input(params, cfg, frames, dtype)
        for blk in params["visual"]["blocks"]:
            x = clip_model._block_apply(x, clip_model.cast_tree(blk, dtype), cfg.vision_heads, False)
            streams.append(x)
        return streams, tower_output(params, x)


def local_gaps(params, cfg, frames, streams: list) -> list:
    """Per layer: one block under the kernels against the same block under the
    ``blocked`` plain version, both applied to the ``blocked`` run's input."""
    dtype = torch.bfloat16
    gaps = []
    with torch.no_grad(), clip_model.matmul_precision_for(dtype):
        inputs = [tower_input(params, cfg, frames, dtype), *streams[:-1]]
        for blk, x, want in zip(params["visual"]["blocks"], inputs, streams):
            with attention_form("kernel", dtype):
                got = clip_model._block_apply(x, clip_model.cast_tree(blk, dtype), cfg.vision_heads, False)
            gaps.append(gap(got, want))
    return gaps


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def bf16_step(top: float) -> float:
    """The distance between neighbouring bf16 values at magnitude ``top``:
    2^(floor(log2 top) - 7)."""
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def local_gap_readings(params, cfg, frames, streams=None) -> list:
    """Per layer of the bf16 tower: the max of the ``blocked`` plain run's
    residual stream, the kernel's local gap there (``local_gaps``), one bf16 step
    of that stream, and the gap in such steps. ``streams``: that run's, where
    the caller has made it."""
    if streams is None:
        streams, _ = run_tower(params, cfg, frames, torch.bfloat16, "blocked")
    readings = []
    for layer, (x, local) in enumerate(zip(streams, local_gaps(params, cfg, frames, streams))):
        top = x.float().abs().max().item()
        step = bf16_step(top)
        readings.append({"layer": layer + 1, "stream_max": top, "local_gap": local, "step": step,
                         "local_steps": local / step if step else float("inf")})
    return readings


def seeded_tower(cfg, seed: int, n: int, device: str) -> tuple:
    """Seeded fp32 weights of the image tower and ``n`` seeded uint8 frames."""
    params = clip_model.init_clip_params(torch.Generator().manual_seed(seed), cfg)
    params = _to({"visual": clip_model.cast_tree(params["visual"], torch.float32)}, device)
    res = cfg.image_resolution
    frames = np.random.default_rng(seed).integers(0, 256, (n, res, res, 3), dtype=np.uint8)
    return params, torch.from_numpy(frames).to(device)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="l14@336", choices=sorted(ARCHS))
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: the plain forms on the tiny tower at 2 frames")
    args = ap.parse_args(argv)
    on_card = announce_device("probe_bf16_drift", args.device, "plain forms, tiny tower, 2 frames")
    cfg = ARCHS[args.arch]() if on_card else clip_model.CLIPConfig.tiny()
    n = args.frames if on_card else 2
    others = [f for f in FORMS if f != "blocked"]
    readings = []
    for seed in range(args.seeds):
        params, frames = seeded_tower(cfg, seed, n, args.device)
        streams, outs = {}, {}
        for form in FORMS:
            streams[form], outs[form] = run_tower(params, cfg, frames, torch.bfloat16, form)
        _, truth = run_tower(params, cfg, frames, torch.float32, "whole")
        layers = local_gap_readings(params, cfg, frames, streams["blocked"])
        print(f"seed {seed}: {args.arch if on_card else 'tiny'}, {n} frames, bf16; the residual "
              f"stream's max|x| and its max|diff| from the blocked plain run's, by layer", flush=True)
        print("layer  max|x|   kernel, local   " + "   ".join(f"{f:>10s}" for f in others), flush=True)
        for at, ref in zip(layers, streams["blocked"]):
            at["stream_gap"] = {f: gap(streams[f][at["layer"] - 1], ref) for f in others}
            row = "   ".join(f"{at['stream_gap'][f]:10.3e}" for f in others)
            print(f"{at['layer']:5d}  {at['stream_max']:7.2f}  {at['local_gap']:14.3e}   {row}",
                  flush=True)
        embedding = {"max": truth.abs().max().item(),
                     "from_blocked": {f: gap(outs[f], outs["blocked"]) for f in others},
                     "from_fp32": {f: gap(outs[f], truth) for f in FORMS}}
        print(f"seed {seed}: image embedding, max|x| {embedding['max']:.3f}: from blocked: "
              + ", ".join(f"{f} {g:.3e}" for f, g in embedding["from_blocked"].items())
              + "; from fp32: "
              + ", ".join(f"{f} {g:.3e}" for f, g in embedding["from_fp32"].items()), flush=True)
        readings.append({"seed": seed, "frames": n, "layers": layers, "embedding": embedding})
        del streams, outs, truth, params, frames
        if on_card:
            torch.cuda.empty_cache()
    return readings


def _to(tree, device: str):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


if __name__ == "__main__":
    main()
