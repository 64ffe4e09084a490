"""ViT-B/16 image encoding on the card: attention implementation x batch size.

    python -m anomalyclip_tpu_torch.scripts.perf_sweep [--impls reference,kernel]
        [--batches 256,512,1024] [--iters 10] [--device cpu]

The counterpart of the JAX package's scripts/perf_sweep.py: ``encode_image`` of
the ViT-B/16 tower (seeded weights cast to bf16, bf16 compute) over (B, 224,
224, 3) random frames, for each implementation of the attention
(``ops/attention.py``, ``attention_impl``) and batch. "kernel" launches K1
(``fused_mha_qkv``) at (B, 197, 2304) with 12 heads, which in bf16 at head dim
64 takes the tensor-core kernel of ``mha_tc.cu``; "reference" runs the plain
attention. Each line gives ms/iter (the median of ``--iters`` calls by CUDA
events, after a warm one) and frames/s.

Where more than one implementation ran, the encodings of the first batch are
held against the first implementation's, within ``AGREE_TOL`` of its largest
magnitude. A combination that raises is printed with its error, the others
still run, and the script exits 1, as it does when the encodings disagree.
``--device cpu`` runs the tiny tower at batch 2 for each implementation and
prints no times.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from anomalyclip_tpu_torch.convert import tree_to
from anomalyclip_tpu_torch.models.clip.model import CLIPConfig, cast_tree, encode_image, init_clip_params
from anomalyclip_tpu_torch.ops.attention import attention_impl
from anomalyclip_tpu_torch.scripts._bench_util import announce_device, median_ms

# bf16 encodings of two attention implementations, of the first's max |value|:
# they round alike and differ in the order of their sums over twelve layers
AGREE_TOL = 5e-2


def sweep(impls, batches, iters: int, device: str, on_card: bool) -> tuple:
    """Every (impl, batch) -> ({(impl, batch): (ms, frames/s) or None off the
    card}, {impl: encoding of the first batch}, [failures as text])."""
    cfg = CLIPConfig.vit_b16() if on_card else CLIPConfig.tiny()
    params = tree_to(cast_tree(init_clip_params(torch.Generator().manual_seed(0), cfg), torch.bfloat16), device)
    side = cfg.image_resolution
    times, first, failed = {}, {}, []
    for impl in impls:
        for batch in batches:
            try:  # the same frames for every impl at a batch
                frames = np.random.default_rng(batch).standard_normal((batch, side, side, 3), dtype=np.float32)
                frames = torch.from_numpy(frames)
                frames = frames.to(device=device, dtype=torch.bfloat16)

                def encode():
                    with torch.no_grad(), attention_impl(impl):
                        return encode_image(params, cfg, frames, compute_dtype=torch.bfloat16)

                out = encode()
                if not bool(torch.isfinite(out).all()):
                    raise FloatingPointError(f"non-finite features {tuple(out.shape)}")
                first.setdefault(impl, out.float().cpu())
                if on_card:
                    ms = median_ms(encode, iters)
                    times[(impl, batch)] = (ms, batch / ms * 1e3)
                    print(f"impl={impl:9s} batch={batch:5d}  {ms:8.2f} ms/iter  {batch / ms * 1e3:10,.0f} fps",
                          flush=True)
                else:
                    times[(impl, batch)] = None
                    print(f"impl={impl:9s} batch={batch:5d}  encoded {tuple(out.shape)}, finite", flush=True)
            except Exception as exc:  # noqa: BLE001 - reported, the sweep goes on, and the exit is 1
                failed.append(f"impl={impl} batch={batch}: {type(exc).__name__}: {exc}")
                print(f"impl={impl:9s} batch={batch:5d}  FAILED: {type(exc).__name__}: {exc}", flush=True)
            if on_card:
                torch.cuda.empty_cache()
    return times, first, failed


def agreement(first: dict) -> dict:
    """{impl: max |encoding - the first impl's| / max |the first impl's|} for
    every impl after the first."""
    names = list(first)
    ref = first[names[0]]
    scale = float(ref.abs().max())
    return {name: float((first[name] - ref).abs().max()) / scale for name in names[1:]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--impls", default="reference,kernel")
    ap.add_argument("--batches", default="256,512,1024")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: the tiny tower at batch 2 for each implementation, no times")
    args = ap.parse_args(argv)
    on_card = announce_device("perf_sweep", args.device, "the tiny tower at batch 2; no times")
    impls = args.impls.split(",")
    batches = [int(b) for b in args.batches.split(",")] if on_card else [2]
    times, first, failed = sweep(impls, batches, args.iters, args.device, on_card)
    gaps = agreement(first) if len(first) > 1 else {}
    for name, gap in gaps.items():
        verdict = "agree" if gap <= AGREE_TOL else "DISAGREE"
        print(f"impl={name} vs impl={next(iter(first))} at batch {batches[0]}: max|diff| {gap:.3e} of max|ref| "
              f"({verdict}, limit {AGREE_TOL})", flush=True)
        if gap > AGREE_TOL:
            failed.append(f"impl={name} disagrees with impl={next(iter(first))}: {gap:.3e}")
    if failed:
        print(f"perf_sweep: {len(failed)} failure(s)", file=sys.stderr, flush=True)
        raise SystemExit(1)
    return {"times": times, "gaps": gaps}


if __name__ == "__main__":
    main()
