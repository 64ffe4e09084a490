"""Validate ``fused_mha_qkv`` (K1) on the card at every production CLIP shape.

    python -m anomalyclip_tpu_torch.scripts.validate_pickgb [TAG-SUBSTRING ...] [--iters N]
        [--device cpu]

The counterpart of the JAX package's scripts/validate_pickgb.py: each shape
goes through the *production* entry, is held within 5e-2 (absolute, bf16) of
the plain version and timed (CUDA events). The TPU script's envelope row, the
longest L its whole-block kernel compiles, becomes the card's: the longest L
whose K and V fit a block as fp32 at head dim 64 (``mha_smem_bytes(L, 64)``
within the card's shared memory: L=420 on an H100), which must take the "mha"
rung, and L+1, which must take the next rung ("qtile" in bf16) and which
``fused_mha_qkv`` itself must refuse with the sizes; that row is validated
through ``fused_mha_qtile`` on the same packed projection. Exits 1 on a
failure. ``--device cpu`` runs the plain versions at batch 2, no times.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from anomalyclip_tpu_torch.models.clip.model import attention_rung
from anomalyclip_tpu_torch.ops import attention as A
from anomalyclip_tpu_torch.scripts._bench_util import announce_device, median_ms

PARITY_LIMIT = 5e-2  # absolute, bf16
HEAD_DIM = 64

# (B, L, D, H, causal, tag)
SHAPES = [
    (256, 197, 768, 12, False, "ViT-B/16 vision"),
    (64, 257, 1024, 16, False, "ViT-L/14 vision"),
    (512, 50, 768, 12, False, "ViT-B/32 vision"),
    (256, 77, 512, 8, True, "text tower, causal"),
]


def longest_mha_length(smem: int) -> int:
    """The longest L the "mha" rung takes at head dim 64 in ``smem`` bytes."""
    l = 1
    while A.mha_smem_bytes(l + 1, HEAD_DIM) <= smem:
        l += 1
    return l


def envelope_shapes(smem: int) -> list:
    top = longest_mha_length(smem)
    return [(32, top, 1024, 16, False, f"envelope: the mha rung's longest L ({top})"),
            (32, top + 1, 1024, 16, False, f"envelope: past it (L={top + 1}), the next rung")]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("only", nargs="*", help="substrings of the shape tags to run")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: the plain versions at batch 2, no times")
    args = ap.parse_args(argv)
    on_card = announce_device("validate_pickgb", args.device, "plain versions at batch 2; no times")
    smem = A.smem_limit(torch.device(args.device))
    ok = True
    for b, l, d, h, causal, tag in SHAPES + envelope_shapes(smem):
        if args.only and not any(s in tag for s in args.only):
            continue
        b = b if on_card else 2
        rung = attention_rung(b, l, d, h, 2, causal, smem)
        rng = np.random.default_rng(0)
        qkv = torch.from_numpy((rng.standard_normal((b, l, 3 * d)) * 0.02).astype(np.float32))
        qkv = qkv.to(device=args.device, dtype=torch.bfloat16)
        if rung == "mha":
            fn = lambda: A.fused_mha_qkv(qkv, h, causal)  # noqa: E731
        elif rung == "qtile":
            # K1 refuses the shape, with the sizes, before anything is launched
            if on_card:
                try:
                    A.fused_mha_qkv(qkv, h, causal)
                except ValueError as exc:
                    print(f"{tag}: fused_mha_qkv refuses: {exc}")
                else:
                    raise AssertionError(f"{tag}: fused_mha_qkv took a shape past its shared memory")
            fn = lambda: A.fused_mha_qtile(qkv[..., :d], qkv[..., d:], h)  # noqa: E731
        else:
            raise AssertionError(f"{tag}: rung {rung!r}, expected mha or qtile")
        got = fn().float()
        err = (got - A.mha_qkv_reference(qkv, h, causal).float()).abs().max().item()
        good = err < PARITY_LIMIT
        ok &= good
        timing = f"{median_ms(fn, args.iters):.3f} ms/layer  " if on_card else ""
        print(f"{tag} (B={b}, L={l}, D={d}, H={h}): rung {rung}, "
              f"{A.mha_smem_bytes(l, HEAD_DIM, 4 if rung == 'mha' else 2)} B/block  {timing}"
              f"max|diff|={err:.5f}  {'OK' if good else 'FAIL'}", flush=True)
    print("ALL OK" if ok else "FAILURES ABOVE")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
