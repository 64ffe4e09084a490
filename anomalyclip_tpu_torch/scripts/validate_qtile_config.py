"""Validate the kernel each long bf16 shape takes on the card, and time the
q-tiled kernel against the flash kernel.

    python -m anomalyclip_tpu_torch.scripts.validate_qtile_config [--iters N] [--device cpu]

The counterpart of the JAX package's scripts/validate_qtile_config.py, which
holds ``fused_mha_qtile`` against the plain formulation at four shapes and times
it against ``flash_attention_heads`` at (32, 1024, 1024). On the card K6 keeps K
and V of a head resident as bf16, which fits to L=789 at head dim 64 (292 L +
2,048 B within 232,448 B), so L=1024 and L=1536 are not its shapes: the script
reports the rung ``attention_rung`` picks for each shape and validates that
kernel ("qtile": ``fused_mha_qtile``; "core": ``fused_attention``, which routes
on to the flash kernel) within 5e-2 (absolute) of its plain version. At head
dim 64 both entries launch the tensor-core kernel of ops/csrc/mha_tc.cu, each
through its own entry. The qtile-against-flash time is taken at the longest L
both take. Exits 1 on a
failure. ``--device cpu`` runs the plain versions at batch 1, no times.
"""

from __future__ import annotations

import argparse
import sys

import torch

from anomalyclip_tpu_torch.models.clip.model import attention_rung
from anomalyclip_tpu_torch.ops import attention as A
from anomalyclip_tpu_torch.scripts._bench_util import announce_device, median_ms

PARITY_LIMIT = 5e-2  # absolute, bf16
SHAPES = [(32, 577, 1024, 16), (32, 1024, 512, 8), (32, 1024, 1024, 16), (32, 1536, 1024, 16)]


def make_inputs(b, l, d, seed, device) -> tuple:
    gen = torch.Generator().manual_seed(seed)
    q = (torch.randn((b, l, d), generator=gen) * 0.02).to(device=device, dtype=torch.bfloat16)
    kv = (torch.randn((b, l, 2 * d), generator=gen) * 0.02).to(device=device, dtype=torch.bfloat16)
    return q, kv


def split_heads(q, kv, h) -> tuple:
    """q (B, L, D), kv (B, L, 2D) -> the (B, H, L, dh) views of q, k, v."""
    d = q.shape[-1]
    return tuple(t.unflatten(-1, (h, d // h)).transpose(1, 2) for t in (q, kv[..., :d], kv[..., d:]))


def check(b, l, d, h, device, smem) -> bool:
    q, kv = make_inputs(b, l, d, 0, device)
    rung = attention_rung(b, l, d, h, 2, False, smem)
    if rung == "qtile":
        got, want = A.fused_mha_qtile(q, kv, h), A.mha_qtile_reference(q, kv, h)
    elif rung == "core":
        heads = split_heads(q, kv, h)
        got, want = A.fused_attention(*heads), A.flash_attention_reference(
            *(t.reshape(b * h, l, d // h) for t in heads)).reshape(b, h, l, d // h)
    else:
        raise AssertionError(f"(B={b}, L={l}, D={d}, H={h}): rung {rung!r}, expected qtile or core")
    err = (got.float() - want.float()).abs().max().item()
    print(f"(B={b}, L={l}, D={d}, H={h}) rung {rung}: max|diff| vs plain = {err:.5f}  "
          f"{'OK' if err < PARITY_LIMIT else 'FAIL'}", flush=True)
    return err < PARITY_LIMIT


def longest_qtile_length(dh: int, smem: int) -> int:
    """The longest L whose K and V fit a block of K6 as bf16."""
    l = 1
    while A.mha_smem_bytes(l + 1, dh, 2) <= smem:
        l += 1
    return l


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: the plain versions at batch 1, no times")
    args = ap.parse_args(argv)
    on_card = announce_device("validate_qtile_config", args.device, "plain versions at batch 1; no times")
    smem = A.smem_limit(torch.device(args.device))
    ok = True
    for b, l, d, h in SHAPES:
        ok &= check(b if on_card else 1, l, d, h, args.device, smem)

    # qtile against flash at the longest L both take
    b, d, h = 32, 1024, 16
    l = longest_qtile_length(d // h, smem)
    print(f"the q-tiled kernel's longest L at head dim {d // h} in bf16: {l} "
          f"({A.mha_smem_bytes(l, d // h, 2)} B of {smem} B)")
    if on_card:
        q, kv = make_inputs(b, l, d, 1, args.device)
        qh, kh, vh = (t.reshape(b * h, l, d // h).contiguous() for t in split_heads(q, kv, h))
        t_q = median_ms(lambda: A.fused_mha_qtile(q, kv, h), args.iters)
        print(f"qtile  ({b},{l},{d}): {t_q:.3f} ms")
        t_f = median_ms(lambda: A.flash_attention_heads(qh, kh, vh), args.iters)
        print(f"flash  ({b},{l},{d}): {t_f:.3f} ms (excl. head-split copies)")
    print("ALL OK" if ok else "NUMERIC FAILURES ABOVE")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
