"""Probe the whole-row kernel behind K6 under other tilings.

    python -m anomalyclip_tpu_torch.scripts.probe_qtile_vmem [rows,warps ...] [--iters N]
        [--device cpu]

The counterpart of the JAX package's scripts/probe_qtile_vmem.py, which
relaunches ``_mha_qtile_kernel`` at batch groups ``gb`` x q-tile lengths ``lq``
under a raised VMEM cap at the ViT-L/14@336px per-layer shape (32, 577, 1024),
16 heads, bf16. On the card the whole-row CUDA-core kernel behind
``fused_mha_qtile`` (ops/csrc/mha.cu: fp32 and head dim 16 today; bf16 at head
dim 64 went on to the tensor-core kernel of mha_tc.cu) runs 64 query rows and
8 warps a block, K and V of the head resident as bf16; 577 is prime, so its
tenth q tile holds one row and still stages the whole head. The probe
(``probe_mha_qtile``) sweeps ``lq`` as the rows per block (73 and 145 cut 577
into 8 and 4 nearly even tiles) and ``gb`` as the warps per block. Each line
gives the bytes per block, the blocks one SM holds, the median time and
max|diff| against the plain version (printed, not asserted); a configuration
whose shared memory does not fit is reported with its sizes, any other failure
ends the script. ``--device cpu`` runs the plain version at batch 2.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from anomalyclip_tpu_torch.ops import attention as A
from anomalyclip_tpu_torch.ops import attention_probes as P
from anomalyclip_tpu_torch.scripts._bench_util import announce_device, median_ms

B, L, D, H = 32, 577, 1024, 16
DEFAULT_CONFIGS = [(rows, warps) for warps in P.PROBE_WARPS for rows in (64, 73, 128, 145)]


def inputs(b: int, l: int, device, dtype=torch.bfloat16) -> tuple:
    """The JAX script's seeded q (b, l, D) and kv (b, l, 2D)."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy((rng.standard_normal((b, l, D)) * 0.02).astype(np.float32))
    kv = torch.from_numpy((rng.standard_normal((b, l, 2 * D)) * 0.02).astype(np.float32))
    return q.to(device=device, dtype=dtype), kv.to(device=device, dtype=dtype)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("configs", nargs="*", help="rows,warps; default: a sweep")
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: the plain version at batch 2, no times")
    args = ap.parse_args(argv)
    on_card = announce_device("probe_qtile_vmem", args.device, "the plain version at batch 2; no times")
    q, kv = inputs(B if on_card else 2, L, args.device)
    want = A.mha_qtile_reference(q, kv, H).float()
    print(f"shape B={q.shape[0]} L={L} D={D} H={H} bf16; mha.cu's own: rows=64 warps=8", flush=True)
    configs = [tuple(int(x) for x in c.split(",")) for c in args.configs] or DEFAULT_CONFIGS
    for rows, warps in configs:
        tag = f"rows={rows} warps={warps}"
        try:
            got = P.probe_mha_qtile(q, kv, H, rows=rows, warps=warps)
        except P.ProbeDoesNotFit as exc:
            print(f"{tag}: does not fit (needs {exc.need} B, given {exc.have} B)", flush=True)
            continue
        err = (got.float() - want).abs().max().item()
        line = f"{tag}: {A.mha_smem_bytes(L, P.PROBE_HEAD_DIM, q.element_size(), warps)} B/block"
        if on_card:
            ms = median_ms(lambda: P.probe_mha_qtile(q, kv, H, rows=rows, warps=warps), args.iters)
            line += f", {P.probe_blocks_per_sm(q.dtype, L, warps, False)} blocks/SM, {ms:.3f} ms/layer"
        print(f"{line}  max|diff|={err:.2e}", flush=True)


if __name__ == "__main__":
    main()
