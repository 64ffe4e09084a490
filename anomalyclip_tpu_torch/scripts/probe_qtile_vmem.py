"""Probe the kernel behind K6 under other q tiles, groupings and residencies.

    python -m anomalyclip_tpu_torch.scripts.probe_qtile_vmem [rows,warps[,streamed|resident] ...]
        [--iters N] [--device cpu]

The counterpart of the JAX package's scripts/probe_qtile_vmem.py, which
relaunches ``_mha_qtile_kernel`` at batch groups ``gb`` x q-tile lengths ``lq``
under a raised VMEM cap at the ViT-L/14@336px per-layer shape (32, 577, 1024),
16 heads, bf16. On the card ``fused_mha_qtile`` launches the tensor-core kernel
of ops/csrc/mha_tc.cu: 64 query rows and 4 warps a block, K and V streamed in
64-key blocks. The probe (``probe_mha_qtile``, ops/csrc/mha_probe.cu) runs its
arithmetic with ``lq`` as the rows per block (73 and 145 cut 577 into 8 and 4
nearly even tiles), ``gb`` as the warps per block (each holding a 16-row tile
at a time), and K and V of the head streamed or resident (staged once a block,
as the TPU keeps them in VMEM). Each line gives the bytes per block, the
blocks one SM holds, the median time (CUDA events), the device time
(``_bench_util.device_ms``) and its ratio to the shipped kernel's at the same
shape (timed first), and max|diff| against the probe's plain version
(printed, not asserted); a configuration whose shared memory does not fit is
reported with its sizes, any other failure ends the script. ``--device cpu``
runs the plain version at batch 2.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from anomalyclip_tpu_torch.ops import attention as A
from anomalyclip_tpu_torch.ops import attention_probes as P
from anomalyclip_tpu_torch.scripts._bench_util import announce_device, both_clocks, format_ms, versus

B, L, D, H = 32, 577, 1024, 16
DEFAULT_CONFIGS = [(rows, warps, residency) for residency in P.RESIDENCIES for warps in P.PROBE_WARPS
                   for rows in (64, 73, 128, 145)]


def inputs(b: int, l: int, device, dtype=torch.bfloat16) -> tuple:
    """The JAX script's seeded q (b, l, D) and kv (b, l, 2D)."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy((rng.standard_normal((b, l, D)) * 0.02).astype(np.float32))
    kv = torch.from_numpy((rng.standard_normal((b, l, 2 * D)) * 0.02).astype(np.float32))
    return q.to(device=device, dtype=dtype), kv.to(device=device, dtype=dtype)


def parse_config(text: str) -> tuple:
    parts = text.split(",")
    if len(parts) not in (2, 3) or (len(parts) == 3 and parts[2] not in P.RESIDENCIES):
        raise SystemExit(f"probe_qtile_vmem: configuration {text!r} is not rows,warps[,streamed|resident]")
    return int(parts[0]), int(parts[1]), parts[2] if len(parts) == 3 else P.SHIPPED["residency"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("configs", nargs="*", help="rows,warps[,streamed|resident]; default: a sweep")
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: the plain version at batch 2, no times")
    args = ap.parse_args(argv)
    on_card = announce_device("probe_qtile_vmem", args.device, "the plain version at batch 2; no times")
    q, kv = inputs(B if on_card else 2, L, args.device)
    want = P.tile_reference(q, kv[..., :D], kv[..., D:], H).float()
    print(f"shape B={q.shape[0]} L={L} D={D} H={H} bf16; mha_tc.cu's own: rows=64 warps=4 streamed",
          flush=True)
    shipped_ms = None
    if on_card:
        event_ms, shipped_ms = both_clocks(lambda: A.fused_mha_qtile(q, kv, H), args.iters)
        print(f"shipped (fused_mha_qtile): {event_ms:.3f} ms/layer, device {format_ms(shipped_ms)}", flush=True)
    for rows, warps, residency in [parse_config(c) for c in args.configs] or DEFAULT_CONFIGS:
        tag = f"rows={rows} warps={warps} {residency}"
        try:
            got = P.probe_mha_qtile(q, kv, H, rows=rows, warps=warps, residency=residency)
        except P.ProbeDoesNotFit as exc:
            print(f"{tag}: does not fit (needs {exc.need} B, given {exc.have} B)", flush=True)
            continue
        err = (got.float() - want).abs().max().item()
        line = f"{tag}: {P.tile_smem_bytes(L, P.PROBE_HEAD_DIM, q.element_size(), warps, residency)} B/block"
        if on_card:
            event_ms, ms = both_clocks(
                lambda: P.probe_mha_qtile(q, kv, H, rows=rows, warps=warps, residency=residency), args.iters)
            line += (f", {P.probe_blocks_per_sm(q.dtype, L, warps, residency)} blocks/SM, {event_ms:.3f} "
                     f"ms/layer, device {format_ms(ms)}, {versus(ms, shipped_ms)} the shipped")
        print(f"{line}  max|diff|={err:.2e}", flush=True)


if __name__ == "__main__":
    main()
