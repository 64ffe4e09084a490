"""Probe the kernel behind K1 under other tilings, residencies and shared-memory caps.

    python -m anomalyclip_tpu_torch.scripts.probe_qkv_gb [b16|l14|b32|text] [fp32|bf16]
        [rows,warps[,streamed|resident] ...] [--iters N] [--device cpu]

The counterpart of the JAX package's scripts/probe_qkv_gb.py, which relaunches
``_mha_qkv_kernel`` at other batch groups ``gb`` under the default and a raised
VMEM cap. On the card ``fused_mha_qkv`` launches at head dim 64 the
tensor-core kernels (ops/csrc/mha_tc.cu in bf16, the split-TF32 one of
mha_tf32.cu in fp32): 64 query rows and 4 warps a block, K and V streamed in
64-key blocks, shared memory independent of L. The probe (``probe_mha_qkv``,
ops/csrc/mha_probe.cu) runs the same arithmetic with those three free. What the
TPU's axes became: ``gb``, the rows a program holds at a time, is the warps per
block, each holding a 16-row tile at a time; the VMEM the TPU keeps K and V of
the head in is the ``resident`` form (staged once a block, shared memory growing
with L); the VMEM cap is the dynamic shared memory a block may ask for, 49,152 B
without the opt-in and the card's limit with it, and each configuration is
tried under the first and, where it does not fit, under the second. A
configuration that fits neither is reported with the bytes it needs and was
given; any other failure ends the script. Each line gives the bytes per block,
the blocks one SM holds, the median time (CUDA events), the device time
(``_bench_util.device_ms``) and its ratio to the shipped kernel's at the same
shape (timed first) and max|diff| against the probe's
plain version; the limit for that is printed, not asserted. ``--device cpu``
runs the plain version at batch 2 and prints no times.
"""

from __future__ import annotations

import argparse

import torch

from anomalyclip_tpu_torch.ops import attention as A
from anomalyclip_tpu_torch.ops import attention_probes as P
from anomalyclip_tpu_torch.scripts._bench_util import announce_device, both_clocks, format_ms, versus

# (B, L, D, heads, causal): the towers' per-layer shapes
SHAPES = {
    "b16": (256, 197, 768, 12, False),
    "l14": (64, 257, 1024, 16, False),
    "b32": (512, 50, 768, 12, False),
    "text": (256, 77, 512, 8, True),
}
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
PARITY_LIMIT = {"fp32": 1e-5, "bf16": 5e-2}  # absolute
# rows, warps, residency: the first is K1's shipped block
DEFAULT_CONFIGS = [(64, 4, "streamed")] + [
    (rows, warps, "streamed") for rows in (32, 64, 128) for warps in P.PROBE_WARPS if (rows, warps) != (64, 4)
] + [(64, 4, "resident"), (128, 8, "resident")]


def parse_config(text: str) -> tuple:
    parts = text.split(",")
    if len(parts) not in (2, 3) or (len(parts) == 3 and parts[2] not in P.RESIDENCIES):
        raise SystemExit(f"probe_qkv_gb: configuration {text!r} is not rows,warps[,streamed|resident]")
    return int(parts[0]), int(parts[1]), parts[2] if len(parts) == 3 else P.SHIPPED["residency"]


def run_config(qkv, heads, causal, rows, warps, residency, want, on_card, shipped_ms, iters, caps) -> str:
    """One configuration under each cap in turn -> its report line."""
    l, dtype = qkv.shape[1], qkv.dtype
    tag = f"rows={rows} warps={warps} {residency}"
    lines = []
    for cap in caps:
        try:
            got = P.probe_mha_qkv(qkv, heads, causal, rows=rows, warps=warps, residency=residency,
                                  smem_cap=cap)
        except P.ProbeDoesNotFit as exc:
            lines.append(f"{tag} cap {cap} B: does not fit (needs {exc.need} B, given {exc.have} B)")
            continue
        err = (got.float() - want).abs().max().item()
        line = (f"{tag} cap {cap} B: "
                f"{P.tile_smem_bytes(l, P.PROBE_HEAD_DIM, dtype.itemsize, warps, residency)} B/block")
        if on_card:
            blocks = P.probe_blocks_per_sm(dtype, l, warps, residency)
            event_ms, ms = both_clocks(lambda: P.probe_mha_qkv(qkv, heads, causal, rows=rows, warps=warps,
                                                               residency=residency, smem_cap=cap), iters)
            line += (f", {blocks} blocks/SM, {event_ms:.3f} ms/layer, device {format_ms(ms)}, "
                     f"{versus(ms, shipped_ms)} the shipped")
        lines.append(f"{line}  max|diff|={err:.2e}")
        break
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("shape", nargs="?", default="b16", choices=list(SHAPES))
    ap.add_argument("dtype", nargs="?", default="bf16", choices=list(DTYPES))
    ap.add_argument("configs", nargs="*", help="rows,warps[,streamed|resident]; default: a sweep")
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: the plain version at batch 2, no times")
    args = ap.parse_args(argv)
    on_card = announce_device("probe_qkv_gb", args.device, "the plain version at batch 2; no times")
    b, l, d, heads, causal = SHAPES[args.shape]
    b = b if on_card else 2
    dtype = DTYPES[args.dtype]
    print(f"shape B={b} L={l} D={d} H={heads} causal={causal} dtype={args.dtype}; the shipped block: "
          f"rows=64 warps=4 streamed; parity limit {PARITY_LIMIT[args.dtype]:g} (printed, not asserted)",
          flush=True)
    gen = torch.Generator(device=args.device).manual_seed(0)
    qkv = (torch.randn((b, l, 3 * d), generator=gen, device=args.device) * 0.02).to(dtype)
    want = P.tile_reference(*A._unpack_qkv(qkv), heads, causal).float()
    caps = (P.SMEM_DEFAULT, A.smem_limit(qkv.device))
    shipped_ms = None
    if on_card:
        event_ms, shipped_ms = both_clocks(lambda: A.fused_mha_qkv(qkv, heads, causal), args.iters)
        print(f"shipped (fused_mha_qkv): {event_ms:.3f} ms/layer, device {format_ms(shipped_ms)}", flush=True)
    for rows, warps, residency in [parse_config(c) for c in args.configs] or DEFAULT_CONFIGS:
        print(run_config(qkv, heads, causal, rows, warps, residency, want, on_card, shipped_ms, args.iters,
                         caps),
              flush=True)


if __name__ == "__main__":
    main()
