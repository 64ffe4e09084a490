"""Validate and time the attention backward kernels on the card.

    python -m anomalyclip_tpu_torch.scripts.bench_attn_bwd [--iters N]
        [--dtype bf16|fp32] [--qtile] [--flash] [--device cpu]

The counterpart of the JAX package's scripts/bench_attn_bwd.py, with its shape
list and its parity limits:

- the whole-block backward (``fused_mha_bld``'s) at the shapes the model
  differentiates: the CoOp text tower, the temporal model's two axes, and the
  unfrozen ViT-B/16 tower (256, 197, 768), which takes the KV-blocked kernels;
  fp32 within 2e-5 of max|ref| of the plain VJP;
- ``--qtile``: the q-tiled backward at the ViT-L/14@336px shape (32, 577, 1024),
  16 heads, the same limit;
- ``--flash``: the flash backward at the ragged (8, 1100, 64) against a float64
  ground truth, no noisier than twice the plain version; timed at (64, 2048, 64).

Each is followed by the forward+backward time of the kernel path and of the
plain path (CUDA events, median of ``--iters`` steps) in ``--dtype``, and names
the source of the backward kernel that serves the shape in that type: the
whole-head kernel of mha_bwd.cu, the tensor-core KV-blocked pair of
mha_tc_bwd.cu (bf16 at head dim 64), the split-TF32 pair of mha_tf32_bwd.cu
(fp32 at head dim 64) or the CUDA-core pair of mha_blocked_bwd.cu. It runs on
the card; ``--device cpu`` runs the plain versions at batch 2 for the parity
checks alone and prints no times.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from anomalyclip_tpu_torch.ops import attention as A
from anomalyclip_tpu_torch.scripts._bench_util import announce_device, median_ms

# (label, b, l, d, heads, causal): the gradient-consuming shapes
SHAPES = [
    ("text/coop n_cls=14", 14, 77, 512, 8, True),
    ("temporal seg-axis", 512, 32, 256, 8, False),  # b=32 videos * l=16
    ("temporal frame-axis", 1024, 16, 256, 8, False),  # b=32 videos * n=32
    ("unfrozen B/16 b=256", 256, 197, 768, 12, False),
]
QTILE_SHAPE = (32, 577, 1024, 16)  # ViT-L/14@336px: b, l, d, heads
FLASH_PARITY_SHAPE = (8, 1100, 64)  # ragged q and kv tilings on both axes
FLASH_TIMED_SHAPE = (64, 2048, 64)
PARITY_LIMIT = 2e-5  # fp32, of max|ref|
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def served_by(dtype: torch.dtype, dh: int, route: str = "blocked") -> str:
    """The source of the backward kernel a shape launches on the card, from its
    route (``attention_bwd_route``; K7, K9 and K10 have the blocked one alone),
    operand type and head dim."""
    if route == "whole":
        return "mha_bwd.cu"
    if A.mha_tc_eligible(dtype, dh):
        return "mha_tc_bwd.cu"
    return "mha_tf32_bwd.cu" if A.mha_tf32_eligible(dtype, dh) else "mha_blocked_bwd.cu"


def rel_err(got, want) -> float:
    """max|got - want| over max|want|, across the tensors of two tuples."""
    scale = max(w.float().abs().max().item() for w in want)
    return max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want)) / scale


def grad_step(fn, inputs) -> tuple:
    """The gradients of sum(fn(*inputs)^2) w.r.t. ``inputs``."""
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    return torch.autograd.grad((fn(*leaves).float() ** 2).sum(), leaves)


def _randn(gen, shape, device, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def whole_block_parity(b, l, d, h, causal, device) -> float:
    """fp32 (dq, dk, dv) of ``fused_mha_bld``'s backward entry against the plain
    VJP (autograd through the einsum formulation) -> the relative error."""
    gen = _gen(device, 0)
    q, k, v, g = (_randn(gen, (b, l, d), device) for _ in range(4))
    if torch.device(device).type == "cuda":
        got = A.mha_bld_bwd_kernel(q, k, v, g, h, causal)
    else:
        got = A.mha_bld_bwd_reference(q, k, v, g, h, causal)
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(A.mha_bld_reference(*leaves, h, causal), leaves, g)
    return rel_err(got, want)


def qtile_parity(b, l, d, h, device) -> float:
    """fp32 (dq, dkv) of the q-tiled backward against the plain VJP."""
    gen = _gen(device, 0)
    q, kv, g = _randn(gen, (b, l, d), device), _randn(gen, (b, l, 2 * d), device), _randn(gen, (b, l, d), device)
    if torch.device(device).type == "cuda":
        got = A.mha_qtile_bwd_kernel(q, kv, g, h)
    else:
        got = A.mha_qtile_bwd_reference(q, kv, g, h)
    leaves = [t.requires_grad_(True) for t in (q, kv)]
    want = torch.autograd.grad(A.mha_qtile_reference(*leaves, h), leaves, g)
    return rel_err(got, want)


def flash_parity_f64(device) -> dict:
    """The gradients of sum(flash_attention_heads(q, k, v)^2) in fp32 at the
    ragged shape against a float64 ground truth made on the host -> per
    gradient, (the entry's relative error, the plain fp32 VJP's)."""
    n, l, dh = FLASH_PARITY_SHAPE
    rng = np.random.default_rng(1)
    qn, kn, vn = (rng.standard_normal((n, l, dh)) for _ in range(3))
    scale = 1.0 / math.sqrt(dh)
    s = np.einsum("nld,nmd->nlm", qn, kn) * scale
    s -= s.max(axis=2, keepdims=True)
    p = np.exp(s)
    p /= p.sum(axis=2, keepdims=True)
    g = 2 * np.einsum("nlm,nmd->nld", p, vn)  # d/dout of sum(out^2)
    dp = np.einsum("nld,nmd->nlm", g, vn)
    ds = p * (dp - np.sum(p * dp, axis=2, keepdims=True))
    truth = (np.einsum("nlm,nmd->nld", ds, kn) * scale, np.einsum("nlm,nld->nmd", ds, qn) * scale,
             np.einsum("nlm,nld->nmd", p, g))
    inputs = [torch.as_tensor(t, dtype=torch.float32, device=device) for t in (qn, kn, vn)]
    got = grad_step(A.flash_attention_heads, inputs)
    plain = grad_step(
        lambda q, k, v: A.attention_reference(q[:, None], k[:, None], v[:, None])[:, 0], inputs
    )
    report = {}
    for name, ours, theirs, ref in zip(("dq", "dk", "dv"), got, plain, truth):
        top = np.abs(ref).max()
        report[name] = (float(np.abs(ours.double().cpu().numpy() - ref).max() / top),
                        float(np.abs(theirs.double().cpu().numpy() - ref).max() / top))
    return report


def check_flash_parity(report: dict) -> None:
    for name, (ours, plain) in report.items():
        # the kernel must not be meaningfully noisier than the plain VJP is
        # against float64
        assert ours < max(2 * plain, 1e-4), f"flash {name}: {ours:.2e} vs plain {plain:.2e}"


def timed_pair(kernel_step, plain_step, iters: int) -> tuple:
    """(kernel ms, plain ms) of two forward+backward steps, the plain one under
    ``attention_impl("reference")``."""
    kernel_ms = median_ms(kernel_step, iters)

    def plain():
        with A.attention_impl("reference"):
            plain_step()

    return kernel_ms, median_ms(plain, iters)


def bench_whole_block(iters: int, dtype_name: str, device) -> None:
    on_card = torch.device(device).type == "cuda"
    for label, b, l, d, h, causal in SHAPES:
        b = b if on_card else min(b, 2)
        err = whole_block_parity(b, l, d, h, causal, device)
        assert err < PARITY_LIMIT, f"{label}: backward parity {err:.2e}"
        route = A.attention_bwd_route(l, d // h, 4, A.smem_limit(torch.device(device)))
        dtype = DTYPES[dtype_name]
        print(f"{label:22s} (B={b:4d} L={l} D={d}): fp32 parity {err:.1e} ({route}: "
              f"{served_by(torch.float32, d // h, route)}; in {dtype_name} "
              f"{served_by(dtype, d // h, route)})", flush=True)
        if not on_card:
            continue
        gen = _gen(device, 1)
        inputs = [_randn(gen, (b, l, d), device, dtype) for _ in range(3)]
        step = lambda: grad_step(lambda q, k, v: A.fused_mha_bld(q, k, v, h, causal), inputs)  # noqa: E731
        kernel_ms, plain_ms = timed_pair(step, step, iters)
        print(f"{label:22s} (B={b:4d} L={l} D={d} {dtype_name}): fwd+bwd kernels "
              f"{kernel_ms:7.3f} ms  vs plain {plain_ms:7.3f} ms ({plain_ms / kernel_ms:4.2f}x), "
              f"backward by {served_by(dtype, d // h, route)}", flush=True)


def bench_qtile(iters: int, dtype_name: str, device) -> None:
    on_card = torch.device(device).type == "cuda"
    b, l, d, h = QTILE_SHAPE
    b = b if on_card else 2
    err = qtile_parity(b, l, d, h, device)
    assert err < PARITY_LIMIT, f"qtile backward parity {err:.2e}"
    dtype = DTYPES[dtype_name]
    print(f"qtile L/14@336        (B={b} L={l} D={d}): fp32 parity {err:.1e} "
          f"({served_by(torch.float32, d // h)}; in {dtype_name} {served_by(dtype, d // h)})",
          flush=True)
    if not on_card:
        return
    if A.mha_smem_bytes(l, d // h, dtype.itemsize) > A.smem_limit(torch.device(device)):
        print(f"qtile L/14@336        (B={b} L={l} D={d} {dtype_name}): the forward kernel does "
              f"not fit this shape in {dtype_name}; backward checked, step not timed", flush=True)
        return
    gen = _gen(device, 1)
    inputs = [_randn(gen, (b, l, d), device, dtype), _randn(gen, (b, l, 2 * d), device, dtype)]
    step = lambda: grad_step(lambda q, kv: A.fused_mha_qtile(q, kv, h), inputs)  # noqa: E731
    kernel_ms, plain_ms = timed_pair(step, step, iters)
    print(f"qtile L/14@336        (B={b} L={l} D={d} {dtype_name}): fwd+bwd kernels "
          f"{kernel_ms:7.3f} ms  vs plain {plain_ms:7.3f} ms ({plain_ms / kernel_ms:4.2f}x), "
          f"backward by {served_by(dtype, d // h)}", flush=True)


def bench_flash(iters: int, dtype_name: str, device) -> None:
    report = flash_parity_f64(device)
    check_flash_parity(report)
    dtype = DTYPES[dtype_name]
    for name, (ours, plain) in report.items():
        print(f"flash {name}: vs-f64 {ours:.2e} (plain VJP vs-f64 {plain:.2e})", flush=True)
    n, l, dh = FLASH_TIMED_SHAPE
    print(f"flash backward at head dim {FLASH_PARITY_SHAPE[2]} in fp32: "
          f"{served_by(torch.float32, FLASH_PARITY_SHAPE[2])}; at head dim {dh} in {dtype_name}: "
          f"{served_by(dtype, dh)}", flush=True)
    if torch.device(device).type != "cuda":
        return
    gen = _gen(device, 1)
    inputs = [_randn(gen, (n, l, dh), device, dtype) for _ in range(3)]
    step = lambda: grad_step(A.flash_attention_heads, inputs)  # noqa: E731
    kernel_ms, plain_ms = timed_pair(step, step, iters)
    print(f"flash long-L          (N={n} L={l} dh={dh} {dtype_name}): fwd+bwd kernels "
          f"{kernel_ms:7.3f} ms  vs plain {plain_ms:7.3f} ms ({plain_ms / kernel_ms:4.2f}x)",
          flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dtype", default="bf16", choices=list(DTYPES))
    ap.add_argument("--qtile", action="store_true",
                    help="only the q-tiled backward at the ViT-L/14@336px shape")
    ap.add_argument("--flash", action="store_true",
                    help="only the KV-blocked flash backward (long shapes)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: the plain versions at batch 2, parity only, no times")
    args = ap.parse_args(argv)
    announce_device("bench_attn_bwd", args.device, "plain versions; no times")
    if args.qtile:
        bench_qtile(args.iters, args.dtype, args.device)
    elif args.flash:
        bench_flash(args.iters, args.dtype, args.device)
    else:
        bench_whole_block(args.iters, args.dtype, args.device)


if __name__ == "__main__":
    main()
