"""Time the tensor-core kernels, forward and backward, at the CLIP towers' shapes.

    python -m anomalyclip_tpu_torch.scripts.bench_mha_tc [only ...] [--iters N] [--sass]
        [--device cpu]

``fused_mha_qkv``, ``fused_mha_qtile`` and ``flash_attention_heads`` launch one
kernel in bf16 at head dim 64 (ops/csrc/mha_tc.cu; K8 through its own
instantiation, with head strides and the log-sum-exp). For each tower's
per-layer shape, in bf16 on seeded normal inputs, a line gives max|diff|
against the KV-blocked plain version (which must stay under 1.5e-2, twice the
largest gap measured; K8's log-sum-exp under 1e-4), the median time
and the TFLOP/s it amounts to, beside ``scaled_dot_product_attention`` on the same views (a
yardstick: the port never calls it) and the least the card could take (the
larger of 4 L^2 dh operations a head over 989 TFLOP/s and the operands and the
output once over 3.35 TB/s); before them, the bytes of shared memory a block
takes and the blocks one SM holds. ``only``: substrings of the shape tags.

A second line a shape gives the backward: the KV-blocked pair of
ops/csrc/mha_tc_bwd.cu through the entry that owns the shape (K3's entry for a
packed qkv, K7 for q against k|v), its max|diff| over max|ref| against the plain
backward on the first ``PARITY_BATCH`` batch entries (within 2e-2), its time,
``scaled_dot_product_attention`` forward and backward through autograd, and the
bound (10 L^2 dh operations a head, seven tensors once). A shape short enough
for the whole-head backward of mha_bwd.cu is not the pair's and is named so;
K8's backward (K9, K10) is timed by chip_smoke.py's phase 3c, not here.

A third set of lines gives the fp32 kernel of ops/csrc/mha_tf32.cu, whose
products are split-TF32 (three TF32 products of the operands' big and small
parts) on the tensor cores: ``fused_mha_qkv`` in fp32 at the towers' packed
shapes, ``flash_attention_heads``' kernel at the ViT-L/14@336px tower's
heads, scoring (B=256) and gradient (B=32), on the (B, H, L, dh) views of one
packed projection as ``fused_attention`` hands them over, with the
log-sum-exp, and ``fused_mha_qtile``'s at the fp32 shape its admission limit
takes (L=400). Each is held within 1e-5 of the fp32 plain version and timed
beside ``scaled_dot_product_attention`` and the bound (4 L^2 dh operations a
head over 495 / 3 TFLOP/s, the split-TF32 rate of an fp32-accurate product, and
the operands and the output once).

A fourth set gives the split-TF32 backward pair of ops/csrc/mha_tf32_bwd.cu at
the fp32 paths' shapes: K9 and K10 on the ViT-L/14@336px tower gradient's
(B, H, L, dh) views with K8's log-sum-exp (the core rung), K7 at that tower's
q and k|v, and K3's entry at the ViT-B/16 gradient's packed qkv (past the
whole-head kernel). Each is held within 1e-5 of max|ref| of the fp32 plain
backward and of the emulation of its arithmetic
(``blocked_bwd_tf32x3_reference``) and timed beside
``scaled_dot_product_attention`` forward and backward and the bound (10 L^2 dh
operations a head, 6 + 8 for the flash pair's two passes, over 495 / 3
TFLOP/s, or the tensors once).

A fifth set gives the temporal model's axial attention in fp32 (K2,
``fused_mha_bld``, and its backward K4) at its four path shapes, 8 heads of 32,
q (B, L, 256) and k, v the two halves of one (B, L, 512) projection: along
segments (L=32) and frames (L=16) at a scoring grid batch of 4 and at the
training batch of 64. For each of K2, K4, ``scaled_dot_product_attention``
forward and its forward and backward through autograd, three clocks: the device
time of the kernels one call launches (torch.profiler), the event time of one
call as the other lines read it (CUDA events around the call), and the host time
of one enqueue (``HOST_CALLS`` enqueues on the host clock, no synchronisation);
K2 is held within 1e-5 of its fp32 plain version and K4 within 1e-5 of max|ref|
of its plain backward, and the lines name the kernel the launches took
(``route_counts``). Below about 0.3 ms the event time is the host's enqueue,
not the kernel's; a last line splits K2's host time at the first shape into
its parts (the entry through autograd, the wrapper, its shape checks, the
output's allocation, the stream lookup, the library call).

A sixth set gives the text towers' CoOp gradient in fp32 (``text``): K1
forward and K3 backward through the packed qkv at the UCF-Crime training
step's 14 prompts of 77 tokens, causal, for the ViT-B/16 text tower (width 512,
8 heads of 64) and ViT-L/14's (768, 12 heads), with
``scaled_dot_product_attention`` forward and forward+backward, each by the
three clocks of the fifth set; K3 is held within 1e-5 of max|ref| of its fp32
plain backward (on the card: whichever kernel the wrapper takes, named by the
route counts). A last set times K5's whole-block branch (``whole-block``,
``fused_attention_fwd_kernel``) at ViT-B/16's heads, (256, 12, 197, 64), in
fp32 and bf16, causal and not, by device and event time beside
``scaled_dot_product_attention`` and the bound; fp32 is held within 1e-5 of
the whole-row plain version, bf16 within 5e-2 of the plain version at the
tensor-core kernel's KV block. Both sets use only entries that every slice of
the port has had, so the script also times an older checkout's kernels.

``--sass`` adds the opcode mix of each kernel (the tensor-core kernel's two
instantiations apart), read from ``cuobjdump -sass`` of the built library: the
opcodes of the whole kernel and of its main loops (each
from its barrier to its backward branch, the mask of a ragged block included:
the forward's KV loop, the dq kernel's statistics and gradient sweeps, the dkv
kernel's sweep over the q tiles), which is what the tensor-core operations
(HMMA) have to be dispatched among.

``--device cpu`` runs the entries' plain versions (the KV-blocked form) at batch
2, holds them against the whole-row form, holds the emulations of the
split-TF32 arithmetic (``tf32x3_reference``, ``blocked_bwd_tf32x3_reference``,
``mha_bld_tf32x3_reference``, ``mha_bld_bwd_tf32x3_reference``) against the
fp32 plain versions, and prints no times.
"""

from __future__ import annotations

import argparse
import collections
import functools
import re
import shutil
import subprocess

import numpy as np
import torch

from anomalyclip_tpu_torch.ops import attention as A
from anomalyclip_tpu_torch.ops import build
from anomalyclip_tpu_torch.scripts._bench_util import (
    announce_device,
    device_ms,
    format_ms,
    host_ms,
    median_ms,
)

# tag, B, L, D, heads, causal, the entry
SHAPES = [
    ("ViT-B/16 vision", 256, 197, 768, 12, False, "qkv"),
    ("ViT-L/14 vision", 64, 257, 1024, 16, False, "qkv"),
    ("ViT-B/32 vision", 512, 50, 768, 12, False, "qkv"),
    ("text tower, causal", 256, 77, 512, 8, True, "qkv"),
    ("ViT-L/14@336px vision", 256, 577, 1024, 16, False, "qtile"),
    ("ViT-L/14@336px vision, batch 32", 32, 577, 1024, 16, False, "qtile"),
    # K8 on the (B, H, L, dh) views, as the bf16 core rung hands them over
    ("ViT-L/14@336px vision, heads", 256, 577, 1024, 16, False, "flash"),
]
LSE_PARITY_LIMIT = 1e-4  # K8's log-sum-exp against the plain one
PARITY_LIMIT = 0.015  # the kernel against the KV-blocked plain version
BWD_PARITY_LIMIT = 0.02  # the backward pair against the plain backward, of max|ref|
PARITY_BATCH = 8  # batch entries of a backward held against the plain version
WHOLE_ROW_LIMIT = 0.05  # the KV-blocked plain version against the whole-row one, on the CPU
PEAK_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12  # NVIDIA H100 SXM: dense bf16, HBM3
# the fp32 kernel's shapes: tag, B, L, D, heads, causal, the entry ("flash": K8
# on the (B, H, L, dh) views of the packed projection)
TF32_SHAPES = [
    ("ViT-B/16 vision", 256, 197, 768, 12, False, "qkv"),
    ("ViT-L/14 vision", 64, 257, 1024, 16, False, "qkv"),
    ("text tower, causal", 14, 77, 512, 8, True, "qkv"),
    ("ViT-L/14@336px vision, heads", 256, 577, 1024, 16, False, "flash"),
    ("ViT-L/14@336px gradient, heads", 32, 577, 1024, 16, False, "flash"),
    ("ViT-L/14@336px vision at L=400", 64, 400, 1024, 16, False, "qtile"),
]
TF32_PARITY_LIMIT = 1e-5  # the fp32 kernel against the fp32 plain version, absolute
# the split-TF32 backward pair's shapes, the same fields: "flash" is K9 and K10
# on the core rung's head views, "qtile" K7, "qkv" K3's entry
TF32_BWD_SHAPES = [
    ("ViT-L/14@336px gradient, heads", 32, 577, 1024, 16, False, "flash"),
    ("ViT-L/14@336px gradient", 32, 577, 1024, 16, False, "qtile"),
    ("ViT-B/16 gradient", 32, 197, 768, 12, False, "qkv"),
]
PEAK_TF32X3_FLOPS = 495e12 / 3  # dense TF32 over the three products of a split product
# the temporal model's axial attention (models/temporal.py): tag, B, L, D,
# heads; along segments (L=32, the grid's 16 frames folded into the batch) and
# along frames (L=16, its 32 segments folded), at a scoring grid batch of 4
# and at the training batch of 64
BLD_SHAPES = [
    ("temporal scoring, segments", 64, 32, 256, 8),
    ("temporal scoring, frames", 128, 16, 256, 8),
    ("temporal training, segments", 1024, 32, 256, 8),
    ("temporal training, frames", 2048, 16, 256, 8),
]
HOST_CALLS = 200  # enqueues timed on the host clock for one host time
# the text towers (causal, L=77) at the UCF-Crime training step's 14 prompts:
# tag, B, L, D, heads
TEXT_SHAPES = [
    ("text tower", 14, 77, 512, 8),
    ("ViT-L/14 text tower", 14, 77, 768, 12),
]
# K5's whole-block branch at ViT-B/16's heads: (B, H, L, dh), its dtypes and masks
WHOLE_BLOCK_DIMS = (256, 12, 197, 64)
WHOLE_BLOCK_CASES = [(dtype, causal) for dtype in (torch.float32, torch.bfloat16) for causal in (False, True)]
WHOLE_BLOCK_BF16_LIMIT = 5e-2  # bf16 against the plain version at the kernel's KV block


def run(entry: str, x: torch.Tensor, d: int, heads: int, causal: bool) -> tuple:
    """One call of the entry's kernel wrapper on the packed (B, L, 3D) x; K6 takes
    q and k|v as its column slices, as the qtile rung over a packed projection,
    and K8 the (B, H, L, dh) views, as the core rung -> (out,) or (out, lse)."""
    if entry == "qkv":
        return (A.mha_qkv_fwd_kernel(x, heads, causal),)
    if entry == "flash":
        return A.flash_fwd_kernel(*heads_views(x, heads), True, causal)
    return (A.mha_qtile_fwd_kernel(x[..., :d], x[..., d:], heads),)


def plain(entry: str, x: torch.Tensor, heads: int, causal: bool) -> tuple:
    """The KV-blocked plain version of ``run``'s call: for K6 the same function
    of the packed x."""
    if entry == "flash":
        return A.flash_attention_reference(*heads_views(x, heads), True, A.MHA_TC_BLOCK_KV, causal)
    return (A.mha_qkv_reference(x, heads, causal, A.MHA_TC_BLOCK_KV),)


def sdpa(x: torch.Tensor, heads: int, causal: bool) -> torch.Tensor:
    b, l, width = x.shape
    q, k, v = x.view(b, l, 3, heads, width // (3 * heads)).permute(2, 0, 3, 1, 4)
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal)


def heads_views(x: torch.Tensor, heads: int) -> tuple:
    """The (B, H, L, dh) views of q, k, v in the packed (B, L, 3D) x."""
    b, l, width = x.shape
    return tuple(x.view(b, l, 3, heads, width // (3 * heads)).permute(2, 0, 3, 1, 4))


def run_tf32(entry: str, x: torch.Tensor, heads: int, causal: bool) -> tuple:
    """One call of the fp32 kernel's wrapper: K1 on the packed x, K6 on its
    column slices, or K8 with the log-sum-exp on its head views."""
    if entry == "qkv":
        return (A.mha_qkv_fwd_kernel(x, heads, causal),)
    if entry == "qtile":
        d = x.shape[-1] // 3
        return (A.mha_qtile_fwd_kernel(x[..., :d], x[..., d:], heads),)
    return A.flash_fwd_kernel(*heads_views(x, heads), True, causal)


def plain_tf32(entry: str, x: torch.Tensor, heads: int, causal: bool, emulated: bool = False) -> tuple:
    """The fp32 plain version of ``run_tf32``'s call, or the emulation of the
    kernel's split-TF32 arithmetic."""
    views = heads_views(x, heads)
    if emulated:
        out, lse = A.tf32x3_reference(*views, causal, save_lse=True)
    else:
        out, lse = A.flash_attention_reference(*views, save_lse=True, causal=causal)
    if entry != "flash":  # K6 of the packed x's slices is K1's function of x
        return (out.transpose(1, 2).reshape(x.shape[0], x.shape[1], -1),)
    return out, lse


def bench_tf32(tag: str, b: int, l: int, d: int, heads: int, causal: bool, entry: str,
               on_card: bool, device: str, iters: int) -> None:
    """A line of the fp32 kernel: parity against the fp32 plain version, and on
    the card its time beside sdpa's and the bound."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((b, l, 3 * d)).astype(np.float32)).to(device)
    want = plain_tf32(entry, x, heads, causal)
    got = run_tf32(entry, x, heads, causal) if on_card else plain_tf32(entry, x, heads, causal, True)
    err = max((a - w).abs().max().item() for a, w in zip(got, want))
    if not err < TF32_PARITY_LIMIT:
        raise AssertionError(f"{tag}, fp32: max|diff| {err} against the fp32 plain version")
    del got, want
    shape = f"{tag} fp32 (B={b}, L={l}, D={d}, H={heads}, {entry})"
    if not on_card:
        print(f"{shape}: the split-TF32 emulation, max|diff|={err:.2e}", flush=True)
        return
    dh = d // heads
    flops = 4 * b * heads * l * l * dh * (0.5 if causal else 1.0)
    stats = 4 * b * heads * l if entry == "flash" else 0
    bound_ms = max(flops / PEAK_TF32X3_FLOPS, (4 * 4 * b * l * d + stats) / PEAK_BYTES_PER_S) * 1e3
    sdpa_ms = median_ms(lambda: sdpa(x, heads, causal), iters)
    ms = median_ms(lambda: run_tf32(entry, x, heads, causal), iters)
    print(f"{shape} (mha_tf32.cu): {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), sdpa "
          f"{sdpa_ms:.4f} ms, bound {bound_ms:.4f} ms  max|diff|={err:.2e}", flush=True)


def flash_backward_parts(x: torch.Tensor, g: torch.Tensor, heads: int, causal: bool,
                         on_card: bool) -> tuple:
    """What K9 and K10 take on the core rung: the head views of the packed x and
    of g, K8's log-sum-exp (one launch on the card) and delta from its output."""
    views = heads_views(x, heads)
    b, l, d = g.shape
    g4 = g.view(b, l, heads, d // heads).transpose(1, 2)
    forward = A.flash_fwd_kernel if on_card else A.flash_attention_reference
    out, lse = forward(*views, True, causal=causal)
    return (*views, g4, lse, A.flash_delta(g4, out))


def tf32_backward(entry: str, parts: tuple, heads: int, causal: bool, how: str) -> tuple:
    """The fp32 backward of one path shape -> its gradients: ``how`` is "kernel"
    (the split-TF32 pair through the entry that owns the shape), "plain" or
    "emulated" (``blocked_bwd_tf32x3_reference``). ``parts``: (x, g), or for
    "flash" what ``flash_backward_parts`` returns."""
    if entry == "flash":
        if how == "kernel":
            return (A.flash_dq_kernel(*parts, causal), *A.flash_dkv_kernel(*parts, causal))
        if how == "plain":
            return (A.flash_dq_reference(*parts, causal), *A.flash_dkv_reference(*parts, causal))
        return A.blocked_bwd_tf32x3_reference(*parts, causal)
    x, g = parts
    d = g.shape[-1]
    if how == "kernel":
        return backward(entry, x, g, d, heads, causal)
    if how == "plain":
        return plain_backward(entry, x, g, d, heads, causal)
    if entry == "qkv":
        return (A.mha_qkv_bwd_tf32x3_reference(x, g, heads, causal),)
    return A.mha_qtile_bwd_tf32x3_reference(x[..., :d], x[..., d:], g, heads)


def bench_tf32_backward(tag: str, b: int, l: int, d: int, heads: int, causal: bool, entry: str,
                        on_card: bool, device: str, iters: int) -> None:
    """A line of the split-TF32 backward pair: parity against the fp32 plain
    backward and the emulation, and on the card its time beside sdpa's forward
    and backward and the bound. On the CPU the emulation against the plain
    backward."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((b, l, 3 * d)).astype(np.float32)).to(device)
    g = torch.from_numpy(rng.standard_normal((b, l, d)).astype(np.float32)).to(device)
    parts = flash_backward_parts(x, g, heads, causal, on_card) if entry == "flash" else (x, g)
    want = tf32_backward(entry, parts, heads, causal, "plain")
    top = max(w.abs().max().item() for w in want)

    def gap(got, ref):
        return max((a - r).abs().max().item() for a, r in zip(got, ref)) / top

    emu = tf32_backward(entry, parts, heads, causal, "emulated")
    gaps = {"emulated": gap(emu, want)}
    if on_card:
        got = tf32_backward(entry, parts, heads, causal, "kernel")
        gaps.update({"kernel": gap(got, want), "kernel vs emulated": gap(got, emu)})
        del got
    if not max(gaps.values()) <= TF32_PARITY_LIMIT:
        raise AssertionError(f"{tag}, fp32 backward: {gaps} of max|ref|")
    del want, emu
    shape = f"{tag} fp32 backward (B={b}, L={l}, D={d}, H={heads}, {entry})"
    of_ref = ", ".join(f"{how} {gap:.2e}" for how, gap in gaps.items())
    if not on_card:
        print(f"{shape}: the split-TF32 emulation against the plain backward, {of_ref} of max|ref|",
              flush=True)
        return
    dh = d // heads
    flops = (14 if entry == "flash" else 10) * b * heads * l * l * dh * (0.5 if causal else 1.0)
    bound_ms = max(flops / PEAK_TF32X3_FLOPS, 4 * 7 * b * l * d / PEAK_BYTES_PER_S) * 1e3
    sdpa_ms = median_ms(lambda: sdpa_backward(x, g, heads, causal), iters)
    ms = median_ms(lambda: tf32_backward(entry, parts, heads, causal, "kernel"), iters)
    print(f"{shape} (mha_tf32_bwd.cu): {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), sdpa "
          f"forward+backward {sdpa_ms:.4f} ms, bound {bound_ms:.4f} ms  {of_ref} of max|ref|",
          flush=True)


def three_clocks(shape: str, calls: dict, bounds: dict, iters: int) -> None:
    """A line per call: device, event and host time, beside the bound of its
    kind ("backward" where the name says so, else "forward")."""
    for name, fn in calls.items():
        times = (device_ms(fn, iters), median_ms(fn, iters), host_ms(fn, HOST_CALLS))
        kind = "backward" if "backward" in name or name in ("K3", "K4") else "forward"
        print(f"{shape} {name}: device {format_ms(times[0])}, event {times[1]:.4f} ms, host "
              f"{times[2]:.4f} ms an enqueue; {kind} bound {bounds[kind]:.4f} ms", flush=True)


def bench_bld(tag: str, b: int, l: int, d: int, heads: int, on_card: bool, device: str,
              iters: int) -> None:
    """The lines of one temporal shape: on the card K2, K4 and sdpa forward and
    forward+backward, each by device, event and host time, beside the bounds;
    on the CPU the emulations of the split-TF32 arithmetic against the fp32
    plain versions."""
    rng = np.random.default_rng(4)
    q, kv, g = (torch.from_numpy(rng.standard_normal((b, l, w)).astype(np.float32)).to(device)
                for w in (d, 2 * d, d))
    k, v = kv[..., :d], kv[..., d:]
    shape = f"{tag} fp32 (B={b}, L={l}, D={d}, H={heads})"
    want_out = A.mha_bld_reference(q, k, v, heads)
    want_grads = A.mha_bld_bwd_reference(q, k, v, g, heads)
    top = max(w.abs().max().item() for w in want_grads)
    if on_card:
        got_out = A.mha_bld_fwd_kernel(q, k, v, heads, False)
        got_grads = A.mha_bld_bwd_kernel(q, k, v, g, heads, False)
    else:
        got_out = A.mha_bld_tf32x3_reference(q, k, v, heads)
        got_grads = A.mha_bld_bwd_tf32x3_reference(q, k, v, g, heads)
    err = (got_out - want_out).abs().max().item()
    bwd_err = max((a - w).abs().max().item() for a, w in zip(got_grads, want_grads)) / top
    if not (err <= TF32_PARITY_LIMIT and bwd_err <= TF32_PARITY_LIMIT):
        raise AssertionError(f"{shape}: forward max|diff| {err}, backward {bwd_err} of max|ref|")
    del got_out, got_grads, want_out, want_grads
    if not on_card:
        print(f"{shape}: the split-TF32 emulations against the fp32 plain versions, forward "
              f"max|diff|={err:.2e}, backward {bwd_err:.2e} of max|ref|", flush=True)
        return
    dh = d // heads
    views = [t.view(b, l, heads, dh).transpose(1, 2) for t in (q, k, v, g)]

    def sdpa_forward():
        return torch.nn.functional.scaled_dot_product_attention(*views[:3])

    def sdpa_forward_backward():
        leaves = [t.detach().requires_grad_(True) for t in views[:3]]
        out = torch.nn.functional.scaled_dot_product_attention(*leaves)
        return torch.autograd.grad(out, leaves, views[3])

    calls = {
        "K2": lambda: A.mha_bld_fwd_kernel(q, k, v, heads, False),
        "K4": lambda: A.mha_bld_bwd_kernel(q, k, v, g, heads, False),
        "sdpa forward": sdpa_forward,
        "sdpa forward+backward": sdpa_forward_backward,
    }
    # the least the card could take: 4 L^2 dh operations a head forward and 10
    # backward over the split-TF32 rate, or q, k, v and the output once (with g
    # and the three gradients backward) over the memory rate
    pairs = b * heads * l * l * dh
    bounds = {kind: max(ops * pairs / PEAK_TF32X3_FLOPS, 4 * tensors * b * l * d / PEAK_BYTES_PER_S) * 1e3
              for kind, ops, tensors in (("forward", 4, 4), ("backward", 10, 7))}
    before = dict(A.route_counts)
    three_clocks(shape, calls, bounds, iters)
    routes = {k: n - before.get(k, 0) for k, n in A.route_counts.items() if n != before.get(k, 0)}
    print(f"{shape}: K2 max|diff|={err:.2e}, K4 {bwd_err:.2e} of max|ref| against the fp32 plain "
          f"versions; route counts of the timed launches {routes}", flush=True)


def bld_host_breakdown(b: int, l: int, d: int, heads: int) -> None:
    """Where K2's host time goes at one shape, each part by ``host_ms``: the
    entry as the temporal model calls it (``fused_mha_bld``, through autograd),
    the kernel wrapper, and the wrapper's parts (the shape checks, the output's
    allocation, the stream lookup, the library call with its arguments made)."""
    from anomalyclip_tpu_torch.ops import build as B

    gen = torch.Generator(device="cuda").manual_seed(5)
    q, kv = (torch.randn(b, l, w, device="cuda", generator=gen) for w in (d, 2 * d))
    k, v = kv[..., :d], kv[..., d:]
    dh, scale, strides = A._bld_tf32_args("fused_mha_bld", (q, k, v), heads, "bld_fwd")
    out = torch.empty_like(q)
    lib = B.load_library()
    args = (q.data_ptr(), *strides[0:2], k.data_ptr(), *strides[2:4], v.data_ptr(), *strides[4:6],
            out.data_ptr(), b, l, heads, dh, 0, scale, A._stream(q))
    parts = {
        "entry fused_mha_bld": lambda: A.fused_mha_bld(q, k, v, heads),
        "wrapper mha_bld_fwd_kernel": lambda: A.mha_bld_fwd_kernel(q, k, v, heads, False),
        "shape checks": lambda: A._bld_tf32_args("fused_mha_bld", (q, k, v), heads, "bld_fwd"),
        "output allocation": lambda: torch.empty((b, l, d), dtype=q.dtype, device=q.device),
        "stream lookup": lambda: A._stream(q),
        "library call": lambda: lib.acl_mha_bld_tf32_fwd(*args),
    }
    print(f"K2 host time at (B={b}, L={l}, D={d}, H={heads}), ms an enqueue: "
          + ", ".join(f"{name} {host_ms(fn, HOST_CALLS):.4f}" for name, fn in parts.items()), flush=True)


def bench_text(tag: str, b: int, l: int, d: int, heads: int, on_card: bool, device: str,
               iters: int) -> None:
    """The lines of one text tower: on the card K1, K3 and sdpa forward and
    forward+backward, each by device, event and host time, beside the bounds;
    on the CPU the emulation of the split-TF32 whole-head backward against the
    fp32 plain backward."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((b, l, 3 * d)).astype(np.float32)).to(device)
    g = torch.from_numpy(rng.standard_normal((b, l, d)).astype(np.float32)).to(device)
    shape = f"{tag} fp32 causal (B={b}, L={l}, D={d}, H={heads})"
    want = A.mha_qkv_bwd_reference(x, g, heads, True)
    if on_card:
        got = A.mha_qkv_bwd_kernel(x, g, heads, True)
        fwd = A.mha_qkv_fwd_kernel(x, heads, True)
        fwd_err = (fwd - A.mha_qkv_reference(x, heads, True)).abs().max().item()
    else:
        got = torch.cat(A.mha_bld_bwd_tf32x3_reference(*A._unpack_qkv(x), g, heads, True), dim=-1)
        fwd_err = 0.0
    err = (got - want).abs().max().item() / want.abs().max().item()
    if not (err <= TF32_PARITY_LIMIT and fwd_err <= TF32_PARITY_LIMIT):
        raise AssertionError(f"{shape}: K3 {err} of max|ref|, K1 max|diff| {fwd_err}")
    del got, want
    if not on_card:
        print(f"{shape}: the split-TF32 emulation against the fp32 plain backward, {err:.2e} of "
              f"max|ref|", flush=True)
        return
    dh = d // heads
    pairs = b * heads * l * l * dh * 0.5  # causal: half the score entries
    bounds = {kind: max(ops * pairs / PEAK_TF32X3_FLOPS, 4 * tensors * b * l * d / PEAK_BYTES_PER_S) * 1e3
              for kind, ops, tensors in (("forward", 4, 4), ("backward", 10, 7))}
    before = dict(A.route_counts)
    three_clocks(shape, {
        "K1": lambda: A.mha_qkv_fwd_kernel(x, heads, True),
        "K3": lambda: A.mha_qkv_bwd_kernel(x, g, heads, True),
        "sdpa forward": lambda: sdpa(x, heads, True),
        "sdpa forward+backward": lambda: sdpa_backward(x, g, heads, True),
    }, bounds, iters)
    routes = {k: n - before.get(k, 0) for k, n in A.route_counts.items() if n != before.get(k, 0)}
    print(f"{shape}: K1 max|diff|={fwd_err:.2e}, K3 {err:.2e} of max|ref| against the fp32 plain "
          f"versions; route counts of the timed launches {routes}", flush=True)


def bench_whole_block(on_card: bool, device: str, iters: int) -> None:
    """K5's whole-block branch at ``WHOLE_BLOCK_DIMS``, each dtype and mask: on
    the card its device and event time beside sdpa's and the bound; on the CPU
    (batch 2) the entry's plain version against the whole-row one."""
    b, h, l, dh = WHOLE_BLOCK_DIMS
    b = b if on_card else 2
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((3, b, h, l, dh)).astype(np.float32)).to(device)
    for dtype, causal in WHOLE_BLOCK_CASES:
        q, k, v = x.to(dtype)
        shape = f"whole-block {str(dtype).split('.')[-1]} (B={b}, H={h}, L={l}, dh={dh}) causal={causal}"
        if dtype == torch.float32:
            want, limit = A.attention_reference(q, k, v, causal), TF32_PARITY_LIMIT
        else:
            want = A.attention_blocked_reference(q, k, v, causal, A.MHA_TC_BLOCK_KV)
            limit = WHOLE_BLOCK_BF16_LIMIT
        got = A.fused_attention_fwd_kernel(q, k, v, causal) if on_card else A.fused_attention(q, k, v, causal)
        err = (got.float() - want.float()).abs().max().item()
        if not err <= limit:
            raise AssertionError(f"{shape}: max|diff| {err} against the plain version")
        del got, want
        if not on_card:
            print(f"{shape}: the entry's plain version, max|diff|={err:.2e}", flush=True)
            continue
        flops = 4 * b * h * l * l * dh * (0.5 if causal else 1.0)
        peak = PEAK_TF32X3_FLOPS if dtype == torch.float32 else PEAK_FLOPS
        bound_ms = max(flops / peak, dtype.itemsize * 4 * b * h * l * dh / PEAK_BYTES_PER_S) * 1e3
        before = dict(A.route_counts)
        calls = {"K5": lambda: A.fused_attention_fwd_kernel(q, k, v, causal),
                 "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal)}
        times = {name: (device_ms(fn, iters), median_ms(fn, iters)) for name, fn in calls.items()}
        routes = {k: n - before.get(k, 0) for k, n in A.route_counts.items() if n != before.get(k, 0)}
        print(f"{shape}: " + ", ".join(f"{name} device {format_ms(dev)}, event {event:.4f} ms"
                                       for name, (dev, event) in times.items())
              + f"; bound {bound_ms:.4f} ms  max|diff|={err:.2e}; route counts {routes}", flush=True)


def backward(entry: str, x: torch.Tensor, g: torch.Tensor, d: int, heads: int, causal: bool) -> tuple:
    """One call of the backward entry that owns the shape -> its gradients."""
    if entry == "qkv":
        return (A.mha_qkv_bwd_kernel(x, g, heads, causal),)
    return A.mha_qtile_bwd_kernel(x[..., :d], x[..., d:], g, heads)


def plain_backward(entry: str, x: torch.Tensor, g: torch.Tensor, d: int, heads: int, causal: bool) -> tuple:
    if entry == "qkv":
        return (A.mha_qkv_bwd_reference(x, g, heads, causal),)
    return A.mha_qtile_bwd_reference(x[..., :d], x[..., d:], g, heads)


def sdpa_backward(x: torch.Tensor, g: torch.Tensor, heads: int, causal: bool) -> tuple:
    b, l, width = x.shape
    dh = width // (3 * heads)
    leaves = [t.detach().requires_grad_(True) for t in x.view(b, l, 3, heads, dh).permute(2, 0, 3, 1, 4)]
    out = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=causal)
    return torch.autograd.grad(out, leaves, g.view(b, l, heads, dh).transpose(1, 2))


def bench_backward(tag: str, entry: str, x: torch.Tensor, d: int, heads: int, causal: bool,
                   iters: int) -> None:
    """The second line of a shape: the tensor-core backward pair, or why not."""
    b, l, _ = x.shape
    dh = d // heads
    route = A.attention_bwd_route(l, dh, x.element_size(), A.smem_limit(x.device))
    if entry == "qkv" and route != "blocked":
        print(f"{tag}, backward: the {route}-head kernel of mha_bwd.cu takes L={l}, not the pair",
              flush=True)
        return
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.standard_normal((b, l, d)).astype(np.float32)).to(x)
    n = min(b, PARITY_BATCH)
    want = plain_backward(entry, x[:n], g[:n], d, heads, causal)
    got = backward(entry, x, g, d, heads, causal)
    top = max(w.float().abs().max().item() for w in want)
    err = max((a[:n].float() - w.float()).abs().max().item() for a, w in zip(got, want)) / top
    if not err < BWD_PARITY_LIMIT:
        raise AssertionError(f"{tag}, backward: max|diff| {err} of max|ref| against the plain version")
    del got, want
    flops = 10 * b * heads * l * l * dh * (0.5 if causal else 1.0)
    bound_ms = max(flops / PEAK_FLOPS, 2 * 7 * b * l * d / PEAK_BYTES_PER_S) * 1e3
    sdpa_ms = median_ms(lambda: sdpa_backward(x, g, heads, causal), iters)
    ms = median_ms(lambda: backward(entry, x, g, d, heads, causal), iters)
    print(f"{tag}, backward (mha_tc_bwd.cu): {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s of the "
          f"five products), sdpa forward+backward {sdpa_ms:.4f} ms, bound {bound_ms:.4f} ms"
          f"  max|diff|/max|ref|={err:.2e}", flush=True)


@functools.lru_cache(maxsize=None)
def _library_sass() -> str:
    """``cuobjdump -sass`` of the built library, dumped once: it takes seconds."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", str(build.library_path())], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def sass_mix(*parts: str) -> tuple:
    """(opcode counts of the whole kernel, of each of its main loops in address
    order) for the function of the built library whose mangled name contains
    every one of ``parts``. A main loop: the outermost backward branch around a
    barrier."""
    body = next(f for f in _library_sass().split("Function : ")[1:]
                if all(part in f.split("\n", 1)[0] for part in parts))
    code = []  # (address, opcode, branch target or None)
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)[^;]*;", body):
        target = re.search(r"\bBRA\b[^;]*\b0x([0-9a-f]+)", m.group(0))
        code.append((int(m.group(1), 16), m.group(2), int(target.group(1), 16) if target else None))
    loops = []  # (start, end), each the last backward branch over a barrier no earlier loop holds
    for barrier in (a for a, op, _ in code if op == "BAR"):
        if any(start <= barrier <= end for start, end in loops):
            continue
        around = [(t, a) for a, _, t in code if t is not None and t <= barrier < a]
        if around:
            loops.append(max(around, key=lambda loop: loop[1]))
    whole = collections.Counter(op for _, op, _ in code)
    return whole, [collections.Counter(op for a, op, _ in code if start <= a <= end)
                   for start, end in loops]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("only", nargs="*", help="substrings of the shape tags to run")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--sass", action="store_true", help="the kernel's opcode mix (cuobjdump)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: the plain versions at batch 2, no times")
    args = ap.parse_args(argv)
    on_card = announce_device("bench_mha_tc", args.device, "plain versions at batch 2; no times")
    if on_card:
        dh, lib = A.MHA_TC_HEAD_DIM, build.load_library()
        print(f"head dim {dh}: {A.mha_tc_smem_bytes(dh)} B/block, "
              f"{lib.acl_mha_tc_blocks_per_sm(dh, 0)} blocks/SM (K1, K6), "
              f"{lib.acl_mha_tc_blocks_per_sm(dh, 1)} (K8); backward "
              + ", ".join(f"{name} {A.blocked_bwd_tc_smem_bytes(dh, name)} B/block, "
                          f"{lib.acl_blocked_bwd_tc_blocks_per_sm(dh, code)} blocks/SM"
                          for name, code in A.BWD_TC_PASSES.items()), flush=True)
    for tag, b, l, d, heads, causal, entry in SHAPES:
        if args.only and not any(s in tag for s in args.only):
            continue
        b = b if on_card else 2
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((b, l, 3 * d)).astype(np.float32))
        x = x.to(device=args.device, dtype=torch.bfloat16)
        if not on_card:
            # the entry runs the KV-blocked plain version: held against the whole-row one
            if entry == "qkv":
                fused = A.fused_mha_qkv(x, heads, causal)
            elif entry == "qtile":
                fused = A.fused_mha_qtile(x[..., :d], x[..., d:], heads)
            else:
                fused = A.fused_attention(*heads_views(x, heads), causal).transpose(1, 2).flatten(2)
            err = (fused.float() - A.mha_qkv_reference(x, heads, causal).float()).abs().max().item()
            if not err < WHOLE_ROW_LIMIT:
                raise AssertionError(f"{tag}: max|diff| {err} against the whole-row plain version")
            print(f"{tag} (B={b}, L={l}, D={d}, H={heads}): max|diff|={err:.2e}", flush=True)
            continue
        want = plain(entry, x, heads, causal)
        dh = d // heads
        flops = 4 * b * heads * l * l * dh * (0.5 if causal else 1.0)
        stats = 4 * b * heads * l if entry == "flash" else 0
        bound_ms = max(flops / PEAK_FLOPS, (2 * 4 * b * l * d + stats) / PEAK_BYTES_PER_S) * 1e3
        sdpa_ms = median_ms(lambda: sdpa(x, heads, causal), args.iters)
        got = run(entry, x, d, heads, causal)
        err = (got[0].float() - want[0].float()).abs().max().item()
        lse_err = (got[1] - want[1]).abs().max().item() if entry == "flash" else 0.0
        if not (err < PARITY_LIMIT and lse_err < LSE_PARITY_LIMIT):
            raise AssertionError(f"{tag}: max|diff| {err}, lse {lse_err} against the plain version")
        del got, want
        ms = median_ms(lambda: run(entry, x, d, heads, causal), args.iters)
        print(f"{tag} (B={b}, L={l}, D={d}, H={heads}, {entry}): {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), sdpa {sdpa_ms:.4f} ms, bound {bound_ms:.4f} ms"
              f"  max|diff|={err:.2e}" + (f" lse {lse_err:.2e}" if entry == "flash" else ""), flush=True)
        if entry == "flash":
            print(f"{tag}, backward: K9 and K10 are chip_smoke.py's phase 3c", flush=True)
        else:
            bench_backward(tag, entry, x, d, heads, causal, args.iters)
    if on_card:
        lib = build.load_library()
        print(f"fp32, head dim {A.MHA_TF32_HEAD_DIM}: {A.mha_tf32_smem_bytes()} B/block, "
              f"{lib.acl_mha_tf32_blocks_per_sm(A.MHA_TF32_HEAD_DIM)} blocks/SM", flush=True)
    for tag, b, l, d, heads, causal, entry in TF32_SHAPES:
        if not args.only or any(s in tag for s in args.only):
            bench_tf32(tag, b if on_card else 2, l, d, heads, causal, entry, on_card, args.device,
                       args.iters)
    if on_card:
        print("fp32 backward, head dim 64: "
              + ", ".join(f"{name} {A.blocked_bwd_tf32_smem_bytes(64, name)} B/block, "
                          f"{lib.acl_blocked_bwd_tf32_blocks_per_sm(64, code)} blocks/SM"
                          for name, code in A.BWD_TC_PASSES.items()), flush=True)
    for tag, b, l, d, heads, causal, entry in TF32_BWD_SHAPES:
        if not args.only or any(s in tag for s in args.only):
            bench_tf32_backward(tag, b if on_card else 2, l, d, heads, causal, entry, on_card,
                                args.device, args.iters)
    for tag, b, l, d, heads in BLD_SHAPES:
        if not args.only or any(s in tag for s in args.only):
            bench_bld(tag, b if on_card else 2, l, d, heads, on_card, args.device, args.iters)
    tag, *shape = BLD_SHAPES[0]
    if on_card and (not args.only or any(s in tag for s in args.only)):
        bld_host_breakdown(*shape)
    for tag, b, l, d, heads in TEXT_SHAPES:
        if not args.only or any(s in tag for s in args.only):
            bench_text(tag, b if on_card else 2, l, d, heads, on_card, args.device, args.iters)
    if not args.only or any(s in "whole-block" for s in args.only):
        bench_whole_block(on_card, args.device, args.iters)
    if args.sass and on_card:
        # the mangled names' template arguments: the tensor-core kernel is
        # instantiated for K1 and K6 (Packed) and for K8 (Strided)
        dh = A.MHA_TC_HEAD_DIM
        for parts in ((f"mha_tc_kernelILi{dh}E", "Packed"), (f"mha_tc_kernelILi{dh}E", "Strided"),
                      (f"blocked_dq_tc_kernelILi{dh}E",), (f"blocked_dkv_tc_kernelILi{dh}E",),
                      (f"mha_tf32_kernelILi{dh}E",), (f"blocked_dq_tf32_kernelILi{dh}E",),
                      (f"blocked_dkv_tf32_kernelILi{dh}E",), ("mha_whole_tf32_bwd_kernel",)):
            whole, loops = sass_mix(*parts)
            kernel = " ".join(parts)
            mixes = [("kernel", whole), *((f"loop {i + 1}", mix) for i, mix in enumerate(loops))]
            for what, mix in mixes:
                top = ", ".join(f"{op} {n}" for op, n in mix.most_common(12))
                print(f"sass, {kernel}, {what}: {sum(mix.values())} operations: {top}", flush=True)


if __name__ == "__main__":
    main()
