"""Isolated attention at the ViT-L/14@336px per-layer shape (B=32, L=577, D=1024,
16 heads of 64, bf16) on the card, and the whole-tower ablation.

    python -m anomalyclip_tpu_torch.scripts.bench_attn_l14 [--variants qtile,twopass,...]
        [--iters 30] [--check] [--seq L] [--device cpu]
    python -m anomalyclip_tpu_torch.scripts.bench_attn_l14 --tower [--arch l14|l14@336]

The counterpart of the JAX package's scripts/bench_attn_l14.py, variant names
kept. On the card ``fused_mha_qtile`` (K6) launches, in bf16, the tensor-core
kernel of ops/csrc/mha_tc.cu: one block per batch entry, head and 64-row q tile,
4 warps of 16 rows each, K and V in 64-key blocks through two cp.async stages
(shared memory independent of L). Every other variant is a probe
(ops/csrc/mha_probe.cu) that runs that kernel's arithmetic with one of its
choices made free, so each is a measured departure from the kernel the paths
run; at K6's own block the tile probe gives its bits. What the TPU's axes
became: ``lq<N>`` is N query rows per block (64 where not given), cut into
16-row mma tiles (577 is prime: the last tile of a head is masked);
``gb<g>``, the batch group, is 4 g warps per block (g 1, 2 or 4; 4 warps where
not given, 8 for ``pair``): on the TPU it sets how many query rows a program
holds at a time, which here is one 16-row tile per warp; ``resident`` stages K
and V of the head once a block, as the TPU keeps them in VMEM (a longer q tile
reuses them more; shared memory grows with L), ``streamed`` brings them in
64-key blocks as K6 does.

Variants:
  qtile                       the shipped fused_mha_qtile (baseline)
  qtile-lq<N>                 the tile probe at N rows per block
  qtilegb<g>[-lq<N>]          ... and 4 g warps per block
  ...-resident, ...-streamed  ... with K and V of the head resident (the TPU's
                              form) or streamed (K6's, the default)
  twopass[-gb<g>[-lq<N>]]     K and V staged in two halves of ceil(L/2) keys, each
                              swept in 64-key steps, fp32 row state (max, sum,
                              accumulator) carried across them
  pair[-gb<g>[-lq<N>]]        two neighbouring heads per block, half the warps on
                              each, their 128 contiguous columns of a K or V row
                              staged together, in the fewest KV parts that fit a
                              block (2 at L=577 in bf16), with twopass's row state
  whole[-gb<g>][-streamed]    no q tiling: one block per batch entry and head, K
                              and V resident unless asked otherwise
  nosoftmax[gb<g>][-lq<N>]    the tile probe with the softmax compiled out:
                              staging and the two products alone
  plain                       the plain PyTorch formulation

Each line gives the median time (CUDA events), the device time
(``_bench_util.device_ms``) and the ratio of the device time to the shipped
kernel's at the same shape, timed first (at 0.2-0.5 ms a call the event time is
the host's enqueue, which moves 20% between runs of one kernel), and, for a
probe, the shared memory of a block and the blocks one SM holds. ``--check`` first holds each variant within
0.05 (absolute) of the plain version on fp32 inputs (nosoftmax: of its own plain
version). A variant whose shared memory does not fit is reported with the bytes
it needs and was given and the sweep goes on; any other failure ends the
script. ``--seq`` runs the same B, D and heads at another L (576 and 640 split
what the ragged last tile costs from the rest).

``--tower`` times the whole image tower in bf16 under three attentions: the
fused kernels, identity attention (``out = v``, both projections kept: what the
tower costs without the attention core) and the plain formulation. ``fused -
identity`` over the layers is the kernel's marginal cost in the tower, and
``identity + layers x dot floor`` the ceiling a perfect kernel would reach,
where the dot floor is the two products' 4 B L^2 D operations at the H100's
dense bf16 peak of 989 TFLOP/s, with no derate.

``--device cpu`` runs the plain versions at batch 2 (the tower at the tiny
test width) and prints no times.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses

import numpy as np
import torch

from anomalyclip_tpu_torch.convert import tree_to
from anomalyclip_tpu_torch.models.clip import model as clip_model
from anomalyclip_tpu_torch.ops import attention as A
from anomalyclip_tpu_torch.ops import attention_probes as P
from anomalyclip_tpu_torch.scripts._bench_util import announce_device, both_clocks, format_ms, median_ms, versus
from anomalyclip_tpu_torch.scripts.probe_qtile_vmem import B, D, H, L, inputs

DEFAULT_VARIANTS = "qtile,qtile-lq120,qtile-lq120-resident,twopass,nosoftmax"
CHECK_LIMIT = 0.05  # absolute, against the plain version on fp32 inputs
H100_BF16_PEAK = 989e12  # dense FLOP/s: what the tower's dot floor is taken against


@dataclasses.dataclass
class Variant:
    run: object  # f(q, kv) -> (B, L, D)
    plain: object = A.mha_qtile_reference  # what --check holds it against, on fp32 inputs
    smem: object = None  # f(q) -> bytes per block, for a probe
    blocks: object = None  # f(q) -> blocks per SM (on the card)


def _warps(group: str, name: str) -> int:
    g = int(group)
    if g not in (1, 2, 4):
        raise SystemExit(f"{name}: gb{g}: the probes run 4 g warps per block for g in 1, 2, 4")
    return 4 * g


def _tiling(name: str, parts: list, warps: int, residency: str) -> tuple:
    """[..., "gb<g>", "lq<N>", "resident" | "streamed"] after a variant's stem ->
    (rows, warps, residency), from the shipped block and the stem's defaults."""
    rows = P.SHIPPED["rows"]
    for part in parts:
        if part.startswith("gb"):
            warps = _warps(part[2:], name)
        elif part.startswith("lq"):
            rows = int(part[2:])
        elif part in P.RESIDENCIES:
            residency = part
        else:
            raise SystemExit(f"unknown variant {name}")
    return rows, warps, residency


def make_variant(name: str) -> Variant:
    """The variant ``name`` as functions of (q (B, L, D), kv (B, L, 2D))."""
    stem, *rest = name.split("-")
    if name == "qtile":
        return Variant(lambda q, kv: A.fused_mha_qtile(q, kv, H))
    if name == "plain":
        return Variant(lambda q, kv: A.mha_qtile_reference(q, kv, H))
    if stem.startswith("qtilegb"):
        stem, rest = "qtile", [stem[len("qtile"):], *rest]
    elif stem.startswith("nosoftmaxgb"):
        stem, rest = "nosoftmax", [stem[len("nosoftmax"):], *rest]
    if stem not in ("qtile", "twopass", "pair", "whole", "nosoftmax"):
        raise SystemExit(f"unknown variant {name}")
    warps = 8 if stem == "pair" else P.SHIPPED["warps"]
    residency = "resident" if stem == "whole" else P.SHIPPED["residency"]
    rows, warps, residency = _tiling(name, rest, warps, residency)
    if stem in ("twopass", "pair") and any(p in P.RESIDENCIES for p in rest):
        raise SystemExit(f"{name}: {stem} stages K and V in KV parts, not resident or streamed")
    if stem == "whole" and any(p.startswith("lq") for p in rest):
        raise SystemExit(f"{name}: whole has no q tiling")

    def tile_smem(q):
        return P.tile_smem_bytes(q.shape[1], P.PROBE_HEAD_DIM, q.element_size(), warps, residency)

    if stem == "qtile":
        return Variant(
            lambda q, kv: P.probe_mha_qtile(q, kv, H, rows=rows, warps=warps, residency=residency),
            smem=tile_smem,
            blocks=lambda q: P.probe_blocks_per_sm(q.dtype, q.shape[1], warps, residency),
        )
    if stem == "nosoftmax":
        return Variant(
            lambda q, kv: P.nosoftmax_mha(q, kv, H, rows=rows, warps=warps, residency=residency),
            plain=P.nosoftmax_reference, smem=tile_smem,
            blocks=lambda q: P.probe_blocks_per_sm(q.dtype, q.shape[1], warps, residency, softmax=False),
        )
    if stem == "whole":
        return Variant(
            lambda q, kv: P.probe_mha_whole(q, kv[..., :D], kv[..., D:], H, warps=warps, residency=residency),
            smem=tile_smem,
            blocks=lambda q: P.probe_blocks_per_sm(q.dtype, q.shape[1], warps, residency),
        )

    heads = 1 if stem == "twopass" else 2

    def part_length(q):
        parts = 2 if stem == "twopass" else P.pair_parts(q, rows, warps)
        return P.kv_part_length(q.shape[1], parts)

    def part_smem(q):
        return P.parts_smem_bytes(rows, part_length(q), P.PROBE_HEAD_DIM, q.element_size(), warps, heads)

    def part_blocks(q):
        return P.parts_blocks_per_sm(q.dtype, rows, part_length(q), warps, heads)

    if stem == "twopass":
        run = lambda q, kv: P.twopass_mha(q, kv, H, parts=2, rows=rows, warps=warps)  # noqa: E731
    else:
        run = lambda q, kv: P.pair_mha(q, kv, H, rows=rows, warps=warps)  # noqa: E731
    return Variant(run, smem=part_smem, blocks=part_blocks)


def bench_variants(names, seq: int, iters: int, check: bool, device: str, on_card: bool) -> None:
    q, kv = inputs(B if on_card else 2, seq, device)
    q32, kv32 = q.float(), kv.float()
    shipped_ms = None
    if on_card:
        event_ms, shipped_ms = both_clocks(lambda: A.fused_mha_qtile(q, kv, H), iters)
        print(f"{'shipped':18s} {event_ms:7.3f} ms/layer, device {format_ms(shipped_ms)} (fused_mha_qtile, "
              f"K6's block)", flush=True)
    for name in names:
        variant = make_variant(name)
        try:
            got = variant.run(q, kv)
        except P.ProbeDoesNotFit as exc:
            print(f"{name:18s} does not fit: needs {exc.need} B of shared memory per block, "
                  f"given {exc.have} B", flush=True)
            continue
        line = f"{name:18s}"
        if check:
            err = (got.float() - variant.plain(q32, kv32, H).float()).abs().max().item()
            if not err < CHECK_LIMIT:
                raise AssertionError(f"{name}: max err {err} against the plain version")
            line += f" max|diff| {err:.2e}"
        if on_card:
            event_ms, ms = both_clocks(lambda: variant.run(q, kv), iters)
            line += f" {event_ms:7.3f} ms/layer, device {format_ms(ms)}, {versus(ms, shipped_ms)} the shipped"
            if variant.smem is not None:
                line += f"  [{variant.smem(q)} B/block, {variant.blocks(q)} blocks/SM]"
        print(line, flush=True)


# ---------------------------------------------------------------------------
# the whole-tower ablation
# ---------------------------------------------------------------------------


def identity_mha(x, attn, num_heads, causal=False):
    """``multi_head_attention`` with the attention core replaced by ``out = v``:
    the same projections (the two GEMMs of the qtile rung where that rung is
    the shape's, v being the second half of the packed k|v), then the out
    projection."""
    b, l, d = x.shape
    rung = clip_model.attention_rung(b, l, d, num_heads, x.element_size(), causal,
                                     A.smem_limit(x.device))
    if rung == "qtile":
        _ = x @ attn["qkv_w"][:, :d] + attn["qkv_b"][:d]
        v = (x @ attn["qkv_w"][:, d:] + attn["qkv_b"][d:])[..., d:]
    else:
        v = (x @ attn["qkv_w"] + attn["qkv_b"])[..., 2 * d:]
    return v @ attn["out_w"] + attn["out_b"]


@contextlib.contextmanager
def tower_attention(mode: str):
    """The attention the CLIP towers run inside this scope: "fused" (the
    kernels, as shipped), "identity" (``identity_mha`` in place of
    ``models.clip.model.multi_head_attention``, put back on the way out) or
    "plain" (the plain PyTorch formulation)."""
    if mode == "fused":
        yield
    elif mode == "plain":
        with A.attention_impl("reference"):
            yield
    elif mode == "identity":
        real = clip_model.multi_head_attention
        clip_model.multi_head_attention = identity_mha
        try:
            yield
        finally:
            clip_model.multi_head_attention = real
    else:
        raise ValueError(f"tower_attention: mode {mode!r} is not fused, identity or plain")


def tower_ablation(iters: int, arch: str, device: str, on_card: bool) -> dict:
    """The image tower of ``arch`` in bf16 under the three attentions -> per
    attention, (ms per forward, the kernel launches it made, by entry). On the
    CPU the towers run once at the tiny width in fp32 and the time is None."""
    if not on_card:
        cfg, batch, dtype = clip_model.CLIPConfig.tiny(), 2, torch.float32
    elif arch == "l14":
        cfg, batch, dtype = clip_model.CLIPConfig.vit_l14(), 64, torch.bfloat16
    else:
        cfg, batch, dtype = clip_model.CLIPConfig.vit_l14_336(), 32, torch.bfloat16
    img = cfg.image_resolution
    seq = cfg.grid_size**2 + 1
    params = clip_model.init_clip_params(torch.Generator().manual_seed(0), cfg)
    params = {"visual": tree_to(clip_model.cast_tree(params["visual"], dtype), device)}
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal((batch, img, img, 3)).astype(np.float32))
    frames = frames.to(device=device, dtype=dtype)

    def forward():
        with torch.no_grad():
            return clip_model.encode_image(params, cfg, frames, compute_dtype=dtype)

    times, report = {}, {}
    for mode in ("fused", "identity", "plain"):
        before = dict(A.launch_counts)
        with tower_attention(mode):
            out = forward()
            if out.shape != (batch, cfg.embed_dim) or not bool(torch.isfinite(out.float()).all()):
                raise AssertionError(f"tower({mode}): features {tuple(out.shape)} not finite or misshapen")
            times[mode] = median_ms(forward, iters) if on_card else None
        report[mode] = (times[mode], {k: n - before[k] for k, n in A.launch_counts.items()})
        if on_card:
            ms = times[mode]
            print(f"tower({mode}){'':{10 - len(mode)}s} {ms:8.2f} ms/iter  {batch / ms * 1e3:6.1f} fps",
                  flush=True)
        else:
            print(f"tower({mode}): features {tuple(out.shape)} finite", flush=True)
    if on_card:
        layers, width = cfg.vision_layers, cfg.vision_width
        marginal = (times["fused"] - times["identity"]) / layers
        # the two products (QK^T and PV) of one layer at this batch: 4 B L^2 D
        # operations, at the H100's dense bf16 tensor-core peak, not derated
        dot_floor = 4 * batch * seq * seq * width / H100_BF16_PEAK * 1e3
        perfect = times["identity"] + layers * dot_floor
        print(f"attention marginal: {marginal:0.3f} ms/layer (dot floor {dot_floor:0.4f} at "
              f"{H100_BF16_PEAK / 1e12:.0f} TFLOP/s, the H100's dense bf16 peak, no derate); "
              f"perfect-kernel ceiling {perfect:0.2f} ms/iter = {batch / perfect * 1e3:0.1f} fps",
              flush=True)
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=DEFAULT_VARIANTS)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--check", action="store_true", help="hold each variant against the plain version first")
    ap.add_argument("--tower", action="store_true", help="the whole-tower ablation")
    ap.add_argument("--arch", default="l14@336", choices=("l14", "l14@336"),
                    help="the tower of --tower (the isolated variants are ViT-L/14@336px's)")
    ap.add_argument("--seq", type=int, default=L,
                    help="L of the isolated variants: the same B, D and heads at another "
                         "length (576, 640) split the ragged last tile's cost from the rest")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: the plain versions at batch 2 (the tower at the tiny width), no times")
    args = ap.parse_args(argv)
    on_card = announce_device("bench_attn_l14", args.device, "plain versions at batch 2; no times")
    if args.tower:
        tower_ablation(max(5, args.iters // 3), args.arch, args.device, on_card)
        return
    names = [n.strip() for n in args.variants.split(",")]
    bench_variants(names, args.seq, args.iters, args.check, args.device, on_card)


if __name__ == "__main__":
    main()
