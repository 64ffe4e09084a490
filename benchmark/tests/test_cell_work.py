"""The FLOP and attention-work counts against hand counts."""

from __future__ import annotations

import pytest

from benchmark import work
from benchmark.cells import load_config, load_tower

B16 = load_config("ucfcrime-vitb16")
L14 = load_config("ucfcrime-vitl14-336")
VIT = load_tower("vit")


def test_vit_b16_flops_per_frame():
    # per layer, 197 tokens of width 768: qkv 3d^2, out d^2, fc 4d^2, proj 4d^2 -> 2*197*12*768^2,
    # attention q k^T and p v -> 4*197^2*768; 12 layers; patch embedding 196 x 768 x 768; projection 768 x 512
    layer = 2 * 197 * 7_077_888 + 4 * 197**2 * 768
    assert layer == 2_907_909_120
    expected = 12 * layer + 2 * 196 * 768 * 768 + 2 * 768 * 512
    assert VIT.flops_per_frame(B16["clip"]) == expected == 35_126_906_880


def test_vit_l14_336_flops_per_frame():
    tokens, width = 577, 1024
    layer = 2 * tokens * 12 * width**2 + 4 * tokens**2 * width
    expected = 24 * layer + 2 * 576 * (3 * 14 * 14) * width + 2 * width * 768
    assert VIT.flops_per_frame(L14["clip"]) == expected


def test_head_flops_per_grid():
    selector = 2 * 512 * 512 * 13
    projection = 2 * 512 * 512 * 256
    attention_projections = 2 * 4 * (2 * 512 * 256 * 256)  # two modules of q, k, v, out
    products = 16 * 4 * 32 * 32 * 256 + 32 * 4 * 16 * 16 * 256
    convs = 4 * 2 * 512 * 9 * 256 * 1024
    score_head = 2 * 512 * 256
    expected = selector + projection + attention_projections + products + convs + score_head
    assert work.head_flops_per_grid(B16) == expected == 10_367_008_768


def test_clip_grids():
    assert [work.clip_grids(n, B16) for n in (1, 512, 513, 1024, 1536, 1537, 7247)] == [1, 1, 2, 2, 3, 4, 15]


def test_reference_chunks():
    # fp32 scores of a frame: heads x L^2 x 4 bytes, 1 GiB at once
    assert VIT.reference_chunk(B16["clip"]) == 2**30 // (4 * 12 * 197**2) == 576
    assert VIT.reference_chunk(L14["clip"]) == 2**30 // (4 * 16 * 577**2) == 50


def test_attention_bounds():
    # K1 at (256, 12, 197, 64) bf16: 4 tensors of 2 bytes over 3.35 TB/s beat 4*B*H*L^2*dh FLOPs over 989 TFLOP/s
    nbytes = 2 * 4 * 256 * 12 * 197 * 64
    assert work.attention_bound_s("fwd", (256, 12, 197, 64), "bfloat16") == pytest.approx(nbytes / 3.35e12)
    assert nbytes / 3.35e12 == pytest.approx(92.49e-6, rel=1e-3)
    # fp32 at (64, 16, 400, 64): the FLOPs bind, over 495/3 TFLOP/s
    flops = 4 * 64 * 16 * 400**2 * 64
    assert work.attention_bound_s("fwd", (64, 16, 400, 64), "float32") == pytest.approx(flops / 165e12)
    # causal halves the FLOPs; the backward reads and writes 7 tensors for 10 FLOPs a pair
    causal = work.attention_bound_s("bwd", (14, 8, 77, 64), "float32", causal=True)
    assert causal == pytest.approx(max(10 * 14 * 8 * 77**2 * 64 * 0.5 / 165e12, 4 * 7 * 14 * 8 * 77 * 64 / 3.35e12))
    per_frame = VIT.attention_bound_s(B16["clip"], 1, "bfloat16")
    assert per_frame == pytest.approx(12 * 92.49e-6 / 256, rel=1e-3)


def test_train_step_flops():
    text = 14 * (12 * (2 * 77 * 12 * 512**2 + 4 * 77**2 * 512 * 0.5) + 2 * 512 * 512)
    assert work.text_flops(B16["clip"], 14) == pytest.approx(text)
    assert work.train_step_flops(B16, 64) == pytest.approx(2 * text + 3 * 64 * 10_367_008_768)
