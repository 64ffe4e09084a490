"""The tensor-core KV-blocked backward pair (ops/csrc/mha_tc_bwd.cu) behind K7,
K9, K10 and the KV-blocked route of K3, K4 and K5's backward in bf16 at head dim
64, and the routing around it.

On the CPU:

- which pair a backward launches is a pure function of operand type and head dim
  (``mha_tc_eligible``), and the measurement script names the same source
  (``bench_attn_bwd.served_by``);
- the pair's shared memory against hand-computed bytes;
- the wrappers' Python with the library replaced by numpy: both pairs' entries,
  in fp32 and in bf16 (operands read as uint16 through the raw pointers and
  (batch, head, row) strides the wrappers pass and widened, P and dS rounded to
  bf16 where the kernels round, gradients written back as bf16), so that K7's
  in-place reads and writes, the statistics handed from the dq launch to the dkv
  launch, K9 and K10's absent row sum, the causal argument, the choice of pair
  and the route count are held without a card;
- a bf16 view that cannot be read in 16-byte pieces raises before any launch,
  with the forward's sentence.

The plain backwards these are held against are tied to the JAX package by
tests/test_torch_long_attention_bwd.py (the Pallas kernels in interpret mode).

The ``gpu`` cases hold the pair against the plain backwards on the card, at the
ragged edges of its tiles, with the causal mask, and to the bit between two
launches; they import no JAX.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from anomalyclip_tpu_torch.ops import attention as tattn
from anomalyclip_tpu_torch.scripts import bench_attn_bwd

FP32_TOL = 1e-5
# the numpy library rounds where the kernels round, so it differs from the plain
# backward by the order of fp32 sums and, through them, by single bf16 steps of
# single elements (2^-8 of the element)
BF16_STANDIN_TOL = 1e-2
# the kernels against the plain backwards on the card, of max|ref|: twice the
# largest gap measured over the chip smoke run's cases
BF16_CARD_TOL = 7e-3


# ---------------------------------------------------------------------------
# which pair, and what it needs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "dtype,dh,source",
    [
        (torch.bfloat16, 64, "mha_tc_bwd.cu"),
        # fp32 on the tensor cores as split-TF32 products: TF32 itself stays off
        (torch.float32, 64, "mha_tf32_bwd.cu"),
        (torch.bfloat16, 32, "mha_blocked_bwd.cu"),
        (torch.bfloat16, 16, "mha_blocked_bwd.cu"),
        (torch.bfloat16, 8, "mha_blocked_bwd.cu"),
        (torch.float32, 8, "mha_blocked_bwd.cu"),
        (torch.float16, 64, "mha_blocked_bwd.cu"),  # no kernel takes it; the wrappers raise
    ],
)
def test_which_pair_serves_a_backward_is_a_pure_function(dtype, dh, source):
    assert tattn.mha_tc_eligible(dtype, dh) is (source == "mha_tc_bwd.cu")
    assert tattn.mha_tf32_eligible(dtype, dh) is (source == "mha_tf32_bwd.cu")
    assert tattn._blocked_pair(dtype, dh) == {"mha_tc_bwd.cu": "tc", "mha_tf32_bwd.cu": "tf32"}.get(
        source, "cuda")
    assert bench_attn_bwd.served_by(dtype, dh) == bench_attn_bwd.served_by(dtype, dh, "blocked") == source
    assert bench_attn_bwd.served_by(dtype, dh, "whole") == "mha_bwd.cu"


@pytest.mark.parametrize("l,itemsize", [(197, 2), (577, 2), (118, 2), (2048, 2)])
def test_the_route_stays_blocked_whichever_pair_serves_it(l, itemsize):
    """``attention_bwd_route`` admits by the CUDA-core pair's shared memory in
    bf16 too; which pair serves the route is the wrapper's choice."""
    assert tattn.attention_bwd_route(l, 64, itemsize) == "blocked"
    assert tattn.blocked_bwd_tc_smem_bytes() < tattn.blocked_bwd_smem_bytes(64, itemsize)


def test_tc_backward_shared_memory_against_hand_computed_bytes():
    row = 2 * (64 + 8)  # a staged bf16 row of head dim 64, padded by 16 bytes
    tiles = 64 * row  # one 64-row tile
    # dq: the q and g tiles, two stages of a K and a V block
    assert tattn.blocked_bwd_tc_smem_bytes(64, "dq") == (2 + 2 * 2) * tiles == 55_296
    # dkv: the K and V block, two stages of a q and a g tile, and per stage 64
    # fp32 log-sum-exps and 64 deltas
    assert tattn.blocked_bwd_tc_smem_bytes(64, "dkv") == (2 + 2 * 2) * tiles + 2 * 2 * 64 * 4 == 56_320
    assert tattn.blocked_bwd_tc_smem_bytes() == 56_320  # what the wrappers ask the card for
    # three blocks an SM, each with the 1 KB the card reserves, within its 228 KB
    assert 3 * (56_320 + 1024) <= 233_472
    with pytest.raises(KeyError):
        tattn.blocked_bwd_tc_smem_bytes(64, "dk")


# ---------------------------------------------------------------------------
# the wrappers' Python, the library replaced by numpy
# ---------------------------------------------------------------------------


def _bf16_round(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).bfloat16().float().numpy()


class NumpyBackwardPairs:
    """The six entries of ops/csrc/mha_blocked_bwd.cu, mha_tc_bwd.cu and
    mha_tf32_bwd.cu in numpy:
    their arithmetic without their tiling, on operands decoded from the raw
    pointers and (batch, head, row) element strides the wrappers pass, so that a
    wrong view, stride, output layout, statistic or choice of pair shows."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _raw(address, strides, shape, ctype):
        steps = (*strides, 1)
        span = 1 + sum((n - 1) * s for n, s in zip(shape, steps))
        flat = np.ctypeslib.as_array(ctypes.cast(address, ctypes.POINTER(ctype)), (span,))
        size = ctypes.sizeof(ctype)
        return np.lib.stride_tricks.as_strided(flat, shape, [size * s for s in steps])

    def _tensors(self, ptrs, strides, count, shape, bf16):
        """-> (fp32 copies of the operands, the raw views to write through)"""
        ctype = ctypes.c_uint16 if bf16 else ctypes.c_float
        raw = [self._raw(ptrs[i], [strides[3 * i + j] for j in range(3)], shape, ctype)
               for i in range(count)]
        if not bf16:
            return [r.copy() for r in raw], raw
        return [(r.astype(np.uint32) << 16).view(np.float32) for r in raw], raw

    @staticmethod
    def _write(raw, values, bf16):
        if not bf16:
            raw[...] = values
            return
        bits = torch.from_numpy(np.ascontiguousarray(values, dtype=np.float32)).bfloat16()
        raw[...] = bits.view(torch.int16).numpy().view(np.uint16)

    @staticmethod
    def _stat(pointer, shape):
        if pointer.value is None:
            return None
        return np.ctypeslib.as_array(ctypes.cast(pointer, ctypes.POINTER(ctypes.c_float)), shape)

    @staticmethod
    def _scores(q, k, causal, scale):
        s = np.einsum("bhqd,bhkd->bhqk", q, k) * scale
        seq = q.shape[2]
        return np.where(np.tril(np.ones((seq, seq), bool)), s, -1e30) if causal else s

    def _p_and_ds(self, q, k, v, g, m, l, delta, causal, scale, bf16):
        s = self._scores(q, k, causal, scale)
        p = np.exp(s - m[..., None]) / (1.0 if l is None else l[..., None])
        ds = p * (np.einsum("bhqd,bhkd->bhqk", g, v) - delta[..., None]) * scale
        return (_bf16_round(p), _bf16_round(ds)) if bf16 else (p, ds)

    def _dq(self, tag, bf16, ptrs, strides, m, l, delta, recompute, shape, causal, scale, lse_only):
        self.calls.append(tag + (" causal" if causal else ""))
        (q, k, v, g, _), raw = self._tensors(ptrs, strides, 5, shape, bf16)
        m, l, delta = (self._stat(t, shape[:3]) for t in (m, l, delta))
        if recompute:
            s = self._scores(q, k, causal, scale)
            top = s.max(axis=-1)
            e = np.exp(s - top[..., None])
            total = e.sum(axis=-1)
            delta[...] = (e / total[..., None] * np.einsum("bhqd,bhkd->bhqk", g, v)).sum(axis=-1)
            if lse_only:  # the tensor-core pair hands over the log-sum-exp alone
                m[...] = top + np.log(total)
            else:
                m[...], l[...] = top, total
        _, ds = self._p_and_ds(q, k, v, g, m, l, delta, causal, scale, bf16)
        self._write(raw[4], np.einsum("bhqk,bhkd->bhqd", ds, k), bf16)
        return 0

    def _dkv(self, tag, bf16, ptrs, strides, m, l, delta, shape, causal, scale):
        self.calls.append(tag + (" causal" if causal else ""))
        (q, k, v, g, _, _), raw = self._tensors(ptrs, strides, 6, shape, bf16)
        m, l, delta = (self._stat(t, shape[:3]) for t in (m, l, delta))
        p, ds = self._p_and_ds(q, k, v, g, m, l, delta, causal, scale, bf16)
        self._write(raw[4], np.einsum("bhqk,bhqd->bhkd", ds, q), bf16)
        self._write(raw[5], np.einsum("bhqk,bhqd->bhkd", p, g), bf16)
        return 0

    def acl_blocked_dq(self, dtype, ptrs, strides, m, l, delta, recompute, b, h, seq, dh, causal, scale,
                       stream):
        return self._dq(f"dq {('fp32', 'bf16')[dtype]} dh{dh}", dtype == 1, ptrs, strides, m, l, delta,
                        recompute, (b, h, seq, dh), causal, scale, False)

    def acl_blocked_dkv(self, dtype, ptrs, strides, m, l, delta, b, h, seq, dh, causal, scale, stream):
        return self._dkv(f"dkv {('fp32', 'bf16')[dtype]} dh{dh}", dtype == 1, ptrs, strides, m, l, delta,
                         (b, h, seq, dh), causal, scale)

    def acl_blocked_dq_tc(self, ptrs, strides, lse, delta, recompute, b, h, seq, dh, causal, scale, stream):
        assert dh == 64
        return self._dq("dq_tc", True, ptrs, strides, lse, ctypes.c_void_p(None), delta, recompute,
                        (b, h, seq, dh), causal, scale, True)

    def acl_blocked_dkv_tc(self, ptrs, strides, lse, delta, b, h, seq, dh, causal, scale, stream):
        assert dh == 64
        return self._dkv("dkv_tc", True, ptrs, strides, lse, ctypes.c_void_p(None), delta,
                         (b, h, seq, dh), causal, scale)

    def acl_blocked_dq_tf32(self, ptrs, strides, lse, delta, recompute, b, h, seq, dh, causal, scale,
                            stream):
        assert dh == 64
        return self._dq("dq_tf32", False, ptrs, strides, lse, ctypes.c_void_p(None), delta, recompute,
                        (b, h, seq, dh), causal, scale, True)

    def acl_blocked_dkv_tf32(self, ptrs, strides, lse, delta, b, h, seq, dh, causal, scale, stream):
        assert dh == 64
        return self._dkv("dkv_tf32", False, ptrs, strides, lse, ctypes.c_void_p(None), delta,
                         (b, h, seq, dh), causal, scale)


class _AsCuda:
    """A CPU tensor that says it is on the card, for the wrappers' shape checks."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda")

    def __getattr__(self, name):
        return getattr(self._t, name)


@pytest.fixture
def numpy_kernels(monkeypatch):
    """The kernel launches on CPU tensors: the library in numpy; the device check,
    the card's limit (an H100's) and the stream lookup out of the way."""
    fake = NumpyBackwardPairs()
    monkeypatch.setattr(tattn, "load_library", lambda: fake)
    monkeypatch.setattr(tattn, "_stream", lambda t: None)
    monkeypatch.setattr(tattn, "smem_limit", lambda device: tattn.H100_SMEM_OPTIN)
    real_check = tattn._check_kernel_shape
    monkeypatch.setattr(tattn, "_check_kernel_shape",
                        lambda name, t, *args: real_check(name, _AsCuda(t), *args))
    tattn.reset_launch_counts()
    return fake


def _randn(rng, dtype, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _all_close(got, want, dtype):
    tol = FP32_TOL if dtype == torch.float32 else BF16_STANDIN_TOL
    top = max(w.float().abs().max().item() for w in want)
    for ours, theirs in zip(got, want):
        assert ours.dtype == dtype and ours.shape == theirs.shape
        torch.testing.assert_close(ours.float(), theirs.float(), rtol=0, atol=tol * top)


def _counts(**expected):
    return {k: expected.get(k, 0) for k in tattn.launch_counts}


def _expected_calls(dtype, dh, causal=False):
    tail = " causal" if causal else ""
    if tattn.mha_tc_eligible(dtype, dh):
        return [f"dq_tc{tail}", f"dkv_tc{tail}"]
    if tattn.mha_tf32_eligible(dtype, dh):
        return [f"dq_tf32{tail}", f"dkv_tf32{tail}"]
    name = "fp32" if dtype == torch.float32 else "bf16"
    return [f"dq {name} dh{dh}{tail}", f"dkv {name} dh{dh}{tail}"]


# dtype, heads over 128 columns: head dims 64, 64, 32, 16
_PAIR_CASES = [(torch.bfloat16, 2), (torch.float32, 2), (torch.bfloat16, 4), (torch.bfloat16, 8)]


@pytest.mark.parametrize("dtype,heads", _PAIR_CASES)
def test_qtile_bwd_wrapper_reads_and_writes_in_place(numpy_kernels, dtype, heads):
    """K7: q and kv as column slices of one packed tensor, dk|dv written into the
    two halves of one (B, L, 2D) tensor; at head dim 64 the tensor-core pair in
    bf16 and the split-TF32 pair in fp32, and the statistics of the dq launch
    read by the dkv launch."""
    rng = np.random.default_rng(30)
    x, g = _randn(rng, dtype, 2, 150, 3 * 128), _randn(rng, dtype, 2, 150, 128)
    q, kv = x[..., :128], x[..., 128:]
    dq, dkv = tattn.mha_qtile_bwd_kernel(q, kv, g, heads)
    assert dkv.shape == (2, 150, 256) and dkv.is_contiguous() and dq.is_contiguous()
    _all_close((dq, dkv), tattn.mha_qtile_bwd_reference(q, kv, g, heads), dtype)
    assert numpy_kernels.calls == _expected_calls(dtype, 128 // heads)
    assert tattn.launch_counts == _counts(mha_qtile_bwd=1)
    tc, tf32 = (int(numpy_kernels.calls[0] == call) for call in ("dq_tc", "dq_tf32"))
    assert tattn.route_counts == {"mha_tc": 0, "blocked_bwd_tc": tc, "mha_tf32": 0, "blocked_bwd_tf32": tf32,
                                  "bld_tf32": 0, "bld_bwd_tf32": 0, "whole_bwd_tf32": 0}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,heads", _PAIR_CASES)
def test_qkv_bwd_wrapper_takes_the_blocked_route_on_either_pair(numpy_kernels, dtype, heads, causal):
    """K3 past its whole-head kernel: a packed dqkv, the mask handed to both
    passes of whichever pair the operands launch."""
    rng = np.random.default_rng(31)
    qkv, g = _randn(rng, dtype, 2, 197, 3 * 128), _randn(rng, dtype, 2, 197, 128)
    got = tattn.mha_qkv_bwd_kernel(qkv, g, heads, causal)
    assert got.shape == qkv.shape and got.is_contiguous()
    _all_close([got], [tattn.mha_qkv_bwd_reference(qkv, g, heads, causal)], dtype)
    assert numpy_kernels.calls == _expected_calls(dtype, 128 // heads, causal)
    assert tattn.launch_counts == _counts(mha_qkv_bwd=1)
    assert tattn.route_counts["blocked_bwd_tc"] == int(tattn.mha_tc_eligible(dtype, 128 // heads))
    assert tattn.route_counts["blocked_bwd_tf32"] == int(tattn.mha_tf32_eligible(dtype, 128 // heads))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bld_and_fused_attention_bwd_wrappers_on_either_pair(numpy_kernels, dtype):
    """K4 past its whole-head kernel with k and v the halves of one kv, and K5's
    backward on (B, H, L, Dh) views of one packed projection, read as they are."""
    rng = np.random.default_rng(32)
    q, kv, g = _randn(rng, dtype, 2, 130, 64), _randn(rng, dtype, 2, 130, 128), _randn(rng, dtype, 2, 130, 64)
    got = tattn.mha_bld_bwd_kernel(q, kv[..., :64], kv[..., 64:], g, 1, True)
    _all_close(got, tattn.mha_bld_bwd_reference(q, kv[..., :64], kv[..., 64:], g, 1, True), dtype)
    packed = _randn(rng, dtype, 2, 197, 3, 2, 64)
    views = packed.permute(2, 0, 3, 1, 4)
    g4 = _randn(rng, dtype, 2, 2, 197, 64)
    got = tattn.fused_attention_bwd_kernel(*views, g4, False)
    assert all(t.shape == (2, 2, 197, 64) and t.is_contiguous() for t in got)
    _all_close(got, tattn.attention_bwd_reference(*views, g4, False), dtype)
    assert numpy_kernels.calls == _expected_calls(dtype, 64, True) + _expected_calls(dtype, 64)
    assert tattn.launch_counts == _counts(mha_bld_bwd=1, fused_attention=1)
    assert tattn.route_counts["blocked_bwd_tc"] == 2 * (dtype == torch.bfloat16)
    assert tattn.route_counts["blocked_bwd_tf32"] == 2 * (dtype == torch.float32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,dh", [(torch.bfloat16, 64), (torch.float32, 64), (torch.bfloat16, 32)])
def test_flash_bwd_wrapper_hands_over_the_log_sum_exp_and_no_row_sum(numpy_kernels, dtype, dh, causal):
    """K9 and K10 over per-head (N, L, dh): the forward's log-sum-exp as m, no
    row sum, delta from the rounded output; one launch, one count and, on the
    tensor-core pair, one route each."""
    rng = np.random.default_rng(33)
    q, k, v, g = (_randn(rng, dtype, 3, 150, dh) for _ in range(4))
    out, lse = tattn.flash_attention_reference(q, k, v, save_lse=True, causal=causal)
    got = tattn.flash_bwd_kernel(q, k, v, g, lse, out, causal)
    _all_close(got, tattn.flash_attention_bwd_reference(q, k, v, g, lse, out, causal), dtype)
    assert numpy_kernels.calls == _expected_calls(dtype, dh, causal)
    assert tattn.launch_counts == _counts(flash_dq=1, flash_dkv=1)
    tc, tf32 = 2 * tattn.mha_tc_eligible(dtype, dh), 2 * tattn.mha_tf32_eligible(dtype, dh)
    assert tattn.route_counts == {"mha_tc": 0, "blocked_bwd_tc": tc, "mha_tf32": 0, "blocked_bwd_tf32": tf32,
                                  "bld_tf32": 0, "bld_bwd_tf32": 0, "whole_bwd_tf32": 0}


def test_tc_pair_takes_no_row_sum(numpy_kernels):
    """Its statistics are the log-sum-exp and delta, as the split-TF32 pair's
    are: a caller that hands a row sum beside a row max is refused before the
    launch."""
    rng = np.random.default_rng(34)
    q, k, v, g = (_randn(rng, torch.bfloat16, 1, 1, 70, 64) for _ in range(4))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    m, l, delta = torch.zeros(3, 1, 1, 70)
    for operands in ((q, k, v, g), tuple(t.float() for t in (q, k, v, g))):
        grads = tuple(torch.empty_like(operands[0]) for _ in range(3))
        with pytest.raises(ValueError, match="takes the log-sum-exp, not m and l"):
            tattn._launch_blocked_dq("flash_dq", *operands, grads[0], m, l, delta, False, False)
        with pytest.raises(ValueError, match="takes the log-sum-exp, not m and l"):
            tattn._launch_blocked_dkv("flash_dkv", *operands, *grads[1:], m, l, delta, False)
    assert numpy_kernels.calls == []
    # the CUDA-core pair (here at head dim 32) takes all three
    tattn._launch_blocked_dq("flash_dq", *(t.float()[..., :32] for t in (q, k, v, g, dq)), m, l + 1, delta,
                             False, False)
    assert numpy_kernels.calls == ["dq fp32 dh32"]


def _one_element_in(rng, *shape):
    """A bf16 view one element into a wider buffer: neither its address nor its
    row stride is a multiple of 16 bytes."""
    return _randn(rng, torch.bfloat16, *shape[:-1], shape[-1] + 2)[..., 1:-1]


def test_tc_backward_refuses_operands_it_cannot_read_in_16_byte_pieces(numpy_kernels):
    """bf16 at head dim 64 raises the forward's sentence before any launch: the
    choice of pair is by operand type and head dim alone, and neither the
    CUDA-core pair nor a plain version stands behind the entries."""
    rng = np.random.default_rng(35)
    x, g = _one_element_in(rng, 2, 50, 3 * 128), _randn(rng, torch.bfloat16, 2, 50, 128)
    with pytest.raises(ValueError, match=r"mha_qtile_bwd: .*16-byte pieces; shape \(2, 2, 50, 64\)"):
        tattn.mha_qtile_bwd_kernel(x[..., :128], x[..., 128:], g, 2)
    with pytest.raises(ValueError, match="mha_qtile_bwd: .*16-byte pieces"):  # kv alone misaligned
        tattn.mha_qtile_bwd_kernel(x[..., :128].contiguous(), x[..., 128:], g, 2)
    q = _one_element_in(rng, 3, 70, 64)
    k, v, gg = (_randn(rng, torch.bfloat16, 3, 70, 64) for _ in range(3))
    stats = torch.zeros(3, 70)
    with pytest.raises(ValueError, match=r"flash_dq: .*16-byte pieces; shape \(3, 1, 70, 64\)"):
        tattn.flash_dq_kernel(q, k, v, gg, stats, stats)
    with pytest.raises(ValueError, match="flash_dkv: .*16-byte pieces"):
        tattn.flash_dkv_kernel(k, q, v, gg, stats, stats)
    assert numpy_kernels.calls == [] and tattn.launch_counts == _counts()
    assert tattn.route_counts == {"mha_tc": 0, "blocked_bwd_tc": 0, "mha_tf32": 0, "blocked_bwd_tf32": 0,
                                  "bld_tf32": 0, "bld_bwd_tf32": 0, "whole_bwd_tf32": 0}
    # aligned copies launch; head dim 32 takes any view, on the CUDA cores; fp32
    # copies at head dim 64 take the split-TF32 pair
    tattn.mha_qtile_bwd_kernel(x[..., :128].contiguous(), x[..., 128:].contiguous(), g, 2)
    tattn.mha_qtile_bwd_kernel(x[..., :128], x[..., 128:], g, 4)
    tattn.mha_qtile_bwd_kernel(x[..., :128].float(), x[..., 128:].float(), g.float(), 2)
    assert numpy_kernels.calls == ["dq_tc", "dkv_tc", "dq bf16 dh32", "dkv bf16 dh32",
                                   "dq_tf32", "dkv_tf32"]


def test_tc_backward_refuses_what_the_card_cannot_hold(numpy_kernels, monkeypatch):
    """The wrappers ask for the larger of the pair's two blocks."""
    rng = np.random.default_rng(36)
    q, kv, g = (_randn(rng, torch.bfloat16, 1, 70, d) for d in (64, 128, 64))
    monkeypatch.setattr(tattn, "smem_limit", lambda device: 56_320)
    tattn.mha_qtile_bwd_kernel(q, kv, g, 1)
    monkeypatch.setattr(tattn, "smem_limit", lambda device: 56_319)
    with pytest.raises(ValueError, match="needs 56320 B of shared memory per block, the card gives 56319"):
        tattn.mha_qtile_bwd_kernel(q, kv, g, 1)
    assert numpy_kernels.calls == ["dq_tc", "dkv_tc"]


@pytest.mark.parametrize("shape,causal", [((2, 2, 197, 64), True), ((1, 2, 577, 64), False)])
def test_autograd_through_the_entries_launches_the_tc_pair_in_bf16(numpy_kernels, monkeypatch, shape, causal):
    """``fused_attention``'s two branches in bf16 with the forwards on the CPU:
    the backward of the whole-block branch past the whole-head kernel, and K9
    and K10 behind the flash branch, reach the tensor-core pair."""
    rng = np.random.default_rng(37)
    inputs = [_randn(rng, torch.bfloat16, *shape).requires_grad_(True) for _ in range(3)]
    with tattn.attention_impl("reference"):
        want = torch.autograd.grad((tattn.fused_attention(*inputs, causal).float() ** 2).sum(), inputs)
    # the forwards by their plain versions, the backwards by the wrappers
    monkeypatch.setattr(tattn, "fused_attention_fwd_kernel", tattn.fused_attention_reference)
    monkeypatch.setattr(tattn, "flash_fwd_kernel",
                        lambda q, k, v, save_lse, causal=False: tattn.flash_attention_reference(
                            q, k, v, save_lse, causal=causal))
    monkeypatch.setattr(tattn, "_use_reference", lambda t: False)
    got = torch.autograd.grad((tattn.fused_attention(*inputs, causal).float() ** 2).sum(), inputs)
    _all_close(got, want, torch.bfloat16)
    assert numpy_kernels.calls == _expected_calls(torch.bfloat16, 64, causal)
    flash = shape[2] == 577
    assert tattn.route_counts["blocked_bwd_tc"] == (2 if flash else 1)
    assert tattn.launch_counts == (_counts(flash_dq=1, flash_dkv=1) if flash else _counts(fused_attention=1))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_close(got, want):
    """|got - want| <= BF16_CARD_TOL * max|want| over the tuple."""
    torch.cuda.synchronize()
    top = max(w.float().abs().max().item() for w in want)
    for ours, theirs in zip(got, want):
        assert bool(torch.isfinite(ours.float()).all())
        torch.testing.assert_close(ours.float(), theirs.float(), rtol=0, atol=BF16_CARD_TOL * top)


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,d,heads", [(32, 577, 1024, 16), (3, 1, 128, 2), (3, 63, 128, 2),
                                         (3, 64, 128, 2), (3, 65, 128, 2), (3, 129, 128, 2),
                                         (3, 1100, 128, 2)])
def test_tc_qtile_bwd_matches_plain_and_repeats_to_the_bit(cuda, b, l, d, heads):
    """K7 in bf16 at head dim 64, at the ViT-L/14@336px shape and at the ragged
    edges of its tiles; q and kv are views of one tensor."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(b, l, 3 * d, device=cuda, generator=gen).bfloat16()
    g = torch.randn(b, l, d, device=cuda, generator=gen).bfloat16()
    tattn.reset_launch_counts()
    got = tattn.mha_qtile_bwd_kernel(x[..., :d], x[..., d:], g, heads)
    again = tattn.mha_qtile_bwd_kernel(x[..., :d], x[..., d:], g, heads)
    assert tattn.launch_counts["mha_qtile_bwd"] == 2 and tattn.route_counts["blocked_bwd_tc"] == 2
    _card_close(got, tattn.mha_qtile_bwd_reference(x[..., :d], x[..., d:], g, heads))
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("n,l,causal", [(512, 577, False), (8, 1100, False), (64, 500, True),
                                        (3, 65, True), (3, 1, True), (5, 64, True)])
def test_tc_flash_bwd_matches_plain_and_repeats_to_the_bit(cuda, n, l, causal):
    """K9 and K10 in bf16 at head dim 64 with the log-sum-exp and the output of K8."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, g = torch.randn(4, n, l, 64, device=cuda, generator=gen).bfloat16()
    out, lse = tattn.flash_attention_heads(q, k, v, save_lse=True, causal=causal)
    tattn.reset_launch_counts()
    got = tattn.flash_bwd_kernel(q, k, v, g, lse, out, causal)
    again = tattn.flash_bwd_kernel(q, k, v, g, lse, out, causal)
    assert tattn.route_counts == {"mha_tc": 0, "blocked_bwd_tc": 4, "mha_tf32": 0, "blocked_bwd_tf32": 0,
                                  "bld_tf32": 0, "bld_bwd_tf32": 0, "whole_bwd_tf32": 0}
    _card_close(got, tattn.flash_attention_bwd_reference(q, k, v, g, lse, out, causal))
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_tc_pair_serves_the_whole_block_entries_past_the_whole_head_kernel(cuda, causal):
    """K3's and K4's entries and K5's backward at the ViT-B/16 length in bf16."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    qkv = torch.randn(32, 197, 3 * 768, device=cuda, generator=gen).bfloat16()
    g = torch.randn(32, 197, 768, device=cuda, generator=gen).bfloat16()
    q, k, v = qkv.split(768, dim=-1)
    tattn.reset_launch_counts()
    _card_close([tattn.mha_qkv_bwd_kernel(qkv, g, 12, causal)],
                [tattn.mha_qkv_bwd_reference(qkv, g, 12, causal)])
    _card_close(tattn.mha_bld_bwd_kernel(q, k, v, g, 12, causal),
                tattn.mha_bld_bwd_reference(q, k, v, g, 12, causal))
    heads = [t.unflatten(-1, (12, 64)).transpose(1, 2) for t in (q, k, v, g)]
    _card_close(tattn.fused_attention_bwd_kernel(*heads, causal),
                tattn.attention_bwd_reference(*heads, causal))
    assert tattn.launch_counts == _counts(mha_qkv_bwd=1, mha_bld_bwd=1, fused_attention=1)
    assert tattn.route_counts == {"mha_tc": 0, "blocked_bwd_tc": 3, "mha_tf32": 0, "blocked_bwd_tf32": 0,
                                  "bld_tf32": 0, "bld_bwd_tf32": 0, "whole_bwd_tf32": 0}


@pytest.mark.gpu
def test_other_types_and_head_dims_stay_on_the_cuda_core_pair_on_the_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    tattn.reset_launch_counts()
    for dtype, heads in ((torch.float32, 2), (torch.bfloat16, 4), (torch.bfloat16, 16)):
        x = torch.randn(2, 200, 3 * 128, device=cuda, generator=gen).to(dtype)
        g = torch.randn(2, 200, 128, device=cuda, generator=gen).to(dtype)
        got = tattn.mha_qtile_bwd_kernel(x[..., :128], x[..., 128:], g, heads)
        want = tattn.mha_qtile_bwd_reference(x[..., :128], x[..., 128:], g, heads)
        torch.cuda.synchronize()
        top = max(w.float().abs().max().item() for w in want)
        for ours, theirs in zip(got, want):
            torch.testing.assert_close(ours.float(), theirs.float(), rtol=0,
                                       atol=(FP32_TOL if dtype == torch.float32 else 5e-2) * top)
    assert tattn.launch_counts == _counts(mha_qtile_bwd=3)
    # fp32 at head dim 64 on the split-TF32 pair; bf16 at head dims 32 and 8 on the CUDA cores
    assert tattn.route_counts == {"mha_tc": 0, "blocked_bwd_tc": 0, "mha_tf32": 0, "blocked_bwd_tf32": 1,
                                  "bld_tf32": 0, "bld_bwd_tf32": 0, "whole_bwd_tf32": 0}


@pytest.mark.gpu
def test_tc_backward_refuses_a_misaligned_view_on_the_card(cuda):
    x = torch.zeros(2, 50, 3 * 128 + 2, device=cuda, dtype=torch.bfloat16)[..., 1:-1]
    g = torch.zeros(2, 50, 128, device=cuda, dtype=torch.bfloat16)
    tattn.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte pieces"):
        tattn.mha_qtile_bwd_kernel(x[..., :128], x[..., 128:], g, 2)
    assert tattn.launch_counts == _counts()
