"""The split-TF32 KV-blocked backward pair (ops/csrc/mha_tf32_bwd.cu) behind K7,
K9, K10 and the KV-blocked route of K3, K4 and K5's backward in fp32 at head dim
64, and the routing around it.

On the CPU:

- the emulation of the pair's arithmetic (``blocked_bwd_tf32x3_reference``:
  each of the five products formed from the operands' TF32 parts) against the
  fp32 plain backwards within 1e-5 of max|ref|, with the statistics given and
  rebuilt, at ragged lengths and under the mask, and against the Pallas bodies
  in interpret mode (``_flash_bwd_impl`` for K9 and K10 with the forward's
  statistics, ``_mha_qtile_bwd_impl`` for K7), as tests/test_pallas_attention.py
  runs them; plain TF32's emulation (``passes=1``) must not sit within 1e-5;
- the pair's shared memory against hand-computed bytes;
- the wrappers' Python with the library replaced by numpy: fp32 at head dim 64
  calls the ``_tf32`` entries with the log-sum-exp and no row sum, bf16 at head
  dim 64 the ``_tc`` entries, head dims 8, 16 and 32 the CUDA-core pair; the
  route count ``blocked_bwd_tf32`` is exact; fp32 views that cannot be read in
  16-byte pieces are refused before any launch.

The ``gpu`` cases hold the pair against the fp32 plain backwards and the
emulation on the card, at the paths' shapes, at the ragged edges of its tiles,
under the mask, and to the bit between two launches; they import no JAX.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from anomalyclip_tpu_torch.ops import attention as tattn

# the pair and its emulation against the fp32 plain backwards, of max|ref|: the
# limit every fp32 kernel of the port is held to
FP32_TOL = 1e-5


@pytest.fixture(scope="module")
def jax_side():
    """(jax, the JAX package's Pallas attention module), JAX on the CPU as
    tests/conftest.py sets it: on a GPU JAX would run fp32 products in TF32."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    from anomalyclip_tpu.ops.pallas import attention

    return jax, attention


def _randn(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _gap(got, want) -> float:
    """max|got - want| over max|want|, across the tensors of two tuples."""
    top = max(float(np.abs(np.asarray(w, dtype=np.float32)).max()) for w in want)
    return max(float(np.abs(np.asarray(g, dtype=np.float32) - np.asarray(w, dtype=np.float32)).max())
               for g, w in zip(got, want)) / top


# ---------------------------------------------------------------------------
# the emulation of the pair's arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [1, 63, 64, 65, 129, 300])
def test_emulation_matches_the_fp32_plain_backwards(l, causal):
    """Rebuilt statistics against ``attention_bwd_reference`` (K7, K3, K4, K5's
    backward), given ones against the flash backward (K9, K10)."""
    rng = np.random.default_rng(40 + l)
    q, k, v, g = (_randn(rng, 2, 2, l, 64) for _ in range(4))
    rebuilt = tattn.blocked_bwd_tf32x3_reference(q, k, v, g, causal=causal)
    assert _gap(rebuilt, tattn.attention_bwd_reference(q, k, v, g, causal)) <= FP32_TOL
    out, lse = tattn.flash_attention_reference(q, k, v, save_lse=True, causal=causal)
    delta = tattn.flash_delta(g, out)
    given = tattn.blocked_bwd_tf32x3_reference(q, k, v, g, lse, delta, causal)
    assert _gap(given, tattn.flash_attention_bwd_reference(q, k, v, g, lse, out, causal)) <= FP32_TOL
    assert all(t.shape == q.shape and t.dtype == torch.float32 for t in (*rebuilt, *given))


@pytest.mark.parametrize("causal", [False, True])
def test_plain_tf32_emulation_misses_the_fp32_limit(causal):
    """One product of the big parts alone (TF32 as such) lands 1e-4 and more
    from the fp32 plain backward: why the pair forms three."""
    rng = np.random.default_rng(46)
    q, k, v, g = (_randn(rng, 2, 2, 200, 64) for _ in range(4))
    want = tattn.attention_bwd_reference(q, k, v, g, causal)
    assert _gap(tattn.blocked_bwd_tf32x3_reference(q, k, v, g, causal=causal, passes=1), want) > FP32_TOL
    assert _gap(tattn.blocked_bwd_tf32x3_reference(q, k, v, g, causal=causal), want) <= FP32_TOL


def test_packed_emulations_are_the_per_head_one():
    """K7's (q, k|v) and K3's packed qkv forms of the emulation against the
    plain backwards of the same layouts."""
    rng = np.random.default_rng(47)
    x, g = _randn(rng, 2, 150, 3 * 128), _randn(rng, 2, 150, 128)
    got = tattn.mha_qtile_bwd_tf32x3_reference(x[..., :128], x[..., 128:], g, 2)
    assert got[1].shape == (2, 150, 256)
    assert _gap(got, tattn.mha_qtile_bwd_reference(x[..., :128], x[..., 128:], g, 2)) <= FP32_TOL
    for causal in (False, True):
        got = tattn.mha_qkv_bwd_tf32x3_reference(x, g, 2, causal)
        assert got.shape == x.shape
        assert _gap([got], [tattn.mha_qkv_bwd_reference(x, g, 2, causal)]) <= FP32_TOL


@pytest.mark.parametrize("n,l", [(2, 577), (1, 130)])
def test_emulation_matches_pallas_flash_bwd(jax_side, n, l):
    """K9 and K10: both sides get the Pallas forward's output and log-sum-exp,
    the latter from lane 0 of its lane-broadcast (N, L, 128) layout."""
    _, jattn = jax_side
    import jax.numpy as jnp

    arrays = [np.random.default_rng(48 + l).standard_normal((n, l, 64)).astype(np.float32) for _ in range(4)]
    jq, jk, jv, jg = (jnp.asarray(a) for a in arrays)
    jout, jlse = jattn._flash_impl(jq, jk, jv, True, save_lse=True)
    want = jattn._flash_bwd_impl(jq, jk, jv, jg, jlse, jout, True)
    q, k, v, g = (torch.from_numpy(a) for a in arrays)
    lse = torch.from_numpy(np.asarray(jlse)[..., 0].copy())
    delta = tattn.flash_delta(g, torch.from_numpy(np.array(jout, dtype=np.float32)))
    got = tattn.blocked_bwd_tf32x3_reference(q, k, v, g, lse, delta)
    assert _gap(got, want) <= FP32_TOL


@pytest.mark.parametrize("b,l,d,h", [(2, 577, 256, 4), (2, 65, 128, 2)])
def test_emulation_matches_pallas_qtile_bwd(jax_side, b, l, d, h):
    """K7, the statistics rebuilt, against ``_mha_qtile_bwd_impl``."""
    _, jattn = jax_side
    import jax.numpy as jnp

    rng = np.random.default_rng(50 + l)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in ((b, l, d), (b, l, 2 * d), (b, l, d))]
    want = jattn._mha_qtile_bwd_impl(*(jnp.asarray(a) for a in arrays), h, True)
    got = tattn.mha_qtile_bwd_tf32x3_reference(*(torch.from_numpy(a) for a in arrays), h)
    assert _gap(got, want) <= FP32_TOL


# ---------------------------------------------------------------------------
# what the pair needs
# ---------------------------------------------------------------------------


def test_tf32_backward_shared_memory_against_hand_computed_bytes():
    row = 4 * (64 + 4)  # a staged fp32 row of head dim 64, padded by 4 floats
    tiles = 64 * row  # one 64-row tile
    # dq: the q and g tiles, two stages of a K and a V block
    assert tattn.blocked_bwd_tf32_smem_bytes(64, "dq") == (2 + 2 * 2) * tiles == 104_448
    # dkv: the K and V block, two stages of a q and a g tile, and per stage 64
    # fp32 log-sum-exps and 64 deltas
    assert tattn.blocked_bwd_tf32_smem_bytes(64, "dkv") == (2 + 2 * 2) * tiles + 2 * 2 * 64 * 4 == 105_472
    assert tattn.blocked_bwd_tf32_smem_bytes() == 105_472  # what the wrappers ask the card for
    # two blocks an SM, each with the 1 KB the card reserves, within its 228 KB
    assert 2 * (105_472 + 1024) <= 233_472
    with pytest.raises(KeyError):
        tattn.blocked_bwd_tf32_smem_bytes(64, "dk")


@pytest.mark.parametrize(
    "dtype,dh,pair",
    [(torch.float32, 64, "tf32"), (torch.bfloat16, 64, "tc"), (torch.float32, 32, "cuda"),
     (torch.float32, 16, "cuda"), (torch.float32, 8, "cuda"), (torch.bfloat16, 32, "cuda")],
)
def test_the_pair_is_chosen_by_operand_type_and_head_dim(dtype, dh, pair):
    assert tattn._blocked_pair(dtype, dh) == pair
    assert tattn.mha_tf32_eligible(dtype, dh) is (pair == "tf32")


# ---------------------------------------------------------------------------
# the wrappers' Python, the library replaced by numpy
# ---------------------------------------------------------------------------


class NumpyPairs:
    """The entries of the three KV-blocked backward pairs. The fp32 ones (the
    split-TF32 pair's and the CUDA-core pair's) compute their function in numpy
    through the raw pointers and (batch, head, row) element strides the
    wrappers pass; the bf16 tensor-core ones only record their call. Each call
    is recorded with the statistics' pointers it was handed."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _view(address, strides, shape):
        steps = (*strides, 1)
        span = 1 + sum((n - 1) * s for n, s in zip(shape, steps))
        flat = np.ctypeslib.as_array(ctypes.cast(address, ctypes.POINTER(ctypes.c_float)), (span,))
        return np.lib.stride_tricks.as_strided(flat, shape, [4 * s for s in steps])

    def _operands(self, ptrs, strides, count, shape):
        return [self._view(ptrs[i], [strides[3 * i + j] for j in range(3)], shape) for i in range(count)]

    @staticmethod
    def _stat(pointer, shape):
        return np.ctypeslib.as_array(ctypes.cast(pointer, ctypes.POINTER(ctypes.c_float)), shape)

    @staticmethod
    def _p_and_ds(q, k, v, g, lse, delta, causal, scale):
        s = np.einsum("bhqd,bhkd->bhqk", q, k) * scale
        if causal:
            s = np.where(np.tril(np.ones(s.shape[-2:], bool)), s, -1e30)
        p = np.exp(s - lse[..., None])
        return p, p * (np.einsum("bhqd,bhkd->bhqk", g, v) - delta[..., None]) * scale

    def acl_blocked_dq_tf32(self, ptrs, strides, lse, delta, recompute, b, h, seq, dh, causal, scale,
                            stream):
        self.calls.append(("dq_tf32", bool(recompute), causal, lse.value, delta.value))
        shape = (b, h, seq, dh)
        q, k, v, g, dq = self._operands(ptrs, strides, 5, shape)
        lse, delta = self._stat(lse, shape[:3]), self._stat(delta, shape[:3])
        if recompute:  # the statistics sweep hands over the log-sum-exp and delta
            s = np.einsum("bhqd,bhkd->bhqk", q, k) * scale
            if causal:
                s = np.where(np.tril(np.ones((seq, seq), bool)), s, -1e30)
            top = s.max(axis=-1)
            e = np.exp(s - top[..., None])
            total = e.sum(axis=-1)
            lse[...] = top + np.log(total)
            delta[...] = (e / total[..., None] * np.einsum("bhqd,bhkd->bhqk", g, v)).sum(axis=-1)
        _, ds = self._p_and_ds(q, k, v, g, lse, delta, causal, scale)
        dq[...] = np.einsum("bhqk,bhkd->bhqd", ds, k)
        return 0

    def acl_blocked_dkv_tf32(self, ptrs, strides, lse, delta, b, h, seq, dh, causal, scale, stream):
        self.calls.append(("dkv_tf32", False, causal, lse.value, delta.value))
        shape = (b, h, seq, dh)
        q, k, v, g, dk, dv = self._operands(ptrs, strides, 6, shape)
        p, ds = self._p_and_ds(q, k, v, g, self._stat(lse, shape[:3]), self._stat(delta, shape[:3]),
                               causal, scale)
        dk[...] = np.einsum("bhqk,bhqd->bhkd", ds, q)
        dv[...] = np.einsum("bhqk,bhqd->bhkd", p, g)
        return 0

    def acl_blocked_dq_tc(self, ptrs, strides, lse, delta, recompute, *args):
        self.calls.append(("dq_tc", bool(recompute), args[-3], lse.value, delta.value))
        return 0

    def acl_blocked_dkv_tc(self, ptrs, strides, lse, delta, *args):
        self.calls.append(("dkv_tc", False, args[-3], lse.value, delta.value))
        return 0

    def acl_blocked_dq(self, dtype, ptrs, strides, m, l, delta, recompute, *args):
        self.calls.append((f"dq dh{args[-4]}", bool(recompute), args[-3], m.value, delta.value))
        return 0

    def acl_blocked_dkv(self, dtype, ptrs, strides, m, l, delta, *args):
        self.calls.append((f"dkv dh{args[-4]}", False, args[-3], m.value, delta.value))
        return 0


class _AsCuda:
    """A CPU tensor that says it is on the card, for the wrappers' shape checks."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda")

    def __getattr__(self, name):
        return getattr(self._t, name)


@pytest.fixture
def numpy_pairs(monkeypatch):
    """The kernel launches on CPU tensors: the library in numpy; the device check,
    the card's limit (an H100's) and the stream lookup out of the way."""
    fake = NumpyPairs()
    monkeypatch.setattr(tattn, "load_library", lambda: fake)
    monkeypatch.setattr(tattn, "_stream", lambda t: None)
    monkeypatch.setattr(tattn, "smem_limit", lambda device: tattn.H100_SMEM_OPTIN)
    real_check = tattn._check_kernel_shape
    monkeypatch.setattr(tattn, "_check_kernel_shape",
                        lambda name, t, *args: real_check(name, _AsCuda(t), *args))
    tattn.reset_launch_counts()
    return fake


def _routes(tf32=0, tc=0):
    return {"mha_tc": 0, "blocked_bwd_tc": tc, "mha_tf32": 0, "blocked_bwd_tf32": tf32,
            "bld_tf32": 0, "bld_bwd_tf32": 0, "whole_bwd_tf32": 0}


def _counts(**expected):
    return {k: expected.get(k, 0) for k in tattn.launch_counts}


@pytest.mark.parametrize("l", [1, 65, 150])
def test_qtile_bwd_wrapper_takes_the_tf32_pair_with_the_log_sum_exp(numpy_pairs, l):
    """K7 in fp32 at head dim 64: q and kv as column slices of one packed
    tensor, dk|dv written into the two halves of one (B, L, 2D) tensor; the dq
    launch rebuilds the log-sum-exp and delta into two statistics, which the dkv
    launch reads."""
    rng = np.random.default_rng(60)
    x, g = _randn(rng, 2, l, 3 * 128), _randn(rng, 2, l, 128)
    dq, dkv = tattn.mha_qtile_bwd_kernel(x[..., :128], x[..., 128:], g, 2)
    assert dkv.shape == (2, l, 256) and dkv.is_contiguous() and dq.is_contiguous()
    want = tattn.mha_qtile_bwd_reference(x[..., :128], x[..., 128:], g, 2)
    assert _gap((dq, dkv), want) <= FP32_TOL
    (dq_call, recompute, _, lse, delta), dkv_call = numpy_pairs.calls
    assert (dq_call, recompute) == ("dq_tf32", True)
    assert dkv_call == ("dkv_tf32", False, False, lse, delta)  # the same two statistics
    assert delta - lse == 4 * 2 * 2 * l  # two (B, H, L) fp32 statistics, not three
    assert tattn.launch_counts == _counts(mha_qtile_bwd=1)
    assert tattn.route_counts == _routes(tf32=1)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_wrapper_hands_the_forward_log_sum_exp_to_the_tf32_pair(numpy_pairs, causal):
    """K9 and K10 in fp32 at head dim 64: the forward's log-sum-exp and delta
    from the output, read in place, no row sum; one launch, one count and one
    route each."""
    rng = np.random.default_rng(61)
    q, k, v, g = (_randn(rng, 3, 150, 64) for _ in range(4))
    out, lse = tattn.flash_attention_reference(q, k, v, save_lse=True, causal=causal)
    got = tattn.flash_bwd_kernel(q, k, v, g, lse, out, causal)
    assert _gap(got, tattn.flash_attention_bwd_reference(q, k, v, g, lse, out, causal)) <= FP32_TOL
    assert [c[:3] for c in numpy_pairs.calls] == [("dq_tf32", False, causal), ("dkv_tf32", False, causal)]
    assert {c[3] for c in numpy_pairs.calls} == {lse.data_ptr()}
    assert tattn.launch_counts == _counts(flash_dq=1, flash_dkv=1)
    assert tattn.route_counts == _routes(tf32=2)


@pytest.mark.parametrize("causal", [False, True])
def test_whole_block_entries_take_the_tf32_pair_past_the_whole_head_kernel(numpy_pairs, causal):
    """K3's packed dqkv, K4's (B, L, D) gradients with k and v the halves of one
    kv, and K5's backward on (B, H, L, Dh) views of one packed projection, all
    at the ViT-B/16 length: the split-TF32 pair with the mask handed to both
    passes."""
    rng = np.random.default_rng(62)
    qkv, g = _randn(rng, 2, 197, 3 * 128), _randn(rng, 2, 197, 128)
    got = tattn.mha_qkv_bwd_kernel(qkv, g, 2, causal)
    assert _gap([got], [tattn.mha_qkv_bwd_reference(qkv, g, 2, causal)]) <= FP32_TOL
    q, k, v = qkv.split(128, dim=-1)
    got = tattn.mha_bld_bwd_kernel(q, k, v, g, 2, causal)
    assert _gap(got, tattn.mha_bld_bwd_reference(q, k, v, g, 2, causal)) <= FP32_TOL
    views = [t.unflatten(-1, (2, 64)).transpose(1, 2) for t in (q, k, v, g)]
    got = tattn.fused_attention_bwd_kernel(*views, causal)
    assert _gap(got, tattn.attention_bwd_reference(*views, causal)) <= FP32_TOL
    assert [c[:3] for c in numpy_pairs.calls] == [("dq_tf32", True, causal), ("dkv_tf32", False, causal)] * 3
    assert tattn.launch_counts == _counts(mha_qkv_bwd=1, mha_bld_bwd=1, fused_attention=1)
    assert tattn.route_counts == _routes(tf32=3)


@pytest.mark.parametrize(
    "dtype,heads,calls,routes",
    [
        (torch.float32, 2, ["dq_tf32", "dkv_tf32"], _routes(tf32=1)),
        (torch.bfloat16, 2, ["dq_tc", "dkv_tc"], _routes(tc=1)),
        (torch.float32, 4, ["dq dh32", "dkv dh32"], _routes()),
        (torch.float32, 8, ["dq dh16", "dkv dh16"], _routes()),
        (torch.float32, 16, ["dq dh8", "dkv dh8"], _routes()),
        (torch.bfloat16, 4, ["dq dh32", "dkv dh32"], _routes()),
    ],
)
def test_each_type_and_head_dim_launches_its_own_pair(numpy_pairs, dtype, heads, calls, routes):
    """K7 over 128 columns: fp32 at head dim 64 on the split-TF32 pair, bf16
    there on the tensor-core pair, the smaller head dims on the CUDA-core pair;
    the route counts say so exactly."""
    rng = np.random.default_rng(63)
    x, g = _randn(rng, 2, 70, 3 * 128, dtype=dtype), _randn(rng, 2, 70, 128, dtype=dtype)
    tattn.mha_qtile_bwd_kernel(x[..., :128], x[..., 128:], g, heads)
    assert [c[0] for c in numpy_pairs.calls] == calls
    assert tattn.route_counts == routes


def _one_element_in(rng, *shape):
    """An fp32 view one element into a wider buffer: neither its address nor its
    row stride is a multiple of 16 bytes."""
    return _randn(rng, *shape[:-1], shape[-1] + 2)[..., 1:-1]


def test_tf32_backward_refuses_operands_it_cannot_read_in_16_byte_pieces(numpy_pairs):
    """fp32 at head dim 64 raises the tensor-core sentence before any launch:
    the choice of pair is by operand type and head dim alone, and neither the
    CUDA-core pair nor a plain version stands behind the entries."""
    rng = np.random.default_rng(64)
    x, g = _one_element_in(rng, 2, 50, 3 * 128), _randn(rng, 2, 50, 128)
    with pytest.raises(ValueError, match=r"mha_qtile_bwd: .*float32 operands in 16-byte pieces"):
        tattn.mha_qtile_bwd_kernel(x[..., :128], x[..., 128:], g, 2)
    with pytest.raises(ValueError, match="mha_qkv_bwd: .*16-byte pieces"):
        tattn.mha_qkv_bwd_kernel(_one_element_in(rng, 2, 197, 3 * 128), _randn(rng, 2, 197, 128), 2, False)
    q = _one_element_in(rng, 3, 70, 64)
    k, v, gg = (_randn(rng, 3, 70, 64) for _ in range(3))
    stats = torch.zeros(3, 70)
    with pytest.raises(ValueError, match=r"flash_dq: .*16-byte pieces; shape \(3, 1, 70, 64\)"):
        tattn.flash_dq_kernel(q, k, v, gg, stats, stats)
    with pytest.raises(ValueError, match="flash_dkv: .*16-byte pieces"):
        tattn.flash_dkv_kernel(k, q, v, gg, stats, stats)
    assert numpy_pairs.calls == [] and tattn.launch_counts == _counts() and tattn.route_counts == _routes()
    # at head dim 32 the same views go to the CUDA-core pair
    tattn.mha_qtile_bwd_kernel(x[..., :128], x[..., 128:], g, 4)
    assert [c[0] for c in numpy_pairs.calls] == ["dq dh32", "dkv dh32"]


def test_tf32_backward_refuses_what_the_card_cannot_hold(numpy_pairs, monkeypatch):
    """The wrappers ask for the larger of the pair's two blocks."""
    rng = np.random.default_rng(65)
    q, kv, g = (_randn(rng, 1, 70, d) for d in (64, 128, 64))
    monkeypatch.setattr(tattn, "smem_limit", lambda device: 105_472)
    tattn.mha_qtile_bwd_kernel(q, kv, g, 1)
    monkeypatch.setattr(tattn, "smem_limit", lambda device: 105_471)
    with pytest.raises(ValueError, match="needs 105472 B of shared memory per block, the card gives 105471"):
        tattn.mha_qtile_bwd_kernel(q, kv, g, 1)
    assert [c[0] for c in numpy_pairs.calls] == ["dq_tf32", "dkv_tf32"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_close(got, plain, emulated):
    """Finite, and within FP32_TOL of max|ref| of both the plain backward and the
    emulation."""
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert _gap([t.cpu() for t in got], [t.cpu() for t in plain]) <= FP32_TOL
    assert _gap([t.cpu() for t in got], [t.cpu() for t in emulated]) <= FP32_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,d,heads", [(32, 577, 1024, 16), (3, 1, 128, 2), (3, 63, 128, 2),
                                         (3, 64, 128, 2), (3, 65, 128, 2), (3, 129, 128, 2),
                                         (3, 1100, 128, 2)])
def test_tf32_qtile_bwd_matches_plain_and_emulation_and_repeats_to_the_bit(cuda, b, l, d, heads):
    """K7 in fp32 at head dim 64, at the ViT-L/14@336px shape and at the ragged
    edges of its tiles; q and kv are views of one tensor."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(b, l, 3 * d, device=cuda, generator=gen)
    g = torch.randn(b, l, d, device=cuda, generator=gen)
    q, kv = x[..., :d], x[..., d:]
    tattn.reset_launch_counts()
    got, again = (tattn.mha_qtile_bwd_kernel(q, kv, g, heads) for _ in range(2))
    assert tattn.launch_counts["mha_qtile_bwd"] == 2 and tattn.route_counts == _routes(tf32=2)
    _card_close(got, tattn.mha_qtile_bwd_reference(q, kv, g, heads),
                tattn.mha_qtile_bwd_tf32x3_reference(q, kv, g, heads))
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("n,l,causal", [(512, 577, False), (8, 1100, False), (64, 500, True),
                                        (3, 65, True), (3, 1, True), (5, 64, True)])
def test_tf32_flash_bwd_matches_plain_and_emulation_and_repeats_to_the_bit(cuda, n, l, causal):
    """K9 and K10 in fp32 at head dim 64 with the log-sum-exp and the output of K8."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, g = torch.randn(4, n, l, 64, device=cuda, generator=gen)
    out, lse = tattn.flash_attention_heads(q, k, v, save_lse=True, causal=causal)
    tattn.reset_launch_counts()
    got, again = (tattn.flash_bwd_kernel(q, k, v, g, lse, out, causal) for _ in range(2))
    assert tattn.route_counts == _routes(tf32=4)
    delta = tattn.flash_delta(g, out)
    _card_close(got, tattn.flash_attention_bwd_reference(q, k, v, g, lse, out, causal),
                tattn.blocked_bwd_tf32x3_reference(q, k, v, g, lse, delta, causal))
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_tf32_pair_serves_the_whole_block_entries_past_the_whole_head_kernel(cuda, causal):
    """K3's entry and K5's backward at the ViT-B/16 length in fp32."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    qkv = torch.randn(32, 197, 3 * 768, device=cuda, generator=gen)
    g = torch.randn(32, 197, 768, device=cuda, generator=gen)
    tattn.reset_launch_counts()
    _card_close([tattn.mha_qkv_bwd_kernel(qkv, g, 12, causal)],
                [tattn.mha_qkv_bwd_reference(qkv, g, 12, causal)],
                [tattn.mha_qkv_bwd_tf32x3_reference(qkv, g, 12, causal)])
    heads = [t.unflatten(-1, (12, 64)).transpose(1, 2) for t in (*qkv.split(768, dim=-1), g)]
    _card_close(tattn.fused_attention_bwd_kernel(*heads, causal),
                tattn.attention_bwd_reference(*heads, causal),
                tattn.blocked_bwd_tf32x3_reference(*heads, causal=causal))
    assert tattn.launch_counts == _counts(mha_qkv_bwd=1, fused_attention=1)
    assert tattn.route_counts == _routes(tf32=2)


@pytest.mark.gpu
def test_tf32_backward_refuses_a_misaligned_view_on_the_card(cuda):
    x = torch.zeros(2, 50, 3 * 128 + 2, device=cuda)[..., 1:-1]
    g = torch.zeros(2, 50, 128, device=cuda)
    tattn.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte pieces"):
        tattn.mha_qtile_bwd_kernel(x[..., :128], x[..., 128:], g, 2)
    assert tattn.launch_counts == _counts() and tattn.route_counts == _routes()
