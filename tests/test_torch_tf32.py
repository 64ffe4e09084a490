"""The split-TF32 kernel behind ``fused_mha_qkv``, ``flash_attention_heads`` and
``fused_mha_qtile`` in fp32 at head dim 64 (ops/csrc/mha_tf32.cu), and the
routing around it and around K8's bf16 entry on the tensor-core kernel
(ops/csrc/mha_tc.cu).

On the CPU:

- the emulation of the kernel's arithmetic (``tf32x3_reference``: each product
  formed from the operands' TF32 big and small parts) against the fp32 plain
  versions and against the Pallas kernels in interpret mode, within 1e-5;
  the emulation of plain TF32 (the big parts alone) is not, which is why TF32
  stays off; ``tf32_split`` rounds as ``cvt.rna.tf32.f32`` does;
- the wrappers' Python with the library replaced by numpy: fp32 at head dim 64
  launches the split-TF32 entries (K1, K6, K8), bf16 at head dim 64 the
  tensor-core ones, every other head dim the CUDA-core ones;
  ``route_counts["mha_tf32"]`` and ``["mha_tc"]``; the pointers K8 is handed
  are the packed qkv's own when ``fused_attention``'s flash branch runs on the
  core rung's views, in either type, and its output folds back without a copy;
  at head dim 32 the views are folded for mha_long.cu; the log-sum-exp handed on
  to K9 and K10; the refusal of views the kernels cannot read in 16-byte
  pieces;
- ``mha_tf32_eligible``, the kernel's shared memory, and the ladder's rungs,
  which do not change.

The ``gpu`` cases hold the kernel against the fp32 plain versions on the card
at the paths' shapes and at the ragged edges (K6 too), and require two launches
to give the same bits. JAX is imported only in the CPU cases that need it, so
``python -m pytest --noconftest -m gpu`` runs this file without it.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import pytest
import torch

from anomalyclip_tpu_torch.models.clip import model as tclip
from anomalyclip_tpu_torch.ops import attention as tattn

FP32_TOL = 1e-5


@pytest.fixture(scope="module")
def jax_side():
    """(jax.numpy, the JAX package's Pallas attention module), JAX on the CPU as
    tests/conftest.py sets it: on a GPU JAX would run fp32 products in TF32."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    from anomalyclip_tpu.ops.pallas import attention

    return jax.numpy, attention


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _max_gap(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())


# ---------------------------------------------------------------------------
# the emulation of the kernel's arithmetic
# ---------------------------------------------------------------------------


def test_tf32_split_rounds_as_cvt_rna():
    """To nearest with ties away from zero, on (bits + 0x1000) & ~0x1FFF: big
    keeps 10 mantissa bits, small the next ones, and big + small is x to 2^-22."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + 3 * ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 0.0, -3.25])
    big, small = tattn.tf32_split(x)
    assert big.tolist() == [1.0, 1 + ulp, 1 + 2 * ulp, -(1 + ulp), 1.0, 0.0, -3.25]
    bits = big.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all()) and bool(((small.view(torch.int32) & 0x1FFF) == 0).all())
    r = torch.from_numpy(_arrays(0, (4096,))[0]) * 100
    big, small = tattn.tf32_split(r)
    assert float(((big + small - r).abs() / r.abs()).max()) <= 2.0 ** -21
    want = ((r.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    assert torch.equal(big, want)


@pytest.mark.parametrize("causal", [False, True])
def test_emulated_tf32x3_qkv_matches_fp32_plain_and_pallas(jax_side, causal):
    """K1's shape (2, 197, 192) with 3 heads of 64: within 1e-5 of the fp32
    plain version and of ``fused_mha_qkv`` through its Pallas kernel."""
    jnp, jattn = jax_side
    (x,) = _arrays(1, (2, 197, 3 * 192))
    qkv = torch.from_numpy(x)
    got = tattn.mha_qkv_tf32x3_reference(qkv, 3, causal)
    assert got.shape == (2, 197, 192) and got.dtype == torch.float32
    assert _max_gap(got, tattn.mha_qkv_reference(qkv, 3, causal)) <= FP32_TOL
    assert _max_gap(got, jattn.fused_mha_qkv(jnp.asarray(x), 3, causal, True)) <= FP32_TOL


@pytest.mark.parametrize("l", [1, 63, 65, 577])
def test_emulated_tf32x3_flash_matches_fp32_plain_and_pallas(jax_side, l):
    """K8's per-head (6, L, 64) with the log-sum-exp, at the ragged edges of the
    kernel's 64-row tiles and 64-key blocks and at the tower's length."""
    jnp, jattn = jax_side
    arrays = _arrays(2, *[(6, l, 64)] * 3)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    out, lse = tattn.tf32x3_reference(q, k, v, save_lse=True)
    want_out, want_lse = tattn.flash_attention_reference(q, k, v, save_lse=True)
    assert out.shape == (6, l, 64) and lse.shape == (6, l)
    assert _max_gap(out, want_out) <= FP32_TOL and _max_gap(lse, want_lse) <= FP32_TOL
    jout, jlse = jattn._flash_impl(*(jnp.asarray(a) for a in arrays), True, save_lse=True)
    assert _max_gap(out, jout) <= FP32_TOL and _max_gap(lse, np.asarray(jlse)[..., 0]) <= FP32_TOL


@pytest.mark.parametrize("l", [65, 400])
def test_emulated_tf32x3_qtile_matches_fp32_plain_and_pallas(jax_side, l):
    """K6's q (2, L, 128) against k|v (2, L, 256) with 2 heads of 64: the
    emulation of the split-TF32 entry within 1e-5 of the fp32 plain version and
    of ``fused_mha_qtile`` through its Pallas kernel, at a ragged length and at
    the fp32 length the phase-3 case runs."""
    jnp, jattn = jax_side
    xq, xkv = _arrays(3, (2, l, 128), (2, l, 256))
    q, kv = torch.from_numpy(xq), torch.from_numpy(xkv)
    got = tattn.mha_qtile_tf32x3_reference(q, kv, 2)
    assert got.shape == (2, l, 128) and got.dtype == torch.float32
    assert _max_gap(got, tattn.mha_qtile_reference(q, kv, 2)) <= FP32_TOL
    assert _max_gap(got, jattn.fused_mha_qtile(jnp.asarray(xq), jnp.asarray(xkv), 2, True)) <= FP32_TOL
    # plain TF32 (the big parts alone) does not hold the limit there
    assert _max_gap(tattn.mha_qtile_tf32x3_reference(q, kv, 2, passes=1),
                    tattn.mha_qtile_reference(q, kv, 2)) > FP32_TOL


@pytest.mark.parametrize("causal", [False, True])
def test_emulated_plain_tf32_breaks_the_fp32_limit(causal):
    """One product of the big parts (plain TF32) lands far outside 1e-5 at the
    same shapes: the emulation's tests have teeth, and the split is needed."""
    (x,) = _arrays(1, (2, 197, 3 * 192))
    qkv = torch.from_numpy(x)
    want = tattn.mha_qkv_reference(qkv, 3, causal)
    assert _max_gap(tattn.mha_qkv_tf32x3_reference(qkv, 3, causal, passes=1), want) > 10 * FP32_TOL
    q, k, v = (torch.from_numpy(a) for a in _arrays(2, *[(6, 577, 64)] * 3))
    gap = _max_gap(tattn.tf32x3_reference(q, k, v, causal, passes=1),
                   tattn.flash_attention_reference(q, k, v, causal=causal))
    assert gap > 10 * FP32_TOL


# ---------------------------------------------------------------------------
# eligibility, shared memory, the ladder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "dtype,dh,want",
    [(torch.float32, 64, True), (torch.bfloat16, 64, False), (torch.float32, 32, False),
     (torch.float32, 16, False), (torch.float32, 8, False), (torch.float16, 64, False)],
)
def test_mha_tf32_eligible(dtype, dh, want):
    assert tattn.mha_tf32_eligible(dtype, dh) is want
    # the bf16 tensor-core kernel and this one never claim the same operands
    assert not (tattn.mha_tf32_eligible(dtype, dh) and tattn.mha_tc_eligible(dtype, dh))


def test_tf32_shared_memory_is_independent_of_length():
    """Two stages of 64 keys of K (rows padded to 72 floats) and V (68 floats):
    71,680 B, two blocks an SM within an H100's shared memory."""
    assert tattn.mha_tf32_smem_bytes() == tattn.mha_tf32_smem_bytes(64) == 71_680
    assert 2 * tattn.mha_tf32_smem_bytes() <= tattn.H100_SMEM_OPTIN


@pytest.mark.parametrize(
    "b,l,d,heads,causal,fp32,bf16",
    [
        (256, 197, 768, 12, False, "mha", "mha"),  # ViT-B/16
        (256, 50, 768, 12, False, "mha", "mha"),  # ViT-B/32
        (64, 257, 1024, 16, False, "mha", "mha"),  # ViT-L/14
        (256, 577, 1024, 16, False, "core", "qtile"),  # ViT-L/14@336px
        (14, 77, 512, 8, True, "mha", "mha"),  # the text towers
        (14, 77, 768, 12, True, "mha", "mha"),
        (2, 500, 256, 4, True, "core", "core"),  # causal past the whole-row kernel
        (2, 421, 64, 1, False, "core", "qtile"),  # fp32 K and V past the whole-row kernel
    ],
)
def test_ladder_picks_the_rungs_it_picked_before(b, l, d, heads, causal, fp32, bf16):
    """The admission limits did not change: only the kernel under a rung did."""
    assert tclip.attention_rung(b, l, d, heads, 4, causal) == fp32
    assert tclip.attention_rung(b, l, d, heads, 2, causal) == bf16


# ---------------------------------------------------------------------------
# the wrappers' Python, the library replaced by numpy
# ---------------------------------------------------------------------------


def _raw(address, strides, shape, ctype=ctypes.c_float):
    """An ndarray over ``shape`` elements at ``address`` with element ``strides``."""
    span = 1 + sum((n - 1) * s for n, s in zip(shape, strides))
    flat = np.ctypeslib.as_array(ctypes.cast(address, ctypes.POINTER(ctype)), (span,))
    size = ctypes.sizeof(ctype)
    return np.lib.stride_tricks.as_strided(flat, shape, tuple(size * s for s in strides))


def _read(address, strides, shape, bf16):
    if not bf16:
        return _raw(address, strides, shape).astype(np.float64)
    bits = _raw(address, strides, shape, ctypes.c_uint16).astype(np.uint32) << 16
    return bits.view(np.float32).astype(np.float64)


def _write(address, strides, shape, values, bf16):
    if not bf16:
        _raw(address, strides, shape)[...] = values
        return
    rounded = torch.from_numpy(np.ascontiguousarray(values, np.float32)).bfloat16().view(torch.int16)
    _raw(address, strides, shape, ctypes.c_uint16)[...] = rounded.numpy().view(np.uint16)


def _attend(q, k, v, causal, scale):
    """(..., L, dh) float64 -> (out, lse)."""
    s = np.einsum("...qd,...kd->...qk", q, k) * scale
    if causal:
        l = q.shape[-2]
        s = np.where(np.tril(np.ones((l, l), bool)), s, -1e30)
    top = s.max(axis=-1, keepdims=True)
    e = np.exp(s - top)
    total = e.sum(axis=-1, keepdims=True)
    return np.einsum("...qk,...kd->...qd", e / total, v), (top + np.log(total))[..., 0]


class NumpyTf32Kernels:
    """The entries K1, K6 and K8 launch in numpy: the split-TF32 ones of
    mha_tf32.cu, the tensor-core ones of mha_tc.cu and the CUDA-core ones of
    mha.cu and mha_long.cu; whole-row softmax attention in float64 on the
    decoded operands, read and written through the raw pointers and element
    strides the wrappers pass, so that a wrong view, stride, argument order or
    choice of kernel shows. Each call is recorded with its pointers."""

    def __init__(self):
        self.calls = []

    def _qkv(self, tag, qkv, bs, rs, out, b, l, h, dh, causal, scale, bf16):
        d = h * dh
        self.calls.append((tag, dh, causal))
        x = _read(qkv, (bs, rs, 1), (b, l, 3 * d), bf16)
        heads = [x[..., i * d:(i + 1) * d].reshape(b, l, h, dh).transpose(0, 2, 1, 3) for i in range(3)]
        o, _ = _attend(*heads, causal, scale)
        _write(out, (l * d, d, 1), (b, l, d), o.transpose(0, 2, 1, 3).reshape(b, l, d), bf16)
        return 0

    def acl_mha_qkv_fwd(self, dtype, qkv, bs, rs, out, b, l, h, dh, causal, scale, stream):
        return self._qkv("qkv", qkv, bs, rs, out, b, l, h, dh, causal, scale, dtype == 1)

    def acl_mha_qkv_tc_fwd(self, qkv, bs, rs, out, b, l, h, dh, causal, scale, stream):
        return self._qkv("qkv_tc", qkv, bs, rs, out, b, l, h, dh, causal, scale, True)

    def acl_mha_qkv_tf32_fwd(self, qkv, bs, rs, out, b, l, h, dh, causal, scale, stream):
        return self._qkv("qkv_tf32", qkv, bs, rs, out, b, l, h, dh, causal, scale, False)

    def _flash_heads(self, tag, bf16, ptrs, strides, lse, b, h, l, dh, causal, scale):
        addresses = [ptrs[i] for i in range(4)]
        self.calls.append((tag, dh, causal, tuple(addresses), tuple(strides[i] for i in range(12))))
        shape = (b, h, l, dh)
        q, k, v = (_read(addresses[i], (*(strides[3 * i + j] for j in range(3)), 1), shape, bf16)
                   for i in range(3))
        o, m = _attend(q, k, v, causal, scale)
        _write(addresses[3], (*(strides[9 + j] for j in range(3)), 1), shape, o, bf16)
        if lse.value is not None:
            _write(lse.value, (h * l, l, 1), (b, h, l), m, False)
        return 0

    def acl_flash_tf32_fwd(self, ptrs, strides, lse, b, h, l, dh, causal, scale, stream):
        return self._flash_heads("flash_tf32", False, ptrs, strides, lse, b, h, l, dh, causal, scale)

    def acl_flash_tc_fwd(self, ptrs, strides, lse, b, h, l, dh, causal, scale, stream):
        return self._flash_heads("flash_tc", True, ptrs, strides, lse, b, h, l, dh, causal, scale)

    def _qtile(self, tag, bf16, q, q_bs, q_rs, kv, kv_bs, kv_rs, out, b, l, h, dh, scale):
        d = h * dh
        self.calls.append((tag, dh, q.value, kv.value))
        x = _read(q, (q_bs, q_rs, 1), (b, l, d), bf16)
        y = _read(kv, (kv_bs, kv_rs, 1), (b, l, 2 * d), bf16)
        heads = [t.reshape(b, l, h, dh).transpose(0, 2, 1, 3) for t in (x, y[..., :d], y[..., d:])]
        o, _ = _attend(*heads, False, scale)
        _write(out, (l * d, d, 1), (b, l, d), o.transpose(0, 2, 1, 3).reshape(b, l, d), bf16)
        return 0

    def acl_mha_qtile_fwd(self, dtype, q, q_bs, q_rs, kv, kv_bs, kv_rs, out, b, l, h, dh, scale, stream):
        return self._qtile("qtile", dtype == 1, q, q_bs, q_rs, kv, kv_bs, kv_rs, out, b, l, h, dh, scale)

    def acl_mha_qtile_tc_fwd(self, q, q_bs, q_rs, kv, kv_bs, kv_rs, out, b, l, h, dh, scale, stream):
        return self._qtile("qtile_tc", True, q, q_bs, q_rs, kv, kv_bs, kv_rs, out, b, l, h, dh, scale)

    def acl_mha_qtile_tf32_fwd(self, q, q_bs, q_rs, kv, kv_bs, kv_rs, out, b, l, h, dh, scale, stream):
        return self._qtile("qtile_tf32", False, q, q_bs, q_rs, kv, kv_bs, kv_rs, out, b, l, h, dh, scale)

    def acl_flash_fwd(self, dtype, q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, out, lse, n, l, dh,
                      causal, scale, stream):
        self.calls.append(("flash", dtype, dh, causal))
        bf16 = dtype == 1
        shape = (n, l, dh)
        o, m = _attend(*(_read(p, (bs, rs, 1), shape, bf16)
                         for p, bs, rs in ((q, q_bs, q_rs), (k, k_bs, k_rs), (v, v_bs, v_rs))),
                       causal, scale)
        _write(out, (l * dh, dh, 1), shape, o, bf16)
        if lse.value is not None:
            _write(lse.value, (l, 1), (n, l), m, False)
        return 0


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
    fake = NumpyTf32Kernels()
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


def _counts(**expected):
    return {k: expected.get(k, 0) for k in tattn.launch_counts}


def _routes(tf32=0, tc=0, bwd_tf32=0):
    return {"mha_tc": tc, "blocked_bwd_tc": 0, "mha_tf32": tf32, "blocked_bwd_tf32": bwd_tf32,
            "bld_tf32": 0, "bld_bwd_tf32": 0, "whole_bwd_tf32": 0}


@pytest.mark.parametrize(
    "dtype,heads,call",
    [(torch.float32, 2, ("qkv_tf32", 64, 1)), (torch.bfloat16, 2, ("qkv_tc", 64, 1)),
     (torch.float32, 4, ("qkv", 32, 1)), (torch.float32, 8, ("qkv", 16, 1)),
     (torch.float32, 16, ("qkv", 8, 1))],
)
def test_qkv_wrapper_takes_the_split_tf32_kernel_in_fp32_at_head_dim_64(numpy_kernels, dtype, heads, call):
    """K1: the new entry for fp32 at head dim 64 alone, with its route counted;
    the result through the raw pointers is the attention of the packed qkv."""
    x = _randn(np.random.default_rng(40), dtype, 2, 70, 3 * 128)
    got = tattn.mha_qkv_fwd_kernel(x, heads, True)
    tol = FP32_TOL if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), tattn.mha_qkv_reference(x, heads, True).float(), rtol=0, atol=tol)
    assert numpy_kernels.calls == [call]
    assert tattn.launch_counts == _counts(fused_mha_qkv=1)
    assert tattn.route_counts == _routes(tf32=int(call[0] == "qkv_tf32"), tc=int(call[0] == "qkv_tc"))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "dtype,dh,kernel",
    [(torch.float32, 64, "flash_tf32"), (torch.bfloat16, 64, "flash_tc"), (torch.float32, 32, "flash"),
     (torch.float32, 16, "flash"), (torch.bfloat16, 32, "flash")],
)
def test_flash_wrapper_takes_the_split_tf32_kernel_in_fp32_at_head_dim_64(numpy_kernels, dtype, dh, kernel,
                                                                         causal):
    """K8 over per-head (N, L, dh): out and the (N, L) log-sum-exp from the
    split-TF32 entry in fp32 at head dim 64 and from the tensor-core entry in
    bf16 at head dim 64 (each as (N, 1, L, dh) views), from mha_long.cu's at
    the smaller head dims."""
    rng = np.random.default_rng(41)
    q, k, v = (_randn(rng, dtype, 3, 70, dh) for _ in range(3))
    out, lse = tattn.flash_fwd_kernel(q, k, v, True, causal)
    want_out, want_lse = tattn.flash_attention_reference(q, k, v, True, causal=causal)
    tol = FP32_TOL if dtype == torch.float32 else 2e-2
    assert out.shape == q.shape and out.dtype == dtype and out.is_contiguous() and lse.shape == (3, 70)
    torch.testing.assert_close(out.float(), want_out.float(), rtol=0, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=FP32_TOL)
    assert [c[0] for c in numpy_kernels.calls] == [kernel]
    if kernel != "flash":
        _, _, _, addresses, strides = numpy_kernels.calls[0]
        assert addresses == (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        assert strides == (70 * dh, 70 * dh, dh) * 4  # batch, head (one head), row
    assert tattn.launch_counts == _counts(flash_attention_heads=1)
    assert tattn.route_counts == _routes(tf32=int(kernel == "flash_tf32"), tc=int(kernel == "flash_tc"))
    out_only = tattn.flash_fwd_kernel(q, k, v, False, causal)  # no lse asked: a null pointer
    torch.testing.assert_close(out_only, out, rtol=0, atol=0)


@pytest.fixture
def kernels_chosen(monkeypatch, numpy_kernels):
    """The kernel path on CPU tensors: the forward through the numpy library,
    the backward's K9 and K10 by their plain versions, each call recorded with
    the statistics it was handed."""
    monkeypatch.setattr(tattn, "_use_reference", lambda t: False)
    handed = []

    def recorded(name, plain):
        def launch(q, k, v, g, lse, delta, causal=False):
            handed.append((name, q.shape, lse))
            return plain(q, k, v, g, lse, delta, causal)

        monkeypatch.setattr(tattn, name, launch)

    recorded("flash_dq_kernel", tattn.flash_dq_reference)
    recorded("flash_dkv_kernel", tattn.flash_dkv_reference)
    return numpy_kernels, handed


@pytest.mark.parametrize("causal", [False, True])
def test_core_rung_hands_k8_the_packed_qkv_in_place(kernels_chosen, causal):
    """The core rung at the ViT-L/14@336px length: ``fused_attention``'s flash
    branch hands K8 the packed qkv's own memory through (batch, head, row)
    strides, takes the output in the (B, L, H, dh) layout that folds back into
    (B, L, D) without a copy, and hands K9 and K10 the (B, H, L, dh) views with
    the forward's log-sum-exp; the gradient is the plain path's."""
    numpy_kernels, handed = kernels_chosen
    b, l, h, dh = 2, 577, 2, 64
    d = h * dh
    qkv = _randn(np.random.default_rng(42), torch.float32, b, l, 3 * d).requires_grad_(True)
    assert tclip.attention_rung(b, l, d, h, 4, causal) == "core"
    out = tclip._attention_apply_rung("core", qkv, h, causal)
    (_, _, _, addresses, strides), = numpy_kernels.calls
    base = qkv.data_ptr()
    assert addresses[:3] == (base, base + 4 * d, base + 8 * d)
    assert strides[:9] == (l * 3 * d, dh, 3 * d) * 3
    assert strides[9:] == (l * d, dh, d)  # the output in (B, L, H, dh) layout
    assert out.data_ptr() == addresses[3] and out.is_contiguous()  # folded back as a view
    torch.testing.assert_close(out, tattn.mha_qkv_reference(qkv, h, causal), rtol=0, atol=FP32_TOL)
    (grad,) = torch.autograd.grad((out ** 2).sum(), qkv)
    assert [(name, shape) for name, shape, _ in handed] == [("flash_dq_kernel", (b, h, l, dh)),
                                                            ("flash_dkv_kernel", (b, h, l, dh))]
    lse = handed[0][2]
    assert lse is handed[1][2] and lse.shape == (b, h, l)
    heads = [tattn._split_heads(t, h) for t in qkv.detach().split(d, dim=-1)]
    _, want_lse = tattn.flash_attention_reference(*heads, save_lse=True, causal=causal)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=FP32_TOL)
    (want,) = torch.autograd.grad((tattn.mha_qkv_reference(qkv, h, causal) ** 2).sum(), qkv)
    torch.testing.assert_close(grad, want, rtol=0, atol=FP32_TOL * want.abs().max().item())
    assert tattn.launch_counts == _counts(flash_attention_heads=1)
    assert tattn.route_counts == _routes(tf32=1)


def test_bf16_flash_branch_folds_the_heads_for_the_cuda_core_kernel(kernels_chosen):
    """In bf16 at head dim 32 K8 is mha_long.cu's kernel, which takes per-head
    tensors: the four-dimensional views are folded for it, and neither
    tensor-core entry is taken."""
    numpy_kernels, _ = kernels_chosen
    q, k, v = (_randn(np.random.default_rng(43), torch.bfloat16, 1, 2, 1500, 32) for _ in range(3))
    assert not tattn.mha_kernel_eligible(1500, 32, 1, torch.bfloat16)  # the flash branch
    out = tattn.fused_attention(q, k, v)
    assert out.shape == (1, 2, 1500, 32)
    torch.testing.assert_close(out.float(), tattn.attention_reference(q, k, v).float(), rtol=0, atol=2e-2)
    assert numpy_kernels.calls == [("flash", 1, 32, 0)]
    assert tattn.route_counts == _routes()


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_core_rung_hands_the_tensor_core_kernel_the_packed_qkv_in_place(kernels_chosen, causal):
    """In bf16 at head dim 64 the core rung (L past 789, or causal past the
    whole-row kernel) hands K8's tensor-core entry the packed qkv's own memory
    through (batch, head, row) strides and takes the output in the (B, L, H,
    dh) layout that folds back into (B, L, D) without a copy; K9 and K10 get
    the (B, H, L, dh) views with the forward's log-sum-exp, which is the plain
    version's."""
    numpy_kernels, handed = kernels_chosen
    b, l, h, dh = 1, (500 if causal else 800), 2, 64
    d = h * dh
    qkv = _randn(np.random.default_rng(45), torch.bfloat16, b, l, 3 * d).requires_grad_(True)
    assert tclip.attention_rung(b, l, d, h, 2, causal) == "core"
    out = tclip._attention_apply_rung("core", qkv, h, causal)
    (_, _, _, addresses, strides), = numpy_kernels.calls
    assert numpy_kernels.calls[0][0] == "flash_tc"
    base = qkv.data_ptr()
    assert addresses[:3] == (base, base + 2 * d, base + 4 * d)
    assert strides[:9] == (l * 3 * d, dh, 3 * d) * 3
    assert strides[9:] == (l * d, dh, d)
    assert out.data_ptr() == addresses[3] and out.is_contiguous()
    torch.testing.assert_close(out.float(), tattn.mha_qkv_reference(qkv, h, causal).float(), rtol=0, atol=2e-2)
    torch.autograd.grad((out.float() ** 2).sum(), qkv)
    assert [(name, shape) for name, shape, _ in handed] == [("flash_dq_kernel", (b, h, l, dh)),
                                                            ("flash_dkv_kernel", (b, h, l, dh))]
    heads = [tattn._split_heads(t, h) for t in qkv.detach().split(d, dim=-1)]
    _, want_lse = tattn.flash_attention_reference(*heads, save_lse=True, causal=causal)
    torch.testing.assert_close(handed[0][2], want_lse, rtol=0, atol=1e-4)
    assert tattn.launch_counts == _counts(flash_attention_heads=1)
    assert tattn.route_counts == _routes(tc=1)


@pytest.mark.parametrize(
    "dtype,heads,call",
    [(torch.float32, 2, "qtile_tf32"), (torch.bfloat16, 2, "qtile_tc"), (torch.float32, 4, "qtile"),
     (torch.bfloat16, 4, "qtile")],
)
def test_qtile_wrapper_takes_the_split_tf32_kernel_in_fp32_at_head_dim_64(numpy_kernels, dtype, heads, call):
    """K6: the split-TF32 entry for fp32 at head dim 64, the tensor-core one for
    bf16 at head dim 64, mha.cu's at head dim 32; q and the two halves of kv are
    the column slices of one packed projection, read in place."""
    x = _randn(np.random.default_rng(46), dtype, 2, 70, 3 * 128)
    q, kv = x[..., :128], x[..., 128:]
    got = tattn.mha_qtile_fwd_kernel(q, kv, heads)
    tol = FP32_TOL if dtype == torch.float32 else 2e-2
    want = tattn.mha_qtile_reference(q, kv, heads)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    assert [c[:2] for c in numpy_kernels.calls] == [(call, 128 // heads)]
    assert numpy_kernels.calls[0][2:] == (q.data_ptr(), kv.data_ptr())
    assert tattn.launch_counts == _counts(fused_mha_qtile=1)
    assert tattn.route_counts == _routes(tf32=int(call == "qtile_tf32"), tc=int(call == "qtile_tc"))


def _one_element_in(rng, *shape):
    """An fp32 view one element into a wider buffer: neither its address nor its
    row stride is a multiple of 16 bytes."""
    return _randn(rng, torch.float32, *shape[:-1], shape[-1] + 2)[..., 1:-1]


def test_split_tf32_kernel_refuses_views_it_cannot_read_in_16_byte_pieces(numpy_kernels):
    """fp32 at head dim 64 raises before any launch on a view whose address or
    strides are not multiples of 16 bytes: no other kernel stands behind the
    entries. Below head dim 64 the CUDA-core kernels take any view."""
    rng = np.random.default_rng(44)
    x = _one_element_in(rng, 2, 50, 3 * 128)
    with pytest.raises(ValueError, match=r"fused_mha_qkv: .*float32 operands in 16-byte pieces; "
                                         r"shape \(2, 50, 384\)"):
        tattn.mha_qkv_fwd_kernel(x, 2, False)
    q = _one_element_in(rng, 3, 70, 64)
    k, v = (_randn(rng, torch.float32, 3, 70, 64) for _ in range(2))
    with pytest.raises(ValueError, match=r"flash_attention_heads: .*16-byte pieces; shape \(3, 1, 70, 64\)"):
        tattn.flash_fwd_kernel(q, k, v, True)
    with pytest.raises(ValueError, match="flash_attention_heads: .*16-byte pieces"):
        tattn.flash_fwd_kernel(k, v, q, False)
    assert numpy_kernels.calls == [] and tattn.launch_counts == _counts()
    assert tattn.route_counts == _routes()
    tattn.mha_qkv_fwd_kernel(x, 4, False)  # head dim 32
    tattn.flash_fwd_kernel(q[..., :32], k[..., :32], v[..., :32], True)
    tattn.mha_qkv_fwd_kernel(x.contiguous(), 2, False)
    assert [c[0] for c in numpy_kernels.calls] == ["qkv", "flash", "qkv_tf32"]


@pytest.mark.parametrize("entry", ["qtile_fp32", "flash_bf16"])
def test_new_entries_refuse_views_they_cannot_read_in_16_byte_pieces(numpy_kernels, entry):
    """K6 in fp32 and K8 in bf16 at head dim 64 raise before any launch on a
    view whose address or strides are not multiples of 16 bytes: no CUDA-core
    kernel stands behind them any more."""
    rng = np.random.default_rng(47)
    if entry == "qtile_fp32":
        x = _one_element_in(rng, 2, 50, 3 * 128)
        with pytest.raises(ValueError, match=r"fused_mha_qtile: .*float32 operands in 16-byte pieces"):
            tattn.mha_qtile_fwd_kernel(x[..., :128], x[..., 128:], 2)
    else:
        q = _randn(rng, torch.bfloat16, 3, 70, 66)[..., 1:-1]
        k, v = (_randn(rng, torch.bfloat16, 3, 70, 64) for _ in range(2))
        with pytest.raises(ValueError, match=r"flash_attention_heads: .*bfloat16 operands in 16-byte pieces"):
            tattn.flash_fwd_kernel(q, k, v, True)
    assert numpy_kernels.calls == [] and tattn.launch_counts == _counts()
    assert tattn.route_counts == _routes()


def test_flash_attention_heads_keeps_its_per_head_signature():
    q = torch.zeros(1, 2, 5, 64)
    with pytest.raises(ValueError, match=r"per-head \(N, L, dh\) tensors, not \(1, 2, 5, 64\)"):
        tattn.flash_attention_heads(q, q, q)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


_QKV_CASES = [(256, 197, 768, 12, False), (14, 77, 512, 8, True), (14, 77, 768, 12, True),
              (64, 257, 1024, 16, False)] + [(3, l, 128, 2, c) for l in (1, 63, 64, 65, 129) for c in (False, True)]
_FLASH_CASES = [(4096, 577, False), (512, 577, False), (512, 500, True)] + [
    (3, l, c) for l in (1, 63, 64, 65, 129) for c in (False, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,d,heads,causal", _QKV_CASES)
def test_tf32_qkv_kernel_matches_fp32_plain_and_repeats_to_the_bit(cuda, b, l, d, heads, causal):
    gen = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(b, l, 3 * d, device=cuda, generator=gen)
    tattn.reset_launch_counts()
    got, again = tattn.mha_qkv_fwd_kernel(qkv, heads, causal), tattn.mha_qkv_fwd_kernel(qkv, heads, causal)
    want = tattn.mha_qkv_reference(qkv, heads, causal)
    torch.cuda.synchronize()
    assert tattn.launch_counts == _counts(fused_mha_qkv=2) and tattn.route_counts == _routes(tf32=2)
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=0, atol=FP32_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("n,l,causal", _FLASH_CASES)
def test_tf32_flash_kernel_matches_fp32_plain_and_repeats_to_the_bit(cuda, n, l, causal):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = torch.randn(3, n, l, 64, device=cuda, generator=gen)
    tattn.reset_launch_counts()
    got, again = tattn.flash_fwd_kernel(q, k, v, True, causal), tattn.flash_fwd_kernel(q, k, v, True, causal)
    want = tattn.flash_attention_reference(q, k, v, True, causal=causal)
    torch.cuda.synchronize()
    assert tattn.route_counts == _routes(tf32=2)
    for ours, repeat, theirs in zip(got, again, want):
        assert torch.equal(ours, repeat)
        torch.testing.assert_close(ours, theirs, rtol=0, atol=FP32_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,heads", [(64, 400, 16), (3, 1, 2), (3, 63, 2), (3, 64, 2), (3, 65, 2),
                                       (3, 129, 2)])
def test_tf32_qtile_kernel_matches_fp32_plain_and_repeats_to_the_bit(cuda, b, l, heads):
    """K6 in fp32 on q and kv as views of one packed projection, at the phase-3
    shape and at the ragged edges: the split-TF32 entry, within 1e-5 of the fp32
    plain version and of the emulation of its arithmetic."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    d = 64 * heads
    x = torch.randn(b, l, 3 * d, device=cuda, generator=gen)
    q, kv = x[..., :d], x[..., d:]
    tattn.reset_launch_counts()
    got, again = tattn.mha_qtile_fwd_kernel(q, kv, heads), tattn.mha_qtile_fwd_kernel(q, kv, heads)
    torch.cuda.synchronize()
    assert tattn.launch_counts == _counts(fused_mha_qtile=2) and tattn.route_counts == _routes(tf32=2)
    assert torch.equal(got, again)
    torch.testing.assert_close(got, tattn.mha_qtile_reference(q, kv, heads), rtol=0, atol=FP32_TOL)
    torch.testing.assert_close(got, tattn.mha_qtile_tf32x3_reference(q, kv, heads), rtol=0, atol=FP32_TOL)


@pytest.mark.gpu
def test_core_rung_views_on_the_card(cuda):
    """``fused_attention`` on the core rung's views of one packed qkv, forward
    and backward, against the plain path."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    qkv = torch.randn(8, 577, 3 * 1024, device=cuda, generator=gen).requires_grad_(True)
    tattn.reset_launch_counts()
    out = tclip._attention_apply_rung("core", qkv, 16, False)
    (grad,) = torch.autograd.grad((out ** 2).sum(), qkv)
    assert tattn.launch_counts == _counts(flash_attention_heads=1, flash_dq=1, flash_dkv=1)
    assert tattn.route_counts == _routes(tf32=1, bwd_tf32=2)  # K9 and K10 on mha_tf32_bwd.cu
    with tattn.attention_impl("reference"):
        want = tclip._attention_apply_rung("core", qkv, 16, False)
        (want_grad,) = torch.autograd.grad((want ** 2).sum(), qkv)
    torch.testing.assert_close(out, want, rtol=0, atol=FP32_TOL)
    torch.testing.assert_close(grad, want_grad, rtol=0, atol=FP32_TOL * want_grad.abs().max().item())
    assert math.isfinite(grad.abs().max().item())
