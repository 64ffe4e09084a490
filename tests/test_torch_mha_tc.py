"""The tensor-core kernel behind ``fused_mha_qkv``, ``fused_mha_qtile`` and
``flash_attention_heads`` in bf16 (ops/csrc/mha_tc.cu), and the routing around
the kernels.

On the CPU:

- the KV-blocked plain versions, which round where that kernel rounds, against
  the Pallas kernels in interpret mode (fp32 at 1e-5, bf16 at 5e-2), causal and
  not, at lengths that are and are not multiples of the KV block, and against
  the whole-row plain versions in fp32 at 1e-6; K8's bf16 plain version at the
  kernel's 64-key block, out and log-sum-exp, against the Pallas kernel and
  ``flash_attention_heads`` and, under the causal mask, against the whole-row
  plain version; the block each K8 plain version takes
  (``flash_reference_block``);
- the wrappers' Python with the library replaced by numpy: pointers, strides,
  the choice between the two kernels by operand type and head dim, the refusal
  of operands the tensor-core kernel cannot read, the counts, and the admission
  limits of both entries, which are unchanged;
- ``kernel_refusal`` and ``mha_kernel_eligible`` against the JAX package's
  ``mha_eligible`` rule and the card's limits, and the kernel each caller
  launches per shape: the temporal model, the ladder, ``fused_attention``'s two
  branches, the backwards. Nothing computes the plain version on the card
  unless the caller chose it;
- ``ANOMALYCLIP_ATTN_IMPL`` and its precedence under ``attention_impl``.

The ``gpu`` cases hold the kernel against its plain version on the card at the
shapes of the scoring paths and at the ragged edges, K8's entry with its
log-sum-exp and two launches to the bit, and the kernels of head dim 8 and of a
causal shape past the whole-row kernel against theirs. JAX is
imported only in the CPU cases, so ``python -m pytest --noconftest -m gpu`` runs
this file without it.
"""

from __future__ import annotations

import ctypes
import re
import types

import numpy as np
import pytest
import torch

from anomalyclip_tpu_torch.models import temporal as ttemporal
from anomalyclip_tpu_torch.models.clip import model as tclip
from anomalyclip_tpu_torch.ops import attention as tattn

FP32_TOL, BF16_TOL = 1e-5, 5e-2
# the tensor-core kernel against its KV-blocked plain version on the card: twice
# the largest gap measured over the towers' shapes (7.8e-3, PERF.md); outputs of
# randn inputs at L=577 have a standard deviation near 7e-2, so the inherited
# bf16 tolerance would pass a dropped key there
TC_TOL = 1.5e-2
BLOCK = tattn.MHA_TC_BLOCK_KV
DTYPES = {"float32": (torch.float32, FP32_TOL), "bfloat16": (torch.bfloat16, BF16_TOL)}
LENGTHS = [77, 197, 130]  # 64 + 13, 3 * 64 + 5, 2 * 64 + 2 keys


@pytest.fixture(scope="module")
def jax_side():
    """(jax.numpy, the JAX package's Pallas attention module), JAX on the CPU as
    tests/conftest.py sets it: on a GPU JAX would run fp32 products in TF32."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    from anomalyclip_tpu.ops.pallas import attention

    return jax.numpy, attention


def _inputs(jnp, seed, shapes, dtype_name):
    """Seeded numpy inputs, rounded to the dtype once -> (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jdtype = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    return ([jnp.asarray(a, jdtype) for a in arrays],
            [torch.from_numpy(a).to(DTYPES[dtype_name][0]) for a in arrays])


def _close(got, want, dtype_name):
    want = np.asarray(want, dtype=np.float32)
    tol = DTYPES[dtype_name][1]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the KV-blocked plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", LENGTHS)
def test_blocked_qkv_plain_matches_pallas(jax_side, l, causal, dtype_name):
    jnp, jattn = jax_side
    (jqkv,), (qkv,) = _inputs(jnp, 0, [(2, l, 3 * 128)], dtype_name)
    got = tattn.mha_qkv_reference(qkv, 2, causal, BLOCK)
    assert got.dtype == qkv.dtype and got.shape == (2, l, 128)
    _close(got, jattn.fused_mha_qkv(jqkv, 2, causal, True), dtype_name)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("l", LENGTHS)
def test_blocked_qtile_plain_matches_pallas(jax_side, l, dtype_name):
    jnp, jattn = jax_side
    (jq, jkv), (q, kv) = _inputs(jnp, 1, [(2, l, 128), (2, l, 256)], dtype_name)
    got = tattn.mha_qtile_reference(q, kv, 2, BLOCK)
    assert got.dtype == q.dtype and got.shape == (2, l, 128)
    _close(got, jattn.fused_mha_qtile(jq, jkv, 2, True), dtype_name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", LENGTHS)
def test_blocked_plain_is_the_whole_row_function_in_fp32(l, causal):
    """The same function in another order of the sums; a tail of keys past L in
    a longer buffer is not seen."""
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal((2, l, 3 * 128)).astype(np.float32))
    blocked = tattn.mha_qkv_reference(qkv, 2, causal, BLOCK)
    torch.testing.assert_close(blocked, tattn.mha_qkv_reference(qkv, 2, causal), rtol=0, atol=1e-6)
    q, kv = qkv[..., :128], qkv[..., 128:]
    if not causal:
        torch.testing.assert_close(tattn.mha_qtile_reference(q, kv, 2, BLOCK),
                                   tattn.mha_qtile_reference(q, kv, 2), rtol=0, atol=1e-6)
        assert torch.equal(tattn.mha_qtile_reference(q, kv, 2, BLOCK), blocked)
    longer = torch.cat([qkv, torch.full((2, 9, 3 * 128), 1e4)], dim=1)[:, :l]
    assert torch.equal(tattn.mha_qkv_reference(longer, 2, causal, BLOCK), blocked)


def test_blocked_plain_rounds_per_block_in_bf16():
    """p is rounded against the running max of its KV block, so the bf16 answer
    is not the whole-row plain version's to the bit, and is within the tolerance."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((2, 300, 3 * 128)).astype(np.float32)).bfloat16()
    whole, blocked = tattn.mha_qkv_reference(qkv, 2), tattn.mha_qkv_reference(qkv, 2, False, BLOCK)
    assert not torch.equal(whole, blocked)
    torch.testing.assert_close(blocked.float(), whole.float(), rtol=0, atol=BF16_TOL)


@pytest.mark.parametrize(
    "dtype,heads,block",
    [(torch.bfloat16, 2, BLOCK), (torch.bfloat16, 4, None), (torch.bfloat16, 8, None),
     (torch.float32, 2, None)],
)
def test_entries_run_the_plain_version_that_matches_the_kernel(dtype, heads, block):
    """On a CPU tensor K1 and K6 run the form of the plain version that rounds
    like the kernel the card would launch: KV-blocked for bf16 at head dim 64,
    whole rows for bf16 at head dims 32 and 16 and for fp32."""
    assert tattn.reference_block(dtype, 128 // heads) == block
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.standard_normal((2, 150, 3 * 128)).astype(np.float32)).to(dtype)
    assert torch.equal(tattn.fused_mha_qkv(qkv, heads, True),
                       tattn.mha_qkv_reference(qkv, heads, True, block))
    q, kv = qkv[..., :128], qkv[..., 128:]
    assert torch.equal(tattn.fused_mha_qtile(q, kv, heads), tattn.mha_qtile_reference(q, kv, heads, block))


def _whole_row_lse(q, k, causal):
    """The natural log-sum-exp of the fp32 scaled scores, whole rows."""
    s = tattn._masked_scores(q, k, causal)
    top = s.amax(dim=-1, keepdim=True)
    return (top + torch.log(torch.exp(s - top).sum(dim=-1, keepdim=True))).squeeze(-1)


@pytest.mark.parametrize("l", [577, 130, 65])
def test_tc_flash_plain_matches_pallas(jax_side, l):
    """K8 in bf16 at head dim 64: the plain version at the tensor-core kernel's
    64-key block (where that kernel rounds p) against ``_flash_impl`` in
    interpret mode and ``flash_attention_heads``, out within 5e-2 and the
    log-sum-exp within 1e-4: the lse is the natural log-sum-exp of the fp32
    scaled scores, the quantity K9 and K10 read."""
    jnp, jattn = jax_side
    jqkv, qkv = _inputs(jnp, 7, [(2, l, 64)] * 3, "bfloat16")
    out, lse = tattn.flash_attention_reference(*qkv, save_lse=True, block=BLOCK)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32 and lse.shape == (2, l)
    want_out, want_lse = jattn._flash_impl(*jqkv, True, save_lse=True)
    _close(out, want_out, "bfloat16")
    _close(out, jattn.flash_attention_heads(*jqkv, True), "bfloat16")
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse, np.float32)[..., 0], rtol=0, atol=1e-4)
    torch.testing.assert_close(lse, _whole_row_lse(*qkv[:2], False), rtol=0, atol=1e-4)


@pytest.mark.parametrize("l", [500, 129, 64])
def test_tc_flash_plain_causal_matches_whole_row_plain(l):
    """The same under the causal mask, which the Pallas kernel does not take:
    against the port's whole-row plain version, out within 5e-2 and lse within
    1e-4."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, l, 64)).astype(np.float32)).bfloat16()
               for _ in range(3))
    out, lse = tattn.flash_attention_reference(q, k, v, save_lse=True, block=BLOCK, causal=True)
    whole = tattn.attention_reference(q[:, None], k[:, None], v[:, None], causal=True)[:, 0]
    torch.testing.assert_close(out.float(), whole.float(), rtol=BF16_TOL, atol=BF16_TOL)
    torch.testing.assert_close(lse, _whole_row_lse(q, k, True), rtol=0, atol=1e-4)


@pytest.mark.parametrize(
    "dtype,dh,block",
    [(torch.bfloat16, 64, BLOCK), (torch.bfloat16, 32, tattn.FLASH_BLOCK_KV),
     (torch.float32, 64, tattn.FLASH_BLOCK_KV), (torch.float32, 16, tattn.FLASH_BLOCK_KV)],
)
def test_flash_plain_rounds_at_the_block_of_the_kernel_it_stands_for(dtype, dh, block):
    """``flash_attention_reference`` with no block, as ``flash_attention_heads``
    runs it on the CPU, takes the block of the kernel the operands launch on
    the card: the tensor-core kernel's 64 keys in bf16 at head dim 64,
    mha_long.cu's 128 otherwise."""
    assert tattn.flash_reference_block(dtype, dh) == block
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 300, dh)).astype(np.float32)).to(dtype)
               for _ in range(3))
    out, lse = tattn.flash_attention_heads(q, k, v, save_lse=True)
    want_out, want_lse = tattn.flash_attention_reference(q, k, v, True, block)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    if dtype == torch.bfloat16:  # the other kernel's block rounds elsewhere
        other = tattn.FLASH_BLOCK_KV if block == BLOCK else BLOCK
        assert not torch.equal(out, tattn.flash_attention_reference(q, k, v, block=other))


def test_tc_shared_memory_is_independent_of_length():
    assert tattn.mha_tc_smem_bytes() == tattn.mha_tc_smem_bytes(tattn.MHA_TC_HEAD_DIM) == 46_080
    assert 4 * tattn.mha_tc_smem_bytes() <= tattn.H100_SMEM_OPTIN  # the four blocks an SM holds


# ---------------------------------------------------------------------------
# the wrappers' Python, the library replaced by numpy
# ---------------------------------------------------------------------------


class NumpyMhaKernels:
    """The K1 and K6 entries of ops/csrc/mha.cu, mha_tc.cu and mha_tf32.cu in
    numpy: whole-row
    softmax attention in fp32 on the decoded operands, without the kernels'
    tiling or their bf16 rounding of P, reading and writing through the raw
    pointers and (batch, row) element strides the wrappers pass, so that a wrong
    view, stride, argument order or choice of kernel shows."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _raw(address, bs, rs, shape, ctype):
        b, l, d = shape
        span = 1 + (b - 1) * bs + (l - 1) * rs + (d - 1)
        flat = np.ctypeslib.as_array(ctypes.cast(address, ctypes.POINTER(ctype)), (span,))
        size = ctypes.sizeof(ctype)
        return np.lib.stride_tricks.as_strided(flat, shape, (size * bs, size * rs, size))

    def _read(self, address, bs, rs, shape, bf16):
        if not bf16:
            return self._raw(address, bs, rs, shape, ctypes.c_float)
        bits = self._raw(address, bs, rs, shape, ctypes.c_uint16).astype(np.uint32) << 16
        return bits.view(np.float32)

    def _write(self, address, shape, values, bf16):
        b, l, d = shape
        if not bf16:
            self._raw(address, l * d, d, shape, ctypes.c_float)[...] = values
            return
        rounded = torch.from_numpy(np.ascontiguousarray(values)).bfloat16().view(torch.int16).numpy()
        self._raw(address, l * d, d, shape, ctypes.c_uint16)[...] = rounded.view(np.uint16)

    @staticmethod
    def _attend(q, k, v, heads, causal, scale):
        b, l, d = q.shape
        qh, kh, vh = (t.reshape(b, l, heads, d // heads).transpose(0, 2, 1, 3) for t in (q, k, v))
        s = np.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
        if causal:
            s = np.where(np.tril(np.ones((l, l), bool)), s, -1e30)
        s = np.exp(s - s.max(axis=-1, keepdims=True))
        s = s / s.sum(axis=-1, keepdims=True)
        return np.einsum("bhqk,bhkd->bhqd", s, vh).transpose(0, 2, 1, 3).reshape(b, l, d)

    def _qkv(self, tag, bf16, qkv, bs, rs, out, b, l, h, dh, causal, scale):
        d = h * dh
        x = self._read(qkv, bs, rs, (b, l, 3 * d), bf16)
        self._write(out, (b, l, d),
                    self._attend(x[..., :d], x[..., d:2 * d], x[..., 2 * d:], h, causal, scale), bf16)
        return 0

    def _qtile(self, bf16, q, q_bs, q_rs, kv, kv_bs, kv_rs, out, b, l, h, dh, scale):
        d = h * dh
        qv, kvv = self._read(q, q_bs, q_rs, (b, l, d), bf16), self._read(kv, kv_bs, kv_rs, (b, l, 2 * d), bf16)
        self._write(out, (b, l, d), self._attend(qv, kvv[..., :d], kvv[..., d:], h, False, scale), bf16)
        return 0

    def acl_mha_qkv_fwd(self, dtype, qkv, bs, rs, out, b, l, h, dh, causal, scale, stream):
        self.calls.append(("qkv", dtype, dh, causal))
        return self._qkv("qkv", dtype == 1, qkv, bs, rs, out, b, l, h, dh, causal, scale)

    def acl_mha_qkv_tc_fwd(self, qkv, bs, rs, out, b, l, h, dh, causal, scale, stream):
        self.calls.append(("qkv_tc", dh, causal))
        return self._qkv("qkv_tc", True, qkv, bs, rs, out, b, l, h, dh, causal, scale)

    def acl_mha_qkv_tf32_fwd(self, qkv, bs, rs, out, b, l, h, dh, causal, scale, stream):
        self.calls.append(("qkv_tf32", dh, causal))
        return self._qkv("qkv_tf32", False, qkv, bs, rs, out, b, l, h, dh, causal, scale)

    def acl_mha_qtile_fwd(self, dtype, q, q_bs, q_rs, kv, kv_bs, kv_rs, out, b, l, h, dh, scale, stream):
        self.calls.append(("qtile", dtype, dh))
        return self._qtile(dtype == 1, q, q_bs, q_rs, kv, kv_bs, kv_rs, out, b, l, h, dh, scale)

    def acl_mha_qtile_tc_fwd(self, q, q_bs, q_rs, kv, kv_bs, kv_rs, out, b, l, h, dh, scale, stream):
        self.calls.append(("qtile_tc", dh))
        return self._qtile(True, q, q_bs, q_rs, kv, kv_bs, kv_rs, out, b, l, h, dh, scale)

    def acl_mha_qtile_tf32_fwd(self, q, q_bs, q_rs, kv, kv_bs, kv_rs, out, b, l, h, dh, scale, stream):
        self.calls.append(("qtile_tf32", dh))
        return self._qtile(False, q, q_bs, q_rs, kv, kv_bs, kv_rs, out, b, l, h, dh, scale)


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
    fake = NumpyMhaKernels()
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


def test_tc_wrappers_read_views_in_place_and_count(numpy_kernels):
    """bf16 at head dim 64: both entries launch the tensor-core kernel, K6 on q
    and kv as column slices of one packed projection."""
    rng = np.random.default_rng(10)
    x = _randn(rng, torch.bfloat16, 2, 150, 3 * 128)
    got = tattn.mha_qkv_fwd_kernel(x, 2, True)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    torch.testing.assert_close(got.float(), tattn.mha_qkv_reference(x, 2, True, BLOCK).float(),
                               rtol=0, atol=2e-2)
    q, kv = x[..., :128], x[..., 128:]
    got = tattn.mha_qtile_fwd_kernel(q, kv, 2)
    torch.testing.assert_close(got.float(), tattn.mha_qtile_reference(q, kv, 2, BLOCK).float(),
                               rtol=0, atol=2e-2)
    assert numpy_kernels.calls == [("qkv_tc", 64, 1), ("qtile_tc", 64)]
    assert tattn.launch_counts == _counts(fused_mha_qkv=1, fused_mha_qtile=1)
    assert tattn.route_counts == {"mha_tc": 2, "blocked_bwd_tc": 0, "mha_tf32": 0, "blocked_bwd_tf32": 0,
                                  "bld_tf32": 0, "bld_bwd_tf32": 0, "whole_bwd_tf32": 0}


def _misaligned(rng, dtype):
    """A packed (2, 50, 3 * 128) view one element into a wider buffer: neither its
    address nor its row stride is a multiple of 16 bytes."""
    return _randn(rng, dtype, 2, 50, 3 * 128 + 2)[..., 1:-1]


@pytest.mark.parametrize(
    "dtype,heads,make,calls",
    [
        (torch.float32, 2, None, [("qkv_tf32", 64, 0), ("qtile_tf32", 64)]),
        (torch.bfloat16, 2, None, [("qkv_tc", 64, 0), ("qtile_tc", 64)]),
        (torch.bfloat16, 4, None, [("qkv", 1, 32, 0), ("qtile", 1, 32)]),
        (torch.bfloat16, 8, None, [("qkv", 1, 16, 0), ("qtile", 1, 16)]),
        (torch.bfloat16, 16, None, [("qkv", 1, 8, 0), ("qtile", 1, 8)]),
        # both refuse the view at head dim 64 (the split-TF32 kernel reads
        # 16-byte pieces); at head dim 32 the CUDA-core kernels take it
        (torch.float32, 2, _misaligned, []),
        (torch.float32, 4, _misaligned, [("qkv", 0, 32, 0), ("qtile", 0, 32)]),
    ],
)
def test_kernel_choice_by_dtype_head_dim_and_alignment(numpy_kernels, dtype, heads, make, calls):
    """The tensor-core kernel for bf16 at head dim 64 and the split-TF32 one
    for fp32 at head dim 64, both of which raise on a view they cannot read in
    16-byte pieces; the CUDA-core kernels for the smaller head dims, whatever
    the alignment. The entry's count rises with each launch, and the result is
    right."""
    rng = np.random.default_rng(11)
    x = make(rng, dtype) if make else _randn(rng, dtype, 2, 50, 3 * 128)
    tol = 2e-2 if dtype == torch.bfloat16 else FP32_TOL
    q, kv = x[..., :128], x[..., 128:]
    launches = int(bool(calls))
    if launches:
        got = tattn.mha_qkv_fwd_kernel(x, heads, False)
        torch.testing.assert_close(got.float(), tattn.mha_qkv_reference(x, heads).float(), rtol=0, atol=tol)
        got = tattn.mha_qtile_fwd_kernel(q, kv, heads)
        torch.testing.assert_close(got.float(), tattn.mha_qtile_reference(q, kv, heads).float(),
                                   rtol=0, atol=tol)
    else:
        with pytest.raises(ValueError, match=r"fused_mha_qkv: .*float32 operands in 16-byte pieces"):
            tattn.mha_qkv_fwd_kernel(x, heads, False)
        with pytest.raises(ValueError, match=r"fused_mha_qtile: .*float32 operands in 16-byte pieces"):
            tattn.mha_qtile_fwd_kernel(q, kv, heads)
    assert numpy_kernels.calls == calls
    assert tattn.launch_counts == _counts(fused_mha_qkv=launches, fused_mha_qtile=launches)
    assert tattn.route_counts["mha_tc"] == 2 * (launches and calls[0][0].endswith("_tc"))
    assert tattn.route_counts["mha_tf32"] == 2 * (launches and calls[0][0].endswith("_tf32"))


def test_tc_wrappers_refuse_operands_they_cannot_read_in_16_byte_pieces(numpy_kernels):
    """A bf16 view at head dim 64 whose address or strides are not multiples of
    16 bytes raises before any launch: the choice of kernel is by operand type
    and head dim alone, and no second kernel stands behind the entries."""
    x = _misaligned(np.random.default_rng(12), torch.bfloat16)
    with pytest.raises(ValueError, match=r"fused_mha_qkv: .*16-byte pieces; shape \(2, 50, 384\)"):
        tattn.mha_qkv_fwd_kernel(x, 2, False)
    aligned = x.contiguous()
    with pytest.raises(ValueError, match="fused_mha_qtile: .*16-byte pieces"):
        tattn.mha_qtile_fwd_kernel(aligned[..., :128], x[..., 128:], 2)
    assert numpy_kernels.calls == [] and tattn.launch_counts == _counts()
    tattn.mha_qkv_fwd_kernel(aligned, 2, False)
    assert numpy_kernels.calls == [("qkv_tc", 64, 0)]


def test_admission_limits_are_unchanged(numpy_kernels):
    """Both entries go on refusing past the whole-row kernel's shared memory,
    in bf16 too, where the kernel they would launch no longer needs it: the
    ladder, the validate scripts and the launch counts are written to these
    limits."""
    assert tattn.mha_smem_bytes(420, 64) <= tattn.H100_SMEM_OPTIN < tattn.mha_smem_bytes(421, 64)
    assert tattn.mha_smem_bytes(789, 64, 2) <= tattn.H100_SMEM_OPTIN < tattn.mha_smem_bytes(790, 64, 2)
    for dtype in (torch.float32, torch.bfloat16):
        tattn.mha_qkv_fwd_kernel(torch.zeros(1, 420, 3 * 64, dtype=dtype), 1, False)
        with pytest.raises(ValueError, match=r"\(1, 421, 192\) needs \d+ B of shared memory"):
            tattn.mha_qkv_fwd_kernel(torch.zeros(1, 421, 3 * 64, dtype=dtype), 1, False)
    tattn.mha_qtile_fwd_kernel(torch.zeros(1, 789, 64).bfloat16(), torch.zeros(1, 789, 128).bfloat16(), 1)
    with pytest.raises(ValueError, match="shared memory"):
        tattn.mha_qtile_fwd_kernel(torch.zeros(1, 790, 64).bfloat16(), torch.zeros(1, 790, 128).bfloat16(), 1)
    with pytest.raises(ValueError, match="shared memory"):
        tattn.mha_qtile_fwd_kernel(torch.zeros(1, 421, 64), torch.zeros(1, 421, 128), 1)
    assert [c[0] for c in numpy_kernels.calls] == ["qkv_tf32", "qkv_tc", "qtile_tc"]
    # what the kernels do not take
    with pytest.raises(ValueError, match=r"\(2, 10, 144\)"):
        tattn.mha_qkv_fwd_kernel(torch.zeros(2, 10, 144).bfloat16(), 2, False)  # head dim 24
    with pytest.raises(ValueError, match="float16"):
        tattn.mha_qkv_fwd_kernel(torch.zeros(1, 50, 3 * 64).half(), 1, False)
    assert tattn.launch_counts == _counts(fused_mha_qkv=2, fused_mha_qtile=1)


# ---------------------------------------------------------------------------
# which shapes the kernels take, and the kernel each caller launches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "l,d,heads,dtype,staged,want",
    [
        (32, 256, 8, torch.float32, 4, True),  # the temporal model: head dim 32
        (16, 128, 8, torch.float32, 4, True),  # head dim 16
        (197, 768, 12, torch.bfloat16, 4, True),
        (4, 32, 4, torch.float32, 4, True),  # head dim 8: the reference's tiny model
        (50, 256, 2, torch.float32, 4, False),  # head dim 128: not instantiated
        (50, 100, 3, torch.float32, 4, False),  # heads do not divide d
        (50, 128, 2, torch.float16, 4, False),  # an operand type no kernel takes
        (420, 64, 1, torch.float32, 4, True),  # the last length whose fp32 K and V fit
        (421, 64, 1, torch.bfloat16, 4, False),
        (789, 64, 1, torch.bfloat16, 2, True),  # K6: staged in the operand type
        (790, 64, 1, torch.bfloat16, 2, False),
    ],
)
def test_mha_kernel_eligible(jax_side, l, d, heads, dtype, staged, want):
    """The JAX package's ``d % num_heads`` rule with the card's limits: an
    instantiated head dim and operand type, the head's K and V in shared
    memory."""
    _, jattn = jax_side
    assert tattn.mha_kernel_eligible(l, d, heads, dtype, staged_itemsize=staged) is want
    if d % heads:
        assert not jattn.mha_eligible(2, l, d, heads, 4)
    if want:
        assert d % heads == 0
        assert tattn.mha_smem_bytes(l, d // heads, staged) <= tattn.H100_SMEM_OPTIN
    # a smaller card takes less
    assert not tattn.mha_kernel_eligible(l, d, heads, dtype, smem=256, staged_itemsize=staged)


@pytest.mark.parametrize(
    "dtype,d,heads,need,smem,want",
    [
        (torch.float32, 512, 8, 100, 1000, None),
        (torch.bfloat16, 32, 4, 1000, 1000, None),  # head dim 8, the need just met
        (torch.float16, 512, 8, 0, 1000, "has dtype torch.float16"),
        (None, 512, 8, 0, 1000, "has dtype None"),
        (torch.float32, 100, 3, 0, 1000, "with 3 heads gives head dim 33.3333"),
        (torch.float32, 256, 2, 0, 1000, r"head dim 128; the kernels take \(8, 16, 32, 64\)"),
        (torch.float32, 512, 8, 1001, 1000, "needs 1001 B of shared memory per block, the card gives 1000"),
    ],
)
def test_kernel_refusal_is_the_one_statement_of_what_a_kernel_takes(dtype, d, heads, need, smem, want):
    """``kernel_refusal`` says why not, the eligibility function asks whether,
    and the wrappers raise its sentence with the entry's name and the shape."""
    got = tattn.kernel_refusal(dtype, d, heads, lambda dh: need, smem)
    if want is None:
        assert got is None
    else:
        assert got is not None and re.search(want, got)


@pytest.mark.parametrize(
    "l,d,heads,dtype,causal,route",
    [
        (77, 512, 8, torch.float32, True, "whole"),  # the text towers: the whole-head kernel
        (197, 768, 12, torch.float32, False, "blocked"),  # the KV-blocked pair
        (197, 768, 12, torch.bfloat16, True, "blocked"),  # causal past the whole-head kernel
        (100, 32, 2, torch.float32, False, "whole"),  # head dim 16: the whole-head kernel
        (200, 32, 2, torch.float32, False, "blocked"),  # head dim 16 past it
        (4, 32, 4, torch.float32, False, "whole"),  # head dim 8
        (577, 1024, 16, torch.bfloat16, False, "blocked"),
        (40, 32, 2, torch.bfloat16, False, "whole"),
    ],
)
def test_every_backward_shape_has_a_kernel(l, d, heads, dtype, causal, route):
    """Both backward kernels take the mask and every instantiated head dim, so
    the route is a matter of shared memory alone and is never None on an H100."""
    assert tattn.kernel_refusal(dtype, d, heads, lambda dh: 0, tattn.H100_SMEM_OPTIN) is None
    assert tattn.attention_bwd_route(l, d // heads, dtype.itemsize) == route


@pytest.fixture
def kernel_path_on_cpu(monkeypatch):
    """The kernel path forced on CPU tensors, every launch replaced by its plain
    version and recorded -> the record."""
    calls = []

    def counted(launch, plain):
        def wrapper(*args, **kwargs):
            calls.append(launch)
            return plain(*args, **kwargs)

        monkeypatch.setattr(tattn, launch, wrapper)

    # a CPU tensor counts as one on the card: only the caller's choice decides
    monkeypatch.setattr(tattn, "_use_reference", lambda t: tattn.current_impl() == "reference")
    counted("mha_qkv_fwd_kernel", tattn.mha_qkv_reference)
    counted("mha_bld_fwd_kernel", tattn.mha_bld_reference)
    counted("mha_qtile_fwd_kernel", tattn.mha_qtile_reference)
    counted("fused_attention_fwd_kernel", tattn.fused_attention_reference)
    counted("flash_fwd_kernel", lambda q, k, v, save_lse, causal: tattn.flash_attention_reference(
        q, k, v, save_lse, causal=causal))
    counted("mha_qkv_bwd_kernel", tattn.mha_qkv_bwd_reference)
    counted("mha_bld_bwd_kernel", tattn.mha_bld_bwd_reference)
    counted("mha_qtile_bwd_kernel", tattn.mha_qtile_bwd_reference)
    counted("fused_attention_bwd_kernel", tattn.attention_bwd_reference)
    counted("flash_bwd_kernel", tattn.flash_attention_bwd_reference)
    tattn.reset_launch_counts()
    return calls


@pytest.mark.parametrize("heads,dim_heads", [(4, 8), (8, 32), (8, 16)])
def test_temporal_attention_route_by_head_dim(kernel_path_on_cpu, heads, dim_heads):
    """The temporal model launches K2 at every head dim it is configured with
    (head dim 8 is the tiny model of the JAX package's graft entry): two
    attention layers, two launches."""
    cfg = ttemporal.TemporalConfig(input_size=16, emb_size=32, depth=1, heads=heads,
                                   dim_heads=dim_heads, num_segments=4, seg_length=4)
    params = ttemporal.init_temporal_params(torch.Generator().manual_seed(0), cfg)
    features = torch.randn(2 * 16, 16, generator=torch.Generator().manual_seed(1))
    scores = ttemporal.temporal_scores(features, params, cfg)
    assert scores.shape == (32, 1) and torch.isfinite(scores).all()
    assert kernel_path_on_cpu == ["mha_bld_fwd_kernel"] * 2


def test_temporal_attention_at_a_head_dim_no_kernel_takes_raises(numpy_kernels):
    """Head dim 128: K2's wrapper raises with the shape, and nothing is computed
    in its place."""
    x = torch.zeros(2, 4, 256)
    with pytest.raises(ValueError, match=r"fused_mha_bld: shape \(2, 4, 256\) with 2 heads gives head dim 128"):
        tattn.mha_bld_fwd_kernel(x, x, x, 2, False)
    assert numpy_kernels.calls == [] and tattn.launch_counts == _counts()


def test_temporal_model_at_head_dim_8_matches_jax(jax_side):
    """Forward and gradient at the tiny model's head dim against the JAX model,
    which takes its einsum formulation there."""
    jnp, _ = jax_side
    import jax

    from anomalyclip_tpu.models import temporal as jtemporal
    from anomalyclip_tpu_torch import convert

    jcfg = jtemporal.TemporalConfig(input_size=16, emb_size=32, depth=1, heads=4, dim_heads=8,
                                    num_segments=4, seg_length=4)
    tcfg = ttemporal.TemporalConfig(input_size=16, emb_size=32, depth=1, heads=4, dim_heads=8,
                                    num_segments=4, seg_length=4)
    jparams = jtemporal.init_temporal_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    features = np.random.default_rng(5).standard_normal((32, 16)).astype(np.float32)
    want, want_grad = jax.value_and_grad(
        lambda x: jnp.sum(jtemporal.temporal_scores(x, jparams, jcfg) ** 2))(jnp.asarray(features))
    x = torch.from_numpy(features).requires_grad_(True)
    got = (ttemporal.temporal_scores(x, tparams, tcfg) ** 2).sum()
    (got_grad,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(got_grad.numpy(), want_grad, rtol=1e-4, atol=1e-4 * np.abs(want_grad).max())


@pytest.mark.parametrize(
    "l,d,heads,itemsize,causal,rung",
    [
        (197, 768, 12, 4, False, "mha"),
        (577, 1024, 16, 2, False, "qtile"),
        (577, 1024, 16, 4, False, "core"),
        (500, 256, 4, 2, True, "core"),  # causal past the whole-row kernel
        (50, 64, 8, 4, False, "mha"),  # head dim 8
        (50, 128, 8, 4, False, "mha"),  # head dim 16
        (50, 100, 3, 4, False, "core"),
        (50, 64, 2, 8, False, "core"),  # float64: no kernel
    ],
)
def test_ladder_asks_the_eligibility_function(l, d, heads, itemsize, causal, rung):
    assert tclip.attention_rung(2, l, d, heads, itemsize, causal) == rung


@pytest.mark.parametrize(
    "shape,causal,branch",
    [
        ((1, 2, 40, 32), True, "whole"),
        ((1, 2, 577, 64), False, "flash"),
        ((1, 2, 500, 64), True, "flash"),  # causal past the whole-block kernel
        ((1, 2, 40, 8), False, "whole"),  # head dim 8
        ((1, 1, 2000, 16), False, "flash"),  # head dim 16 past the whole-block kernel
    ],
)
def test_fused_attention_routes_by_shape(monkeypatch, shape, causal, branch):
    """``fused_attention``'s two branches, chosen from the shape; both
    differentiate, and the flash branch is handed the mask and the
    four-dimensional views as they are."""
    taken = []
    real_whole, real_flash = tattn._fused_attention_op, tattn._flash_heads
    monkeypatch.setattr(tattn, "_fused_attention_op",
                        lambda *a: (taken.append("whole"), real_whole(*a))[1])
    monkeypatch.setattr(tattn, "_flash_heads",
                        lambda q, k, v, save_lse, causal: (taken.append(("flash", causal, q.shape)),
                                                           real_flash(q, k, v, save_lse, causal))[1])
    q = torch.randn(shape, generator=torch.Generator().manual_seed(2)).requires_grad_(True)
    out = tattn.fused_attention(q, q, q, causal)
    assert taken == ["whole" if branch == "whole" else ("flash", causal, shape)]
    (grad,) = torch.autograd.grad((out**2).sum(), q)
    assert grad.shape == q.shape and torch.isfinite(grad).all() and grad.abs().max() > 0
    torch.testing.assert_close(out, tattn.attention_reference(q, q, q, causal), rtol=0, atol=FP32_TOL)
    want = torch.autograd.grad((tattn.attention_reference(q, q, q, causal) ** 2).sum(), q)[0]
    torch.testing.assert_close(grad, want, rtol=0, atol=FP32_TOL * want.abs().max().item())


def _entry_calls():
    rng = np.random.default_rng(6)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).requires_grad_(True)

    return {
        "qkv causal L=77": (lambda x: tattn.fused_mha_qkv(x, 2, True), (t(1, 77, 3 * 128),),
                            ["mha_qkv_fwd_kernel", "mha_qkv_bwd_kernel"]),
        # causal past the whole-head backward: the KV-blocked pair behind the same wrapper
        "qkv causal L=197": (lambda x: tattn.fused_mha_qkv(x, 2, True), (t(1, 197, 3 * 128),),
                             ["mha_qkv_fwd_kernel", "mha_qkv_bwd_kernel"]),
        "bld head dim 16 L=200": (lambda q, k, v: tattn.fused_mha_bld(q, k, v, 2),
                                  (t(1, 200, 32), t(1, 200, 32), t(1, 200, 32)),
                                  ["mha_bld_fwd_kernel", "mha_bld_bwd_kernel"]),
        "bld head dim 8": (lambda q, k, v: tattn.fused_mha_bld(q, k, v, 4),
                           (t(2, 4, 32), t(2, 4, 32), t(2, 4, 32)),
                           ["mha_bld_fwd_kernel", "mha_bld_bwd_kernel"]),
        "qtile head dim 16": (lambda q, kv: tattn.fused_mha_qtile(q, kv, 2), (t(1, 40, 32), t(1, 40, 64)),
                              ["mha_qtile_fwd_kernel", "mha_qtile_bwd_kernel"]),
        "qtile head dim 64": (lambda q, kv: tattn.fused_mha_qtile(q, kv, 2), (t(1, 40, 128), t(1, 40, 256)),
                              ["mha_qtile_fwd_kernel", "mha_qtile_bwd_kernel"]),
        "fused_attention causal L=197": (lambda q, k, v: tattn.fused_attention(q, k, v, True),
                                         (t(1, 2, 197, 64), t(1, 2, 197, 64), t(1, 2, 197, 64)),
                                         ["fused_attention_fwd_kernel", "fused_attention_bwd_kernel"]),
        # causal past the whole-block forward: the flash kernel and its backward pair
        "fused_attention causal L=500": (lambda q, k, v: tattn.fused_attention(q, k, v, True),
                                         (t(1, 2, 500, 64), t(1, 2, 500, 64), t(1, 2, 500, 64)),
                                         ["flash_fwd_kernel", "flash_bwd_kernel"]),
        "fused_attention head dim 8": (lambda q, k, v: tattn.fused_attention(q, k, v),
                                       (t(1, 2, 40, 8), t(1, 2, 40, 8), t(1, 2, 40, 8)),
                                       ["fused_attention_fwd_kernel", "fused_attention_bwd_kernel"]),
    }


@pytest.mark.parametrize("name", list(_entry_calls()))
def test_both_directions_launch_a_kernel_at_every_shape(kernel_path_on_cpu, monkeypatch, name):
    """With the kernels chosen, every entry launches a kernel in each direction,
    at head dim 8 and at causal shapes past the whole-row kernels too, and
    never computes a plain version in a kernel's place."""
    call, inputs, launches = _entry_calls()[name]
    out = call(*inputs)
    grads = torch.autograd.grad((out**2).sum(), inputs)
    assert kernel_path_on_cpu == launches
    with tattn.attention_impl("reference"):  # the caller's choice launches nothing
        want = torch.autograd.grad((call(*inputs) ** 2).sum(), inputs)
    assert kernel_path_on_cpu == launches
    for ours, theirs in zip(grads, want):
        torch.testing.assert_close(ours, theirs, rtol=0, atol=FP32_TOL * theirs.abs().max().item())


def test_reset_launch_counts_clears_both_tables():
    tattn.launch_counts["fused_mha_qkv"] = 3
    tattn.route_counts["mha_tc"] = tattn.route_counts["mha_tf32"] = 3
    tattn.reset_launch_counts()
    assert tattn.launch_counts == _counts()
    assert tattn.route_counts == {"mha_tc": 0, "blocked_bwd_tc": 0, "mha_tf32": 0, "blocked_bwd_tf32": 0,
                                  "bld_tf32": 0, "bld_bwd_tf32": 0, "whole_bwd_tf32": 0}


# ---------------------------------------------------------------------------
# the switch outside a ``with`` block
# ---------------------------------------------------------------------------

_ON_CARD = types.SimpleNamespace(device=torch.device("cuda"))


@pytest.mark.parametrize(
    "env,scoped,want",
    [
        (None, None, "kernel"),
        ("reference", None, "reference"),
        ("kernel", None, "kernel"),
        ("reference", "kernel", "kernel"),  # the scoped choice wins
        ("kernel", "reference", "reference"),
        (None, "reference", "reference"),
    ],
)
def test_attention_impl_environment_variable_and_precedence(monkeypatch, env, scoped, want):
    if env is None:
        monkeypatch.delenv(tattn.IMPL_ENV, raising=False)
    else:
        monkeypatch.setenv(tattn.IMPL_ENV, env)
    assert tattn.IMPL_ENV == "ANOMALYCLIP_ATTN_IMPL"
    if scoped is None:
        assert tattn.current_impl() == want
        assert tattn._use_reference(_ON_CARD) is (want == "reference")
    else:
        with tattn.attention_impl(scoped):
            assert tattn.current_impl() == want
            assert tattn._use_reference(_ON_CARD) is (want == "reference")
        assert tattn.current_impl() == (env or "kernel")  # the scope closed
    assert tattn._use_reference(torch.zeros(1))  # a CPU tensor: the plain version, whatever is chosen


def test_attention_impl_environment_variable_rejects_unknown(monkeypatch):
    monkeypatch.setenv(tattn.IMPL_ENV, "pallas")
    with pytest.raises(ValueError, match="ANOMALYCLIP_ATTN_IMPL must be 'kernel' or 'reference'"):
        tattn.current_impl()
    with tattn.attention_impl("kernel"):  # a scope does not read it
        assert tattn.current_impl() == "kernel"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


_PATH_SHAPES = [(256, 197, 768, 12, False), (14, 77, 512, 8, True), (14, 77, 768, 12, True),
                (64, 257, 1024, 16, False)]
_RAGGED = [(3, l, 128, 2, causal) for l in (1, 63, 64, 65, 129) for causal in (False, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,d,heads,causal", _PATH_SHAPES + _RAGGED)
def test_tc_qkv_kernel_matches_blocked_plain(cuda, b, l, d, heads, causal):
    """K1 in bf16 at the towers' shapes and at the ragged edges: the
    tensor-core kernel, one launch, within ``TC_TOL`` of the KV-blocked plain
    version."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(b, l, 3 * d, device=cuda, generator=gen).bfloat16()
    tattn.reset_launch_counts()
    got = tattn.mha_qkv_fwd_kernel(qkv, heads, causal)
    want = tattn.mha_qkv_reference(qkv, heads, causal, BLOCK)
    torch.cuda.synchronize()
    assert tattn.launch_counts == _counts(fused_mha_qkv=1)
    assert tattn.route_counts == {"mha_tc": 1, "blocked_bwd_tc": 0, "mha_tf32": 0, "blocked_bwd_tf32": 0,
                                  "bld_tf32": 0, "bld_bwd_tf32": 0, "whole_bwd_tf32": 0}
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=TC_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,d,heads", [(256, 577, 1024, 16), (32, 577, 1024, 16), (3, 1, 128, 2),
                                         (3, 65, 128, 2), (3, 129, 64, 1)])
def test_tc_qtile_kernel_matches_blocked_plain(cuda, b, l, d, heads):
    """K6 in bf16 on q and kv as views of one packed projection."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(b, l, 3 * d, device=cuda, generator=gen).bfloat16()
    tattn.reset_launch_counts()
    got = tattn.mha_qtile_fwd_kernel(x[..., :d], x[..., d:], heads)
    want = tattn.mha_qtile_reference(x[..., :d], x[..., d:], heads, BLOCK)
    torch.cuda.synchronize()
    assert tattn.launch_counts == _counts(fused_mha_qtile=1)
    assert tattn.route_counts == {"mha_tc": 1, "blocked_bwd_tc": 0, "mha_tf32": 0, "blocked_bwd_tf32": 0,
                                  "bld_tf32": 0, "bld_bwd_tf32": 0, "whole_bwd_tf32": 0}
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=TC_TOL)


_FLASH_CASES = [(32, 16, 577, False), (32, 16, 1024, False), (32, 16, 500, True)] + [
    (3, 1, l, c) for l in (1, 63, 64, 65, 129) for c in (False, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,l,causal", _FLASH_CASES)
def test_tc_flash_kernel_matches_blocked_plain_and_repeats_to_the_bit(cuda, b, h, l, causal):
    """K8 in bf16 at head dim 64 on (B, H, L, dh) views: the tensor-core entry,
    one launch each, within ``TC_TOL`` of the plain version at the kernel's
    64-key block, the log-sum-exp within 1e-4 of the plain one, and two launches
    to the bit."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = torch.randn(3, b, h, l, 64, device=cuda, generator=gen).bfloat16()
    tattn.reset_launch_counts()
    (out, lse), (again, lse_again) = (tattn.flash_fwd_kernel(q, k, v, True, causal) for _ in range(2))
    want_out, want_lse = tattn.flash_attention_reference(q, k, v, True, BLOCK, causal)
    torch.cuda.synchronize()
    assert tattn.launch_counts == _counts(flash_attention_heads=2)
    assert tattn.route_counts == {"mha_tc": 2, "blocked_bwd_tc": 0, "mha_tf32": 0, "blocked_bwd_tf32": 0,
                                  "bld_tf32": 0, "bld_bwd_tf32": 0, "whole_bwd_tf32": 0}
    assert torch.equal(out, again) and torch.equal(lse, lse_again)
    torch.testing.assert_close(out.float(), want_out.float(), rtol=0, atol=TC_TOL)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_misaligned_and_fp32_operands_take_the_cuda_core_kernel_on_the_card(cuda):
    """fp32 below head dim 64 takes the CUDA-core kernel at any alignment; a
    view at head dim 64, bf16 or fp32, that cannot be read in 16-byte pieces
    raises, and launches nothing."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    wide = torch.randn(4, 77, 3 * 128 + 2, device=cuda, generator=gen)
    tattn.reset_launch_counts()
    x = wide[..., 1:-1]  # fp32, one element into the wider buffer
    torch.testing.assert_close(tattn.fused_mha_qkv(x, 4, True), tattn.mha_qkv_reference(x, 4, True),
                               rtol=0, atol=FP32_TOL)
    assert tattn.launch_counts == _counts(fused_mha_qkv=1)
    assert tattn.route_counts == {"mha_tc": 0, "blocked_bwd_tc": 0, "mha_tf32": 0, "blocked_bwd_tf32": 0,
                                  "bld_tf32": 0, "bld_bwd_tf32": 0, "whole_bwd_tf32": 0}
    for misaligned in (wide.bfloat16()[..., 1:-1], x):
        with pytest.raises(ValueError, match="16-byte pieces"):
            tattn.fused_mha_qkv(misaligned, 2, True)
    assert tattn.launch_counts == _counts(fused_mha_qkv=1)


def _close_to_top(got, want, tol):
    for ours, theirs in zip(got, want):
        torch.testing.assert_close(ours.float(), theirs.float(), rtol=0,
                                   atol=tol * theirs.float().abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)])
def test_shapes_no_kernel_takes_compute_on_the_card(cuda, dtype, tol):
    """The shapes that once had no kernel: head dim 8 (the whole-row kernels) and
    a causal L=500 at head dim 64 (the flash kernel and the KV-blocked pair with
    the mask), forward and backward, each a launch and each within tolerance of
    the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q8 = torch.randn(2, 4, 40, 8, device=cuda, generator=gen).to(dtype).requires_grad_(True)
    q500 = torch.randn(2, 4, 500, 64, device=cuda, generator=gen).to(dtype).requires_grad_(True)
    x8 = torch.randn(6, 16, 3 * 32, device=cuda, generator=gen).to(dtype).requires_grad_(True)

    def run():
        outs = (tattn.fused_attention(q8, q8, q8), tattn.fused_attention(q500, q500, q500, True),
                tattn.fused_mha_bld(x8[..., :32], x8[..., 32:64], x8[..., 64:], 4))
        loss = sum((o.float() ** 2).sum() for o in outs)
        return (*outs, *torch.autograd.grad(loss, (q8, q500, x8)))

    tattn.reset_launch_counts()
    got = run()
    torch.cuda.synchronize()
    assert tattn.launch_counts == _counts(fused_attention=2, flash_attention_heads=1, flash_dq=1,
                                          flash_dkv=1, fused_mha_bld=1, mha_bld_bwd=1)
    with tattn.attention_impl("reference"):
        want = run()
    assert sum(tattn.launch_counts.values()) == 7
    _close_to_top(got, want, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("dh", [8, 16, 32, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_kv_blocked_kernels_at_every_head_dim_and_mask(cuda, dtype, tol, dh, causal):
    """K8, K9 and K10, and the KV-blocked pair behind K4's entry, at every head
    dim, ragged on both axes (L = 2 * 128 + 64 + 13), with and without the
    mask."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, g = torch.randn(4, 6, 333, dh, device=cuda, generator=gen).to(dtype)
    tattn.reset_launch_counts()
    out, lse = tattn.flash_fwd_kernel(q, k, v, True, causal)
    want_out, want_lse = tattn.flash_attention_reference(q, k, v, True, causal=causal)
    _close_to_top([out, lse], [want_out, want_lse], tol)
    _close_to_top(tattn.flash_bwd_kernel(q, k, v, g, lse, out, causal),
                  tattn.flash_attention_bwd_reference(q, k, v, g, lse, out, causal), tol)
    bld = [t.transpose(0, 1).reshape(333, 6 * dh).unsqueeze(0) for t in (q, k, v, g)]
    _close_to_top(tattn.mha_bld_bwd_kernel(*bld, 6, causal),
                  tattn.mha_bld_bwd_reference(*bld, 6, causal), tol)
    torch.cuda.synchronize()
    assert tattn.launch_counts == _counts(flash_attention_heads=1, flash_dq=1, flash_dkv=1, mha_bld_bwd=1)


@pytest.mark.gpu
def test_environment_variable_chooses_the_plain_versions_on_the_card(cuda, monkeypatch):
    qkv = torch.randn(2, 77, 3 * 128, device=cuda).bfloat16()
    monkeypatch.setenv(tattn.IMPL_ENV, "reference")
    tattn.reset_launch_counts()
    got = tattn.fused_mha_qkv(qkv, 2, True)
    assert tattn.launch_counts == _counts() and torch.equal(got, tattn.mha_qkv_reference(qkv, 2, True, BLOCK))
    with tattn.attention_impl("kernel"):
        tattn.fused_mha_qkv(qkv, 2, True)
    assert tattn.launch_counts == _counts(fused_mha_qkv=1)
