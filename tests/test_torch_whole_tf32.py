"""The split-TF32 whole-head backward (ops/csrc/mha_whole_tf32_bwd.cu) behind K3
(``mha_qkv_bwd``), K4 (``mha_bld_bwd``) and K5's backward in fp32 at head dim
64 with L <= 112: the CoOp gradient through the causal text tower; and K5's
whole-block forward at head dim 64 on K8's tensor-core entries.

On the CPU:

- the plain K3 against ``_mha_qkv_bwd_impl`` in Pallas interpret mode at the
  text tower's width (8 heads of 64, L = 77), causal and not, within 1e-5 of
  max|ref|;
- the emulation of the kernel's arithmetic (``mha_bld_bwd_tf32x3_reference``
  on the unpacked q, k, v: every product formed from the operands' TF32 parts)
  against the fp32 plain backward within the same limit at L = 1, 7, 16, 33,
  77, 80 and 112, causal and not; plain TF32's (``passes=1``) must miss it;
- ``mha_whole_tf32_eligible`` on each side of every edge (dtype, head dim,
  L = 0/1 and 112/113), and the kernel's shared memory against hand-computed
  bytes;
- the wrappers' Python with the library replaced by numpy: the entry and the
  strides each route receives (K3's packed qkv, K4's k and v as the two halves
  of one kv, K5's heads folded), the route count ``whole_bwd_tf32``, the shapes
  that stay on mha_bwd.cu (bf16, head dim 32, L = 113 and 117), and the
  refusals, which raise before any launch;
- K5's bf16 plain version at the tensor-core kernel's KV block against the JAX
  ``fused_attention`` in interpret mode at 5e-2, and K5's whole-block forward
  at head dim 64 taking ``acl_flash_tf32_fwd`` (fp32) and ``acl_flash_tc_fwd``
  (bf16) on the views in place.

The ``gpu`` cases hold the kernel against the fp32 plain backward and the
emulation on the card at the text towers' shapes and at ragged lengths,
causal and not, and to the bit between two launches, and K5's forward against
its plain version; they import no JAX.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from anomalyclip_tpu_torch.ops import attention as tattn

# the kernel and its emulation against the fp32 plain backward, of max|ref|: the
# limit every fp32 kernel of the port is held to
FP32_TOL = 1e-5
BF16_TOL = 5e-2
RAGGED = [1, 7, 16, 33, 77, 80, 112]


@pytest.fixture(scope="module")
def jax_side():
    """(jax.numpy, the JAX package's Pallas attention module), JAX on the CPU as
    tests/conftest.py sets it: on a GPU JAX would run fp32 products in TF32."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    from anomalyclip_tpu.ops.pallas import attention

    return jax.numpy, attention


def _randn(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _gap(got, want) -> float:
    """max|got - want| over max|want|, across the tensors of two tuples."""
    top = max(float(np.abs(np.asarray(w, dtype=np.float32)).max()) for w in want)
    return max(float(np.abs(np.asarray(g, dtype=np.float32) - np.asarray(w, dtype=np.float32)).max())
               for g, w in zip(got, want)) / top


def _unpacked_emulation(qkv, g, heads, causal, passes=3):
    """The emulation of the kernel over K3's packed qkv -> the packed dqkv."""
    return torch.cat(tattn.mha_bld_bwd_tf32x3_reference(*tattn._unpack_qkv(qkv), g, heads, causal,
                                                         passes=passes), dim=-1)


# ---------------------------------------------------------------------------
# the plain K3 against the Pallas kernel, at the text tower's width
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
def test_plain_k3_matches_pallas_at_the_text_width(jax_side, causal):
    jnp, jattn = jax_side
    rng = np.random.default_rng(80 + causal)
    qkv, g = _randn(rng, 2, 77, 3 * 512), _randn(rng, 2, 77, 512)
    got = tattn.mha_qkv_bwd_reference(qkv, g, 8, causal)
    want = jattn._mha_qkv_bwd_impl(jnp.asarray(qkv.numpy()), jnp.asarray(g.numpy()), 8, causal, True)
    assert got.shape == qkv.shape
    assert _gap([got], [want]) <= FP32_TOL


# ---------------------------------------------------------------------------
# the emulation of the kernel's arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("l", RAGGED)
def test_emulation_matches_the_fp32_plain_backward(l, causal):
    """At the text tower's 8 heads of 64, on K3's packed qkv unpacked."""
    rng = np.random.default_rng(90 + l)
    qkv, g = _randn(rng, 2, l, 3 * 512), _randn(rng, 2, l, 512)
    got = _unpacked_emulation(qkv, g, 8, causal)
    assert got.shape == qkv.shape and got.dtype == torch.float32
    assert _gap([got], [tattn.mha_qkv_bwd_reference(qkv, g, 8, causal)]) <= FP32_TOL


@pytest.mark.parametrize("causal", [True, False])
def test_plain_tf32_emulation_misses_the_fp32_limit(causal):
    """One product of the big parts alone (TF32 as such) lands well past 1e-5
    of max|ref| from the fp32 plain backward: why the kernel forms three."""
    rng = np.random.default_rng(95)
    qkv, g = _randn(rng, 4, 77, 3 * 512), _randn(rng, 4, 77, 512)
    want = tattn.mha_qkv_bwd_reference(qkv, g, 8, causal)
    assert _gap([_unpacked_emulation(qkv, g, 8, causal, passes=1)], [want]) > FP32_TOL


# ---------------------------------------------------------------------------
# what the kernel takes and needs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "dtype,dh,l,eligible",
    [
        (torch.float32, 64, 77, True), (torch.float32, 64, 1, True), (torch.float32, 64, 112, True),
        (torch.float32, 64, 113, False), (torch.float32, 64, 117, False), (torch.float32, 64, 0, False),
        (torch.float32, 32, 77, False), (torch.float32, 16, 16, False), (torch.float32, 8, 16, False),
        (torch.bfloat16, 64, 77, False), (torch.float16, 64, 77, False),
    ],
)
def test_eligibility_at_every_edge(dtype, dh, l, eligible):
    assert tattn.mha_whole_tf32_eligible(dtype, dh, l) is eligible


def test_shared_memory_against_hand_computed_bytes():
    # q, k, v, g tiles of L rounded up to 16 rows at 64 + 4 floats, the P and dS
    # tiles of as many rows at that count + 4
    assert tattn.mha_whole_tf32_smem_bytes(77) == 4 * (4 * 80 * 68 + 2 * 80 * 84) == 140_800
    assert tattn.mha_whole_tf32_smem_bytes(80) == 140_800
    assert tattn.mha_whole_tf32_smem_bytes(1) == 4 * (4 * 16 * 68 + 2 * 16 * 20) == 19_968
    assert tattn.mha_whole_tf32_smem_bytes(112) == 4 * (4 * 112 * 68 + 2 * 112 * 116) == 225_792
    assert tattn.mha_whole_tf32_smem_bytes(113) == 4 * (4 * 128 * 68 + 2 * 128 * 132) == 274_432
    # the longest head: the last length whose tiles fit an H100's block
    assert tattn.WHOLE_TF32_MAX_L == 112
    assert 225_792 <= tattn.H100_SMEM_OPTIN < 274_432
    # past it the whole-head kernel of mha_bwd.cu still fits up to L = 117
    assert tattn.attention_bwd_route(117, 64, 4) == "whole"
    assert tattn.attention_bwd_route(118, 64, 4) == "blocked"


# ---------------------------------------------------------------------------
# the wrappers' Python, the library replaced by numpy
# ---------------------------------------------------------------------------


def _address(p) -> int:
    """A pointer argument as the wrappers pass it: an int or a ctypes c_void_p."""
    return p.value if isinstance(p, ctypes.c_void_p) else p


def _raw(address, strides, shape, ctype=ctypes.c_float):
    """An ndarray over ``shape`` elements at ``address`` with element ``strides``."""
    span = 1 + sum((n - 1) * s for n, s in zip(shape, strides))
    flat = np.ctypeslib.as_array(ctypes.cast(_address(address), ctypes.POINTER(ctype)), (span,))
    size = ctypes.sizeof(ctype)
    return np.lib.stride_tricks.as_strided(flat, shape, tuple(size * s for s in strides))


def _read(address, strides, shape, bf16=False):
    if not bf16:
        return _raw(address, strides, shape).astype(np.float64)
    bits = _raw(address, strides, shape, ctypes.c_uint16).astype(np.uint32) << 16
    return bits.view(np.float32).astype(np.float64)


def _write(address, strides, shape, values, bf16=False):
    if not bf16:
        _raw(address, strides, shape)[...] = values
        return
    rounded = torch.from_numpy(np.ascontiguousarray(values, np.float32)).bfloat16().view(torch.int16)
    _raw(address, strides, shape, ctypes.c_uint16)[...] = rounded.numpy().view(np.uint16)


def _heads(t, h):
    b, l, d = t.shape
    return t.reshape(b, l, h, d // h).transpose(0, 2, 1, 3)


def _merge(t):
    b, h, l, dh = t.shape
    return t.transpose(0, 2, 1, 3).reshape(b, l, h * dh)


def _probabilities(q, k, causal, scale):
    s = np.einsum("...qd,...kd->...qk", q, k) * scale
    if causal:
        s = np.where(np.tril(np.ones(s.shape[-2:], bool)), s, -1e30)
    e = np.exp(s - s.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def _backward(q, k, v, g, causal, scale):
    """float64 (..., L, dh) -> (dq, dk, dv) of softmax attention."""
    p = _probabilities(q, k, causal, scale)
    dp = np.einsum("...qd,...kd->...qk", g, v)
    ds = p * (dp - (p * dp).sum(axis=-1, keepdims=True)) * scale
    return (np.einsum("...qk,...kd->...qd", ds, k), np.einsum("...qk,...qd->...kd", ds, q),
            np.einsum("...qk,...qd->...kd", p, g))


class NumpyWhole:
    """The entries the whole-head backwards and K5's forward launch, in numpy
    (float64 on the decoded operands, read and written through the raw
    pointers and element strides the wrappers pass): the split-TF32 whole-head
    backward's two, K1's split-TF32 forward, mha_bwd.cu's two (computed in
    fp32, recorded in bf16), K8's tensor-core entries and mha.cu's K2 entry.
    Every call is recorded with its entry, pointers and strides."""

    def __init__(self):
        self.calls = []

    def acl_mha_qkv_whole_tf32_bwd(self, qkv, bs, rs, g, dqkv, b, l, h, dh, causal, scale, stream):
        self.calls.append(("qkv_whole", (_address(qkv), bs, rs), _address(g), causal))
        self._qkv_bwd(qkv, bs, rs, g, dqkv, b, l, h, dh, causal, scale)
        return 0

    def acl_mha_qkv_bwd(self, dtype, qkv, bs, rs, g, dqkv, b, l, h, dh, causal, scale, stream):
        self.calls.append(("qkv_bwd", (_address(qkv), bs, rs), _address(g), causal))
        if dtype == 0:
            self._qkv_bwd(qkv, bs, rs, g, dqkv, b, l, h, dh, causal, scale)
        return 0

    def _qkv_bwd(self, qkv, bs, rs, g, dqkv, b, l, h, dh, causal, scale):
        d = h * dh
        x = _read(qkv, (bs, rs, 1), (b, l, 3 * d))
        heads = [_heads(x[..., i * d:(i + 1) * d], h) for i in range(3)]
        grads = _backward(*heads, _heads(_read(g, (l * d, d, 1), (b, l, d)), h), causal, scale)
        _write(dqkv, (3 * l * d, 3 * d, 1), (b, l, 3 * d), np.concatenate([_merge(t) for t in grads], -1))

    def _bld_bwd(self, tag, ops, outs, b, l, h, dh, causal, scale, compute=True):
        self.calls.append((tag, [(_address(p), bs, rs) for p, bs, rs in ops], causal))
        if not compute:
            return 0
        shape = (b, l, h * dh)
        grads = _backward(*(_heads(_read(p, (bs, rs, 1), shape), h) for p, bs, rs in ops), causal, scale)
        for out, grad in zip(outs, grads):
            _write(out, (l * h * dh, h * dh, 1), shape, _merge(grad))
        return 0

    def acl_mha_bld_whole_tf32_bwd(self, q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, g, g_bs, g_rs,
                                   dq, dk, dv, b, l, h, dh, causal, scale, stream):
        ops = ((q, q_bs, q_rs), (k, k_bs, k_rs), (v, v_bs, v_rs), (g, g_bs, g_rs))
        return self._bld_bwd("bld_whole", ops, (dq, dk, dv), b, l, h, dh, causal, scale)

    def acl_mha_bld_bwd(self, dtype, q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, g, g_bs, g_rs,
                        dq, dk, dv, b, l, h, dh, causal, scale, stream):
        ops = ((q, q_bs, q_rs), (k, k_bs, k_rs), (v, v_bs, v_rs), (g, g_bs, g_rs))
        return self._bld_bwd("bld_bwd", ops, (dq, dk, dv), b, l, h, dh, causal, scale, dtype == 0)

    def acl_mha_qkv_tf32_fwd(self, qkv, bs, rs, out, b, l, h, dh, causal, scale, stream):
        self.calls.append(("qkv_tf32", (_address(qkv), bs, rs), causal))
        d = h * dh
        x = _read(qkv, (bs, rs, 1), (b, l, 3 * d))
        q, k, v = (_heads(x[..., i * d:(i + 1) * d], h) for i in range(3))
        o = np.einsum("...qk,...kd->...qd", _probabilities(q, k, causal, scale), v)
        _write(out, (l * d, d, 1), (b, l, d), _merge(o))
        return 0

    def _flash(self, tag, bf16, ptrs, strides, lse, b, h, l, dh, causal, scale):
        addresses = [ptrs[i] for i in range(4)]
        self.calls.append((tag, tuple(addresses), tuple(strides[i] for i in range(12)), causal,
                           lse.value))
        shape = (b, h, l, dh)
        q, k, v = (_read(addresses[i], (*(strides[3 * i + j] for j in range(3)), 1), shape, bf16)
                   for i in range(3))
        o = np.einsum("...qk,...kd->...qd", _probabilities(q, k, causal, scale), v)
        _write(addresses[3], (*(strides[9 + j] for j in range(3)), 1), shape, o, bf16)
        return 0

    def acl_flash_tf32_fwd(self, ptrs, strides, lse, b, h, l, dh, causal, scale, stream):
        return self._flash("flash_tf32", False, ptrs, strides, lse, b, h, l, dh, causal, scale)

    def acl_flash_tc_fwd(self, ptrs, strides, lse, b, h, l, dh, causal, scale, stream):
        return self._flash("flash_tc", True, ptrs, strides, lse, b, h, l, dh, causal, scale)

    def acl_mha_bld_fwd(self, dtype, q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, out, b, l, h, dh,
                        causal, scale, stream):
        ops = ((q, q_bs, q_rs), (k, k_bs, k_rs), (v, v_bs, v_rs))
        self.calls.append(("bld_fwd", [(_address(p), bs, rs) for p, bs, rs in ops], causal))
        shape = (b, l, h * dh)
        q, k, v = (_heads(_read(p, (bs, rs, 1), shape), h) for p, bs, rs in ops)
        o = np.einsum("...qk,...kd->...qd", _probabilities(q, k, causal, scale), v)
        _write(out, (l * h * dh, h * dh, 1), shape, _merge(o))
        return 0


class _AsCuda:
    """Something with a shape and a dtype that says it is on the card, for the
    wrappers' shape checks."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda")

    def __getattr__(self, name):
        return getattr(self._t, name)


@pytest.fixture
def numpy_whole(monkeypatch):
    """The kernel launches on CPU tensors: the library in numpy; the device check,
    the card's limit (an H100's) and the stream lookup out of the way; the
    wrappers' cache of checked shapes empty before and after."""
    fake = NumpyWhole()
    monkeypatch.setattr(tattn, "load_library", lambda: fake)
    monkeypatch.setattr(tattn, "_stream", lambda t: None)
    monkeypatch.setattr(tattn, "smem_limit", lambda device: tattn.H100_SMEM_OPTIN)
    real_check = tattn._check_kernel_shape
    monkeypatch.setattr(tattn, "_check_kernel_shape",
                        lambda name, t, *args: real_check(name, _AsCuda(t), *args))
    tattn._bld_tf32_plan.cache_clear()
    tattn.reset_launch_counts()
    yield fake
    tattn._bld_tf32_plan.cache_clear()


def _routes(**expected):
    return {k: expected.get(k, 0) for k in tattn.route_counts}


def _counts(**expected):
    return {k: expected.get(k, 0) for k in tattn.launch_counts}


@pytest.mark.parametrize("l,causal", [(77, True), (77, False), (1, True), (112, False), (33, True)])
def test_k3_wrapper_takes_the_packed_entry(numpy_whole, l, causal):
    """The packed qkv handed over as it lies (base address, 64-bit batch and row
    element strides), g contiguous, the packed dqkv written."""
    rng = np.random.default_rng(100 + l)
    qkv, g = _randn(rng, 2, l, 3 * 512), _randn(rng, 2, l, 512)
    dqkv = tattn.mha_qkv_bwd_kernel(qkv, g, 8, causal)
    assert dqkv.shape == qkv.shape and dqkv.is_contiguous()
    assert _gap([dqkv], [tattn.mha_qkv_bwd_reference(qkv, g, 8, causal)]) <= FP32_TOL
    assert numpy_whole.calls == [("qkv_whole", (qkv.data_ptr(), l * 1536, 1536), g.data_ptr(), int(causal))]
    assert tattn.launch_counts == _counts(mha_qkv_bwd=1)
    assert tattn.route_counts == _routes(whole_bwd_tf32=1)


def test_k3_wrapper_reads_a_column_slice_of_a_wider_tensor_in_place(numpy_whole):
    """A qkv whose rows are longer than 3D (the projection's columns sliced)
    keeps its row stride; a non-contiguous g is made contiguous first."""
    rng = np.random.default_rng(110)
    wide, g = _randn(rng, 2, 77, 3 * 512 + 64), _randn(rng, 2, 512, 77).transpose(1, 2)
    qkv = wide[..., :1536]
    dqkv = tattn.mha_qkv_bwd_kernel(qkv, g, 8, True)
    assert _gap([dqkv], [tattn.mha_qkv_bwd_reference(qkv, g, 8, True)]) <= FP32_TOL
    (entry, operand, g_address, _), = numpy_whole.calls
    assert (entry, operand) == ("qkv_whole", (wide.data_ptr(), 77 * 1600, 1600))
    assert g_address != g.data_ptr()


@pytest.mark.parametrize("l,causal", [(77, False), (50, True)])
def test_k4_wrapper_takes_the_separate_entry_reading_k_and_v_in_place(numpy_whole, l, causal):
    """K4 at head dim 64: q and the two halves of one kv, handed over as base
    addresses and (batch, row) element strides, no copy."""
    rng = np.random.default_rng(120 + l)
    q, kv, g = _randn(rng, 2, l, 128), _randn(rng, 2, l, 256), _randn(rng, 2, l, 128)
    k, v = kv[..., :128], kv[..., 128:]
    grads = tattn.mha_bld_bwd_kernel(q, k, v, g, 2, causal)
    assert all(t.shape == q.shape and t.is_contiguous() for t in grads)
    assert _gap(grads, tattn.mha_bld_bwd_reference(q, k, v, g, 2, causal)) <= FP32_TOL
    assert numpy_whole.calls == [("bld_whole", [(q.data_ptr(), l * 128, 128), (k.data_ptr(), l * 256, 256),
                                                (k.data_ptr() + 4 * 128, l * 256, 256),
                                                (g.data_ptr(), l * 128, 128)], int(causal))]
    assert tattn.launch_counts == _counts(mha_bld_bwd=1)
    assert tattn.route_counts == _routes(whole_bwd_tf32=1)


@pytest.mark.parametrize("causal", [False, True])
def test_k5_backward_folds_its_heads_into_the_separate_entry(numpy_whole, causal):
    """K5's backward at head dim 64: the heads folded into the batch, one head
    an entry, on ``acl_mha_bld_whole_tf32_bwd``."""
    rng = np.random.default_rng(130)
    q, k, v, g = (_randn(rng, 2, 3, 50, 64) for _ in range(4))
    grads = tattn.fused_attention_bwd_kernel(q, k, v, g, causal)
    assert all(t.shape == q.shape for t in grads)
    assert _gap(grads, tattn.attention_bwd_reference(q, k, v, g, causal)) <= FP32_TOL
    assert numpy_whole.calls == [("bld_whole", [(t.data_ptr(), 50 * 64, 64) for t in (q, k, v, g)],
                                  int(causal))]
    assert tattn.launch_counts == _counts(fused_attention=1)
    assert tattn.route_counts == _routes(whole_bwd_tf32=1)


def test_autograd_through_the_text_tower_entry(numpy_whole, monkeypatch):
    """Through ``fused_mha_qkv`` with the kernels chosen, as the text tower's
    CoOp gradient runs: K1 on ``acl_mha_qkv_tf32_fwd``, K3 on the new entry."""
    monkeypatch.setattr(tattn, "_use_reference", lambda t: False)
    qkv = _randn(np.random.default_rng(140), 2, 77, 3 * 512).requires_grad_(True)
    (got,) = torch.autograd.grad((tattn.fused_mha_qkv(qkv, 8, True) ** 2).sum(), qkv)
    assert [c[0] for c in numpy_whole.calls] == ["qkv_tf32", "qkv_whole"]
    assert tattn.route_counts == _routes(mha_tf32=1, whole_bwd_tf32=1)
    (want,) = torch.autograd.grad((tattn.mha_qkv_reference(qkv, 8, True) ** 2).sum(), qkv)
    assert _gap([got], [want]) <= FP32_TOL


@pytest.mark.parametrize(
    "dtype,l,d,heads",
    [(torch.bfloat16, 77, 512, 8), (torch.float32, 113, 128, 2), (torch.float32, 117, 128, 2),
     (torch.float32, 77, 256, 8)],
    ids=["bf16", "L=113", "L=117", "head dim 32"],
)
def test_other_shapes_keep_mha_bwd_cu(numpy_whole, dtype, l, d, heads):
    """bf16, L past 112 while the whole-head kernel of mha_bwd.cu still fits,
    and head dim 32 launch mha_bwd.cu from both entries, with no route count."""
    rng = np.random.default_rng(150)
    qkv, g = _randn(rng, 2, l, 3 * d, dtype=dtype), _randn(rng, 2, l, d, dtype=dtype)
    tattn.mha_qkv_bwd_kernel(qkv, g, heads, True)
    tattn.mha_bld_bwd_kernel(*tattn._unpack_qkv(qkv), g, heads, False)
    assert [c[0] for c in numpy_whole.calls] == ["qkv_bwd", "bld_bwd"]
    assert tattn.launch_counts == _counts(mha_qkv_bwd=1, mha_bld_bwd=1)
    assert tattn.route_counts == _routes()


def test_misaligned_operands_are_refused_before_any_launch(numpy_whole):
    """qkv one float off 16 bytes, a row stride that is not a multiple of 4
    floats, a contiguous g one float off: each entry raises, with the shape."""
    x = torch.zeros(2, 16, 3 * 128 + 4)[..., 1:-3]
    g = torch.zeros(2, 16, 128)
    with pytest.raises(ValueError, match=r"mha_qkv_bwd: .*16-byte pieces; shape \(2, 16, 384\)"):
        tattn.mha_qkv_bwd_kernel(x, g, 2, True)
    with pytest.raises(ValueError, match=r"mha_bld_bwd: .*16-byte pieces; shape \(2, 16, 128\)"):
        tattn.mha_bld_bwd_kernel(x[..., :128], x[..., 128:256], x[..., 256:], g, 2, False)
    odd = torch.zeros(2, 16, 3 * 128 + 1)
    with pytest.raises(ValueError, match=r"shape \(2, 16, 128\) with strides \(6160, 385, 1\)"):
        tattn.mha_bld_bwd_kernel(odd[..., :128], odd[..., 128:256], odd[..., 256:384], g, 2, False)
    off = torch.zeros(2 * 16 * 128 + 1)[1:].view(2, 16, 128)
    with pytest.raises(ValueError, match=r"mha_qkv_bwd: .*16-byte pieces; shape \(2, 16, 128\)"):
        tattn.mha_qkv_bwd_kernel(torch.zeros(2, 16, 384), off, 2, True)
    assert numpy_whole.calls == [] and tattn.launch_counts == _counts() and tattn.route_counts == _routes()


def test_a_mismatched_gradient_is_refused_with_its_shape(numpy_whole):
    with pytest.raises(ValueError, match=r"mha_qkv_bwd: gradient \(2, 16, 64\) for qkv \(2, 16, 384\)"):
        tattn.mha_qkv_bwd_kernel(torch.zeros(2, 16, 384), torch.zeros(2, 16, 64), 2, True)
    with pytest.raises(ValueError, match=r"mha_bld_bwd: operands must agree: .*\(2, 8, 128\)"):
        tattn.mha_bld_bwd_kernel(*torch.zeros(3, 2, 16, 128), torch.zeros(2, 8, 128), 2, False)
    assert numpy_whole.calls == [] and tattn.route_counts == _routes()


def test_a_cpu_tensor_is_refused_by_the_kernel_route():
    """Without the numpy stand-in the wrappers' device check holds: the kernel
    takes CUDA tensors."""
    tattn._bld_tf32_plan.cache_clear()
    with pytest.raises(ValueError, match="mha_qkv_bwd: the kernel takes CUDA tensors, not cpu"):
        tattn.mha_qkv_bwd_kernel(torch.zeros(2, 16, 384), torch.zeros(2, 16, 128), 2, True)
    with pytest.raises(ValueError, match="fused_attention: the kernel takes CUDA tensors, not cpu"):
        tattn.fused_attention_bwd_kernel(*torch.zeros(4, 1, 2, 16, 64), False)


# ---------------------------------------------------------------------------
# K5's whole-block forward at head dim 64
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,entry,route", [(torch.float32, "flash_tf32", "mha_tf32"),
                                               (torch.bfloat16, "flash_tc", "mha_tc")])
def test_k5_forward_at_head_dim_64_takes_the_tensor_core_entry(numpy_whole, dtype, entry, route, causal):
    """The (B, H, L, Dh) views of one packed projection, read in place through
    (batch, head, row) strides, no log-sum-exp; the output in the (B, L, H, Dh)
    layout that folds back without a copy."""
    packed = _randn(np.random.default_rng(160), 2, 77, 3, 4, 64, dtype=dtype)
    q, k, v = packed.permute(2, 0, 3, 1, 4)
    out = tattn.fused_attention_fwd_kernel(q, k, v, causal)
    assert out.shape == q.shape and out.dtype == dtype and out.transpose(1, 2).is_contiguous()
    want = tattn.fused_attention_reference(q, k, v, causal, tattn.reference_block(dtype, 64))
    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    assert float((out.float() - want.float()).abs().max()) <= tol
    (tag, addresses, strides, took_causal, lse), = numpy_whole.calls
    assert (tag, took_causal, lse) == (entry, int(causal), None)
    assert addresses == (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    assert strides == (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    assert tattn.launch_counts == _counts(fused_attention=1)
    assert tattn.route_counts == _routes(**{route: 1})


def test_k5_forward_keeps_the_whole_block_admission_limit(numpy_whole):
    """A shape past the whole-row kernel's shared memory (fp32 K and V of a
    head at L=577) is refused at head dim 64 too, before any launch, though the
    tensor-core kernel would take it: ``fused_attention`` sends it to its
    flash branch."""
    with pytest.raises(ValueError, match=r"fused_attention: shape \(1, 2, 577, 64\) needs .* shared memory"):
        tattn.fused_attention_fwd_kernel(*torch.zeros(3, 1, 2, 577, 64), True)
    assert numpy_whole.calls == [] and tattn.launch_counts == _counts() and tattn.route_counts == _routes()


def test_k5_forward_at_smaller_head_dims_keeps_mha_cu(numpy_whole):
    """Head dim 32: K2's CUDA-core entry with the heads folded, no route count."""
    q, k, v = (_randn(np.random.default_rng(170), 2, 3, 40, 32) for _ in range(3))
    out = tattn.fused_attention_fwd_kernel(q, k, v, False)
    assert float((out - tattn.attention_reference(q, k, v)).abs().max()) <= FP32_TOL
    assert [c[0] for c in numpy_whole.calls] == ["bld_fwd"]
    assert tattn.launch_counts == _counts(fused_attention=1) and tattn.route_counts == _routes()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 4, 77, 64), (2, 2, 197, 64)])
def test_k5_bf16_blocked_plain_matches_pallas(jax_side, shape, causal):
    """K5's bf16 plain version at the tensor-core kernel's KV block, which the
    entry's reference branch runs, against the JAX ``fused_attention`` in
    interpret mode."""
    jnp, jattn = jax_side
    arrays = [np.random.default_rng(180 + i).standard_normal(shape).astype(np.float32) for i in range(3)]
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrays)
    block = tattn.reference_block(torch.bfloat16, 64)
    assert block == tattn.MHA_TC_BLOCK_KV
    got = tattn.fused_attention_reference(q, k, v, causal, block)
    assert torch.equal(tattn.fused_attention(q, k, v, causal), got)
    want = np.asarray(jattn.fused_attention(*(jnp.asarray(a, jnp.bfloat16) for a in arrays), causal, True),
                      dtype=np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL, atol=BF16_TOL)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


_CARD_SHAPES = [(14, 77, 512, 8, True), (14, 77, 768, 12, True), (14, 77, 512, 8, False),
                *((3, l, 128, 2, c) for l in RAGGED for c in (False, True))]


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,d,heads,causal", _CARD_SHAPES)
def test_k3_matches_plain_and_emulation_and_repeats_to_the_bit(cuda, b, l, d, heads, causal):
    """K3 at the text towers' shapes and at ragged lengths, causal and not."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    qkv, g = (torch.randn(b, l, w, device=cuda, generator=gen) for w in (3 * d, d))
    tattn.reset_launch_counts()
    once, again = (tattn.mha_qkv_bwd_kernel(qkv, g, heads, causal) for _ in range(2))
    torch.cuda.synchronize()
    assert tattn.route_counts["whole_bwd_tf32"] == 2 and torch.equal(once, again)
    assert bool(torch.isfinite(once).all())
    for want in (tattn.mha_qkv_bwd_reference(qkv, g, heads, causal),
                 _unpacked_emulation(qkv, g, heads, causal)):
        assert _gap([once.cpu()], [want.cpu()]) <= FP32_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("l,causal", [(77, True), (112, False), (113, False)])
def test_k4_and_k5_backward_on_the_card(cuda, l, causal):
    """K4 at head dim 64 with k and v the halves of one kv, and K5's backward
    with the heads folded: the new kernel up to L = 112, mha_bwd.cu at 113."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, kv, g = (torch.randn(4, l, w, device=cuda, generator=gen) for w in (128, 256, 128))
    k, v = kv[..., :128], kv[..., 128:]
    tattn.reset_launch_counts()
    grads = tattn.mha_bld_bwd_kernel(q, k, v, g, 2, causal)
    heads = [t.view(4, l, 2, 64).transpose(1, 2) for t in (q, k, v, g)]
    folded = tattn.fused_attention_bwd_kernel(*heads, causal)
    torch.cuda.synchronize()
    assert tattn.route_counts["whole_bwd_tf32"] == (2 if l <= 112 else 0)
    for got, want in ((grads, tattn.mha_bld_bwd_reference(q, k, v, g, 2, causal)),
                      (folded, tattn.attention_bwd_reference(*heads, causal))):
        assert _gap([t.cpu() for t in got], [t.cpu() for t in want]) <= FP32_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_forward_on_the_tensor_core_kernels(cuda, dtype, causal):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = torch.randn(3, 8, 12, 197, 64, device=cuda, generator=gen).to(dtype)
    tattn.reset_launch_counts()
    out = tattn.fused_attention_fwd_kernel(q, k, v, causal)
    torch.cuda.synchronize()
    assert tattn.route_counts["mha_tf32" if dtype == torch.float32 else "mha_tc"] == 1
    want = tattn.fused_attention_reference(q, k, v, causal, tattn.reference_block(dtype, 64))
    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    assert float((out.float() - want.float()).abs().max()) <= tol
