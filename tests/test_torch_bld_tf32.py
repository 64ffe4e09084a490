"""The split-TF32 whole-head kernels (ops/csrc/mha_bld_tf32.cu) behind K2
(``fused_mha_bld``) and K4 (its backward) in fp32 at head dims 16 and 32 with
L <= 32: the temporal model's axial attention, and the routing around them.

On the CPU:

- the plain K2 and K4 against ``fused_mha_bld`` and ``_mha_bld_bwd_impl`` in
  Pallas interpret mode at the temporal model's width (8 heads of 32 at emb
  256, of 16 at emb 128), within 1e-5 (of max|ref| for the backward);
- the emulations of the kernels' arithmetic (``mha_bld_tf32x3_reference``,
  ``mha_bld_bwd_tf32x3_reference``: every product formed from the operands'
  TF32 parts) against the fp32 plain versions within the same limits at L = 1,
  7, 16, 31 and 32, causal and not; plain TF32's emulation (``passes=1``) must
  not sit within them;
- ``mha_bld_tf32_eligible`` on each side of every admission edge, and the
  backward's shared memory against hand-computed bytes;
- the wrappers' Python with the library replaced by numpy: the entry and the
  strides each route receives for k and v as the two halves of one kv, the
  route counts ``bld_tf32`` and ``bld_bwd_tf32``, the shapes that stay on
  mha.cu and mha_bwd.cu, and the refusals, which raise before any launch.

The ``gpu`` cases hold both kernels against the fp32 plain versions and the
emulations on the card, at the temporal model's shapes (XD-Violence's at head
dim 16 too), at ragged and causal lengths and at a batch past 65,535, and to
the bit between two launches; they import no JAX.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from anomalyclip_tpu_torch.ops import attention as tattn

# the kernels and their emulations against the fp32 plain versions (absolute
# forward, of max|ref| backward): the limit every fp32 kernel of the port is
# held to
FP32_TOL = 1e-5


@pytest.fixture(scope="module")
def jax_side():
    """(jax.numpy, the JAX package's Pallas attention module), JAX on the CPU as
    tests/conftest.py sets it: on a GPU JAX would run fp32 products in TF32."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    from anomalyclip_tpu.ops.pallas import attention

    return jax.numpy, attention


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _gap(got, want) -> float:
    """max|got - want| over max|want|, across the tensors of two tuples."""
    top = max(float(np.abs(np.asarray(w, dtype=np.float32)).max()) for w in want)
    return max(float(np.abs(np.asarray(g, dtype=np.float32) - np.asarray(w, dtype=np.float32)).max())
               for g, w in zip(got, want)) / top


def _operands(rng, b, l, d):
    """q (B, L, D), k and v the two halves of one (B, L, 2D) kv, and g."""
    q, kv, g = _randn(rng, b, l, d), _randn(rng, b, l, 2 * d), _randn(rng, b, l, d)
    return q, kv[..., :d], kv[..., d:], g


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels, at the temporal width
# ---------------------------------------------------------------------------

_WIDTHS = [(2, 32, 256), (2, 16, 256), (2, 32, 128)]  # 8 heads: head dims 32, 32, 16


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,l,d", _WIDTHS)
def test_plain_k2_matches_pallas_at_the_temporal_width(jax_side, b, l, d, causal):
    jnp, jattn = jax_side
    q, k, v, _ = _operands(np.random.default_rng(10 + l + d), b, l, d)
    got = tattn.fused_mha_bld(q, k, v, 8, causal).numpy()
    want = np.asarray(jattn.fused_mha_bld(*(jnp.asarray(t.numpy()) for t in (q, k, v)), 8, causal, True))
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,l,d", _WIDTHS)
def test_plain_k4_matches_pallas_at_the_temporal_width(jax_side, b, l, d, causal):
    jnp, jattn = jax_side
    q, k, v, g = _operands(np.random.default_rng(20 + l + d), b, l, d)
    got = tattn.mha_bld_bwd_reference(q, k, v, g, 8, causal)
    want = jattn._mha_bld_bwd_impl(*(jnp.asarray(t.numpy()) for t in (q, k, v, g)), 8, causal, True)
    assert _gap(got, want) <= FP32_TOL


# ---------------------------------------------------------------------------
# the emulations of the kernels' arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [1, 7, 16, 31, 32])
def test_emulations_match_the_fp32_plain_versions(l, causal):
    """At head dims 32 and 16 (8 heads at emb 256 and 128)."""
    for d in (256, 128):
        q, k, v, g = _operands(np.random.default_rng(30 + l + d), 3, l, d)
        got = tattn.mha_bld_tf32x3_reference(q, k, v, 8, causal)
        assert got.shape == q.shape and got.dtype == torch.float32
        assert float((got - tattn.mha_bld_reference(q, k, v, 8, causal)).abs().max()) <= FP32_TOL
        grads = tattn.mha_bld_bwd_tf32x3_reference(q, k, v, g, 8, causal)
        assert all(t.shape == q.shape for t in grads)
        assert _gap(grads, tattn.mha_bld_bwd_reference(q, k, v, g, 8, causal)) <= FP32_TOL


@pytest.mark.parametrize("causal", [False, True])
def test_plain_tf32_emulation_misses_the_fp32_limit(causal):
    """One product of the big parts alone (TF32 as such) lands 1e-4 and more
    from the fp32 plain versions: why the kernels form three."""
    q, k, v, g = _operands(np.random.default_rng(40), 4, 32, 256)
    want = tattn.mha_bld_reference(q, k, v, 8, causal)
    assert float((tattn.mha_bld_tf32x3_reference(q, k, v, 8, causal, passes=1) - want).abs().max()) > FP32_TOL
    want_grads = tattn.mha_bld_bwd_reference(q, k, v, g, 8, causal)
    assert _gap(tattn.mha_bld_bwd_tf32x3_reference(q, k, v, g, 8, causal, passes=1), want_grads) > FP32_TOL


# ---------------------------------------------------------------------------
# what the kernels take and need
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "dtype,dh,l,eligible",
    [
        (torch.float32, 32, 32, True), (torch.float32, 32, 16, True), (torch.float32, 16, 32, True),
        (torch.float32, 32, 1, True), (torch.float32, 32, 33, False), (torch.float32, 16, 33, False),
        (torch.float32, 8, 32, False), (torch.float32, 64, 32, False), (torch.float32, 32, 0, False),
        (torch.bfloat16, 32, 32, False), (torch.bfloat16, 16, 16, False), (torch.float16, 32, 32, False),
    ],
)
def test_eligibility_at_every_admission_edge(dtype, dh, l, eligible):
    assert tattn.mha_bld_tf32_eligible(dtype, dh, l) is eligible


def test_shared_memory_against_hand_computed_bytes():
    # the forward: four warps' K tiles of 32 rows of 32 + 8 floats and V tiles of
    # 32 + 4, static, whatever L is
    assert tattn.mha_bld_tf32_smem_bytes(32, 32, False) == 4 * 4 * 32 * (40 + 36) == 38_912
    assert tattn.mha_bld_tf32_smem_bytes(5, 32, False) == 38_912
    assert tattn.mha_bld_tf32_smem_bytes(32, 16, False) == 4 * 4 * 32 * (24 + 20) == 22_528
    assert 38_912 <= 48 * 1024  # static shared memory needs no opt-in
    # the backward: per warp q, k, v, g tiles of L rounded up to 16 rows at dh + 4
    # floats, and the P and dS tiles of as many rows at that count + 4
    assert tattn.mha_bld_tf32_smem_bytes(32, 32, True) == 4 * 4 * (4 * 32 * 36 + 2 * 32 * 36) == 110_592
    assert tattn.mha_bld_tf32_smem_bytes(16, 32, True) == 4 * 4 * (4 * 16 * 36 + 2 * 16 * 20) == 47_104
    assert tattn.mha_bld_tf32_smem_bytes(7, 32, True) == 47_104
    assert tattn.mha_bld_tf32_smem_bytes(17, 16, True) == 4 * 4 * (4 * 32 * 20 + 2 * 32 * 36)
    # two blocks an SM at L=32, each with the 1 KB the card reserves, within its 228 KB
    assert 2 * (110_592 + 1024) <= 233_472


# ---------------------------------------------------------------------------
# the wrappers' Python, the library replaced by numpy
# ---------------------------------------------------------------------------


def _address(p) -> int:
    """A pointer argument as the wrappers pass it: an int or a ctypes c_void_p."""
    return p.value if isinstance(p, ctypes.c_void_p) else p


class NumpyBld:
    """The entries of K2's and K4's kernels (K4's at head dim 64 in fp32 on the
    split-TF32 whole-head backward of mha_whole_tf32_bwd.cu among them). The
    split-TF32 ones and, in fp32, the CUDA-core ones compute their function in
    numpy through the raw
    pointers and (batch, row) element strides the wrappers pass; every call is
    recorded with its entry, pointers and strides."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _view(address, batch, row, shape):
        steps = (batch, row, 1)
        span = 1 + sum((n - 1) * s for n, s in zip(shape, steps))
        flat = np.ctypeslib.as_array(ctypes.cast(_address(address), ctypes.POINTER(ctypes.c_float)), (span,))
        return np.lib.stride_tricks.as_strided(flat, shape, [4 * s for s in steps])

    @staticmethod
    def _heads(t, h):
        b, l, d = t.shape
        return t.reshape(b, l, h, d // h).transpose(0, 2, 1, 3)

    def _p(self, q, k, h, causal, scale):
        s = np.einsum("bhqd,bhkd->bhqk", self._heads(q, h), self._heads(k, h)) * scale
        if causal:
            s = np.where(np.tril(np.ones(s.shape[-2:], bool)), s, -1e30)
        e = np.exp(s - s.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)

    def _forward(self, ops, out, b, l, h, dh, causal, scale):
        shape = (b, l, h * dh)
        q, k, v = (self._view(p, bs, rs, shape) for p, bs, rs in ops)
        o = np.einsum("bhqk,bhkd->bhqd", self._p(q, k, h, causal, scale), self._heads(v, h))
        self._view(out, l * h * dh, h * dh, shape)[...] = o.transpose(0, 2, 1, 3).reshape(shape)

    def _backward(self, ops, outs, b, l, h, dh, causal, scale):
        shape = (b, l, h * dh)
        q, k, v, g = (self._view(p, bs, rs, shape) for p, bs, rs in ops)
        p = self._p(q, k, h, causal, scale)
        gh = self._heads(g, h)
        dp = np.einsum("bhqd,bhkd->bhqk", gh, self._heads(v, h))
        ds = p * (dp - (p * dp).sum(axis=-1, keepdims=True)) * scale
        grads = (np.einsum("bhqk,bhkd->bhqd", ds, self._heads(k, h)),
                 np.einsum("bhqk,bhqd->bhkd", ds, self._heads(q, h)),
                 np.einsum("bhqk,bhqd->bhkd", p, gh))
        for out, grad in zip(outs, grads):
            self._view(out, l * h * dh, h * dh, shape)[...] = grad.transpose(0, 2, 1, 3).reshape(shape)

    def acl_mha_bld_tf32_fwd(self, q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, out, b, l, h, dh,
                             causal, scale, stream):
        ops = ((q, q_bs, q_rs), (k, k_bs, k_rs), (v, v_bs, v_rs))
        self.calls.append(("bld_tf32_fwd", [(_address(p), bs, rs) for p, bs, rs in ops], causal))
        self._forward(ops, out, b, l, h, dh, causal, scale)
        return 0

    def acl_mha_bld_tf32_bwd(self, q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, g, g_bs, g_rs,
                             dq, dk, dv, b, l, h, dh, causal, scale, stream):
        ops = ((q, q_bs, q_rs), (k, k_bs, k_rs), (v, v_bs, v_rs), (g, g_bs, g_rs))
        self.calls.append(("bld_tf32_bwd", [(_address(p), bs, rs) for p, bs, rs in ops], causal))
        self._backward(ops, (dq, dk, dv), b, l, h, dh, causal, scale)
        return 0

    def acl_mha_bld_whole_tf32_bwd(self, q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, g, g_bs, g_rs,
                                   dq, dk, dv, b, l, h, dh, causal, scale, stream):
        ops = ((q, q_bs, q_rs), (k, k_bs, k_rs), (v, v_bs, v_rs), (g, g_bs, g_rs))
        self.calls.append(("bld_whole_bwd", [(_address(p), bs, rs) for p, bs, rs in ops], causal))
        self._backward(ops, (dq, dk, dv), b, l, h, dh, causal, scale)
        return 0

    def acl_mha_bld_fwd(self, dtype, q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, out, b, l, h, dh,
                        causal, scale, stream):
        ops = ((q, q_bs, q_rs), (k, k_bs, k_rs), (v, v_bs, v_rs))
        self.calls.append(("bld_fwd", [(_address(p), bs, rs) for p, bs, rs in ops], causal))
        if dtype == 0:
            self._forward(ops, out, b, l, h, dh, causal, scale)
        return 0

    def acl_mha_bld_bwd(self, dtype, q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs, v_rs, g, g_bs, g_rs,
                        dq, dk, dv, b, l, h, dh, causal, scale, stream):
        ops = ((q, q_bs, q_rs), (k, k_bs, k_rs), (v, v_bs, v_rs), (g, g_bs, g_rs))
        self.calls.append(("bld_bwd", [(_address(p), bs, rs) for p, bs, rs in ops], causal))
        if dtype == 0:
            self._backward(ops, (dq, dk, dv), b, l, h, dh, causal, scale)
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
def numpy_bld(monkeypatch):
    """The kernel launches on CPU tensors: the library in numpy; the device check,
    the card's limit (an H100's) and the stream lookup out of the way; the
    wrappers' cache of checked shapes empty before and after."""
    fake = NumpyBld()
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


def _routes(bld=0, bld_bwd=0, whole_bwd=0):
    return {"mha_tc": 0, "blocked_bwd_tc": 0, "mha_tf32": 0, "blocked_bwd_tf32": 0,
            "bld_tf32": bld, "bld_bwd_tf32": bld_bwd, "whole_bwd_tf32": whole_bwd}


def _counts(**expected):
    return {k: expected.get(k, 0) for k in tattn.launch_counts}


@pytest.mark.parametrize("l,d,causal", [(32, 256, False), (16, 256, True), (7, 128, False), (1, 128, True)])
def test_k2_wrapper_takes_the_tf32_entry_reading_k_and_v_in_place(numpy_bld, l, d, causal):
    """q and the two halves of one kv, handed over as base addresses and
    (batch, row) element strides, no copy."""
    q, k, v, _ = _operands(np.random.default_rng(50 + l), 2, l, d)
    out = tattn.mha_bld_fwd_kernel(q, k, v, 8, causal)
    assert out.shape == q.shape and out.is_contiguous()
    assert float((out - tattn.mha_bld_reference(q, k, v, 8, causal)).abs().max()) <= FP32_TOL
    (entry, operands, took_causal), = numpy_bld.calls
    assert (entry, took_causal) == ("bld_tf32_fwd", int(causal))
    assert operands == [(q.data_ptr(), l * d, d), (k.data_ptr(), l * 2 * d, 2 * d),
                        (k.data_ptr() + 4 * d, l * 2 * d, 2 * d)]
    assert v.data_ptr() == k.data_ptr() + 4 * d
    assert tattn.launch_counts == _counts(fused_mha_bld=1)
    assert tattn.route_counts == _routes(bld=1)


@pytest.mark.parametrize("l,d,causal", [(32, 256, False), (16, 256, True), (31, 128, True)])
def test_k4_wrapper_takes_the_tf32_entry_reading_k_and_v_in_place(numpy_bld, l, d, causal):
    q, k, v, g = _operands(np.random.default_rng(60 + l), 2, l, d)
    grads = tattn.mha_bld_bwd_kernel(q, k, v, g, 8, causal)
    assert all(t.shape == q.shape and t.is_contiguous() for t in grads)
    assert _gap(grads, tattn.mha_bld_bwd_reference(q, k, v, g, 8, causal)) <= FP32_TOL
    (entry, operands, took_causal), = numpy_bld.calls
    assert (entry, took_causal) == ("bld_tf32_bwd", int(causal))
    assert operands == [(q.data_ptr(), l * d, d), (k.data_ptr(), l * 2 * d, 2 * d),
                        (k.data_ptr() + 4 * d, l * 2 * d, 2 * d), (g.data_ptr(), l * d, d)]
    assert tattn.launch_counts == _counts(mha_bld_bwd=1)
    assert tattn.route_counts == _routes(bld_bwd=1)


def test_autograd_launches_each_new_entry_once(numpy_bld, monkeypatch):
    """Through ``fused_mha_bld`` with the kernels chosen: the forward on
    ``acl_mha_bld_tf32_fwd``, the backward on ``acl_mha_bld_tf32_bwd``, and the
    gradient of one kv that both halves are views of."""
    monkeypatch.setattr(tattn, "_use_reference", lambda t: False)
    rng = np.random.default_rng(70)
    q, kv = _randn(rng, 4, 32, 256).requires_grad_(True), _randn(rng, 4, 32, 512).requires_grad_(True)
    loss = (tattn.fused_mha_bld(q, kv[..., :256], kv[..., 256:], 8) ** 2).sum()
    got = torch.autograd.grad(loss, (q, kv))
    assert [c[0] for c in numpy_bld.calls] == ["bld_tf32_fwd", "bld_tf32_bwd"]
    assert tattn.route_counts == _routes(bld=1, bld_bwd=1)
    ref_loss = (tattn.mha_bld_reference(q, kv[..., :256], kv[..., 256:], 8) ** 2).sum()
    assert _gap(got, torch.autograd.grad(ref_loss, (q, kv))) <= FP32_TOL


def test_repeated_shapes_are_checked_once(numpy_bld):
    """The checks that depend only on shapes, strides, dtypes and devices run at
    a shape's first call; later calls at it reuse them."""
    q, k, v, g = _operands(np.random.default_rng(71), 2, 16, 256)
    for _ in range(3):
        tattn.mha_bld_fwd_kernel(q, k, v, 8, False)
        tattn.mha_bld_bwd_kernel(q, k, v, g, 8, False)
    info = tattn._bld_tf32_plan.cache_info()
    assert (info.misses, info.hits) == (2, 4)
    assert tattn.route_counts == _routes(bld=3, bld_bwd=3)


@pytest.mark.parametrize(
    "dtype,l,d,heads,backward",
    [(torch.bfloat16, 32, 256, 8, "bld_bwd"), (torch.float32, 33, 256, 8, "bld_bwd"),
     (torch.float32, 16, 32, 4, "bld_bwd"), (torch.float32, 16, 128, 2, "bld_whole_bwd"),
     (torch.float32, 32, 32, 8, "bld_bwd"), (torch.bfloat16, 16, 32, 8, "bld_bwd")],
    ids=["bf16", "L=33", "head dim 8", "head dim 64", "head dim 4", "head dim 4 bf16"],
)
def test_other_shapes_keep_todays_kernels(numpy_bld, dtype, l, d, heads, backward):
    """bf16, L past 32 and the other head dims launch mha.cu forward and
    mha_bwd.cu backward (the whole-head backward fits all of them), with no
    route count; fp32 at head dim 64 launches mha.cu forward and the
    split-TF32 whole-head backward of mha_whole_tf32_bwd.cu, counted by
    ``whole_bwd_tf32``."""
    q, k, v, g = (t.to(dtype) for t in _operands(np.random.default_rng(72), 2, l, d))
    tattn.mha_bld_fwd_kernel(q, k, v, heads, False)
    tattn.mha_bld_bwd_kernel(q, k, v, g, heads, False)
    assert [c[0] for c in numpy_bld.calls] == ["bld_fwd", backward]
    assert tattn.launch_counts == _counts(fused_mha_bld=1, mha_bld_bwd=1)
    assert tattn.route_counts == _routes(whole_bwd=int(backward == "bld_whole_bwd"))


@pytest.mark.parametrize("l,causal", [(32, False), (16, False), (23, True)])
def test_head_dim_4_runs_k2_and_k4_on_mha_cu_as_the_plain_versions(numpy_bld, l, causal):
    """The golden tiny fixture's temporal model (emb 32 over 8 heads): K2 and
    K4 launch mha.cu's and mha_bwd.cu's entries at head dim 4, k and v read in
    place, and give the plain versions' numbers; the other entries keep their
    head dims and refuse it."""
    q, k, v, g = _operands(np.random.default_rng(74), 3, l, 32)
    out = tattn.mha_bld_fwd_kernel(q, k, v, 8, causal)
    grads = tattn.mha_bld_bwd_kernel(q, k, v, g, 8, causal)
    assert [c[0] for c in numpy_bld.calls] == ["bld_fwd", "bld_bwd"]
    assert [a for a, _, _ in numpy_bld.calls[0][1]][1:] == [k.data_ptr(), v.data_ptr()]
    assert float((out - tattn.mha_bld_reference(q, k, v, 8, causal)).abs().max()) <= FP32_TOL
    assert _gap(grads, tattn.mha_bld_bwd_reference(q, k, v, g, 8, causal)) <= FP32_TOL
    assert tattn.launch_counts == _counts(fused_mha_bld=1, mha_bld_bwd=1) and tattn.route_counts == _routes()
    with pytest.raises(ValueError, match=r"gives head dim 4; the kernels take \(8, 16, 32, 64\)"):
        tattn.mha_qkv_fwd_kernel(torch.randn(2, l, 96), 8, causal)
    assert tattn.kernel_refusal(torch.float32, 32, 8, lambda dh: 0, tattn.H100_SMEM_OPTIN) is not None
    assert tattn.kernel_refusal(torch.float32, 32, 8, lambda dh: 0, tattn.H100_SMEM_OPTIN,
                                tattn.BLD_HEAD_DIMS) is None


def test_fused_attention_whole_block_branch_keeps_mha_cu(numpy_bld):
    """K5's whole-block kernel folds the heads into the batch and launches K2's
    and K4's CUDA-core entries at a shape the new kernels would take."""
    rng = np.random.default_rng(73)
    q, k, v, g = (_randn(rng, 1, 2, 32, 32) for _ in range(4))
    out = tattn.fused_attention_fwd_kernel(q, k, v, False)
    grads = tattn.fused_attention_bwd_kernel(q, k, v, g, False)
    assert float((out - tattn.attention_reference(q, k, v)).abs().max()) <= FP32_TOL
    assert _gap(grads, tattn.attention_bwd_reference(q, k, v, g)) <= FP32_TOL
    assert [c[0] for c in numpy_bld.calls] == ["bld_fwd", "bld_bwd"]
    assert tattn.route_counts == _routes()


def test_misaligned_views_are_refused_before_any_launch(numpy_bld):
    """q, k, v one float off 16 bytes, then a row stride that is not a multiple
    of 4 floats: both entries raise, with the shape."""
    x = torch.zeros(2, 16, 3 * 256 + 4)[..., 1:-3]
    q, k, v = x[..., :256], x[..., 256:512], x[..., 512:]
    with pytest.raises(ValueError, match=r"16-byte pieces; shape \(2, 16, 256\)"):
        tattn.mha_bld_fwd_kernel(q, k, v, 8, False)
    with pytest.raises(ValueError, match=r"16-byte pieces; shape \(2, 16, 256\)"):
        tattn.mha_bld_bwd_kernel(q, k, v, torch.zeros(2, 16, 256), 8, False)
    odd = torch.zeros(2, 16, 3 * 256 + 1)
    with pytest.raises(ValueError, match=r"shape \(2, 16, 256\) with strides \(12304, 769, 1\)"):
        tattn.mha_bld_fwd_kernel(odd[..., :256], odd[..., 256:512], odd[..., 512:768], 8, False)
    assert numpy_bld.calls == [] and tattn.launch_counts == _counts() and tattn.route_counts == _routes()


def test_mismatched_operands_are_refused_with_their_shapes(numpy_bld):
    q, k, v, _ = _operands(np.random.default_rng(74), 2, 16, 256)
    with pytest.raises(ValueError, match=r"mha_bld_bwd: operands must agree: .*\(2, 8, 256\)"):
        tattn.mha_bld_bwd_kernel(q, k, v, torch.zeros(2, 8, 256), 8, False)
    with pytest.raises(ValueError, match=r"fused_mha_bld: operands must agree"):
        tattn.mha_bld_fwd_kernel(q, k[:1], v, 8, False)
    assert numpy_bld.calls == [] and tattn.route_counts == _routes()


def test_a_cpu_tensor_is_refused_by_the_kernel_route():
    """Without the numpy stand-in the wrappers' device check holds: the kernel
    takes CUDA tensors."""
    tattn._bld_tf32_plan.cache_clear()
    q, k, v, _ = _operands(np.random.default_rng(75), 2, 16, 256)
    with pytest.raises(ValueError, match="fused_mha_bld: the kernel takes CUDA tensors, not cpu"):
        tattn.mha_bld_fwd_kernel(q, k, v, 8, False)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


_CARD_SHAPES = [(64, 32, 256, 8, False), (128, 16, 256, 8, False), (1024, 32, 256, 8, False),
                (3, 7, 256, 8, True), (3, 31, 128, 8, True), (5, 1, 256, 8, False),
                (66_000, 16, 64, 2, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,d,heads,causal", _CARD_SHAPES)
def test_tf32_forward_matches_plain_and_emulation_and_repeats_to_the_bit(cuda, b, l, d, heads, causal):
    """K2 at the temporal model's shapes, ragged and causal lengths, head dim
    16 and a batch past 65,535; k and v the halves of one kv."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, kv = (torch.randn(b, l, w, device=cuda, generator=gen) for w in (d, 2 * d))
    k, v = kv[..., :d], kv[..., d:]
    tattn.reset_launch_counts()
    once, again = (tattn.mha_bld_fwd_kernel(q, k, v, heads, causal) for _ in range(2))
    torch.cuda.synchronize()
    assert tattn.route_counts["bld_tf32"] == 2 and torch.equal(once, again)
    assert bool(torch.isfinite(once).all())
    for want in (tattn.mha_bld_reference(q, k, v, heads, causal),
                 tattn.mha_bld_tf32x3_reference(q, k, v, heads, causal)):
        assert float((once - want).abs().max()) <= FP32_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,d,heads,causal", _CARD_SHAPES)
def test_tf32_backward_matches_plain_and_emulation_and_repeats_to_the_bit(cuda, b, l, d, heads, causal):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, kv, g = (torch.randn(b, l, w, device=cuda, generator=gen) for w in (d, 2 * d, d))
    k, v = kv[..., :d], kv[..., d:]
    tattn.reset_launch_counts()
    once, again = (tattn.mha_bld_bwd_kernel(q, k, v, g, heads, causal) for _ in range(2))
    torch.cuda.synchronize()
    assert tattn.route_counts["bld_bwd_tf32"] == 2
    assert all(torch.equal(a, c) and bool(torch.isfinite(a).all()) for a, c in zip(once, again))
    got = [t.cpu() for t in once]
    for want in (tattn.mha_bld_bwd_reference(q, k, v, g, heads, causal),
                 tattn.mha_bld_bwd_tf32x3_reference(q, k, v, g, heads, causal)):
        assert _gap(got, [t.cpu() for t in want]) <= FP32_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("b,l", [(2048, 16), (1024, 32)])
def test_k2_and_k4_at_head_dim_16_at_xdviolences_training_shapes(cuda, b, l):
    """XD-Violence's temporal model (emb 128, 8 heads of 16) at its training
    batch of 64: along frames (64 x 32, 16, 128) and along segments
    (64 x 16, 32, 128), forward and backward on the split-TF32 whole-head
    kernels, against the fp32 plain versions."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, kv, g = (torch.randn(b, l, w, device=cuda, generator=gen) for w in (128, 256, 128))
    k, v = kv[..., :128], kv[..., 128:]
    tattn.reset_launch_counts()
    out = tattn.mha_bld_fwd_kernel(q, k, v, 8, False)
    grads = tattn.mha_bld_bwd_kernel(q, k, v, g, 8, False)
    torch.cuda.synchronize()
    assert tattn.route_counts["bld_tf32"] == 1 and tattn.route_counts["bld_bwd_tf32"] == 1
    assert float((out - tattn.mha_bld_reference(q, k, v, 8, False)).abs().max()) <= FP32_TOL
    want = tattn.mha_bld_bwd_reference(q, k, v, g, 8, False)
    assert _gap([t.cpu() for t in grads], [t.cpu() for t in want]) <= FP32_TOL


@pytest.mark.gpu
def test_tf32_entries_refuse_a_misaligned_view_on_the_card(cuda):
    x = torch.zeros(2, 16, 3 * 256 + 2, device=cuda)[..., 1:-1]
    tattn.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte pieces"):
        tattn.mha_bld_fwd_kernel(x[..., :256], x[..., 256:512], x[..., 512:], 8, False)
    assert tattn.launch_counts == _counts() and tattn.route_counts == _routes()


@pytest.mark.gpu
def test_the_temporal_model_takes_the_tf32_kernels_both_ways(cuda, monkeypatch):
    """The UCF-Crime temporal model (emb 256, 8 heads, 32 x 16) forward and
    backward on the card: two launches of each new entry; the scores and each
    leaf's gradient within 1e-4 of its max of the plain path's, which takes the
    kernel run's LeakyReLU branches (``temporal.leaky_relu``: where a
    pre-activation lies within a rounding of 0, two runs that round the
    attention differently take different branches, and a conv weight's
    gradient jumps there)."""
    from anomalyclip_tpu_torch.convert import tree_leaves, tree_to
    from anomalyclip_tpu_torch.models import temporal as ttemporal

    cfg = ttemporal.TemporalConfig(input_size=512, emb_size=256, depth=1, heads=8, dim_heads=32,
                                   num_segments=32, seg_length=16)
    params = tree_to(ttemporal.init_temporal_params(torch.Generator().manual_seed(0), cfg), cuda)
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    features = torch.randn(4 * 512, 512, device=cuda, generator=torch.Generator(device=cuda).manual_seed(3))
    leaky_relu, branches = ttemporal.leaky_relu, []

    def run():
        out = ttemporal.temporal_scores(features, params, cfg)
        return (out.detach(), *torch.autograd.grad((out**2).sum(), leaves))

    def record(y, positive=None):
        branches.append(y >= 0)
        return leaky_relu(y, branches[-1])

    monkeypatch.setattr(ttemporal, "leaky_relu", record)
    tattn.reset_launch_counts()
    got = run()
    torch.cuda.synchronize()
    assert tattn.route_counts == _routes(bld=2, bld_bwd=2)
    replay = iter(branches)
    monkeypatch.setattr(ttemporal, "leaky_relu", lambda y, positive=None: leaky_relu(y, next(replay)))
    with tattn.attention_impl("reference"):
        want = run()
    assert next(replay, None) is None
    assert max(_gap([a.cpu()], [b.cpu()]) for a, b in zip(got, want)) <= 1e-4
