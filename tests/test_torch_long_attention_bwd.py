"""The port's long-sequence attention backwards against the JAX package.

On the CPU the entries run their plain PyTorch versions in both directions.
Held here:

- ``mha_qtile_bwd_reference`` against ``_mha_qtile_bwd_kernel`` (K7) and
  ``flash_attention_bwd_reference`` against ``_flash_dq_kernel`` and
  ``_flash_dkv_kernel`` (K9, K10), the Pallas kernels in interpret mode as
  tests/test_pallas_attention.py runs them: fp32 at rtol 1e-5 / atol 1e-5 *
  max|ref|, bf16 at rtol 5e-2 / atol 5e-2 * max|ref| (gradients are not of unit
  size, so both limits scale with the reference);
- ``torch.autograd.grad`` through ``fused_mha_qtile``, ``flash_attention_heads``
  and ``fused_attention`` (whole-block, causal and not, and a long shape that
  routes to the flash entry) against ``jax.grad`` through the Pallas entries,
  at the same limits;
- ``attention_bwd_route``, the backward's routing by shared memory;
- the wrappers around the KV-blocked CUDA kernels (views, strides, the packed
  gradient layouts, the statistics handed from the dq launch to the dkv launch)
  against the plain backwards, with the library replaced by a numpy version of
  its two entries that reads and writes through the pointers and strides it
  is given.

The ``gpu`` cases hold K7, K9, K10 and the rerouted K3, K4 and K5 backwards
against their plain versions on the card and import no JAX.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from anomalyclip_tpu_torch.ops import attention as tattn

FP32_TOL, BF16_TOL = 1e-5, 5e-2
DTYPES = {"float32": (torch.float32, FP32_TOL), "bfloat16": (torch.bfloat16, BF16_TOL)}


@pytest.fixture(scope="module")
def jax_side():
    """(jax, the JAX package's Pallas attention module), JAX on the CPU as
    tests/conftest.py sets it: on a GPU JAX would run fp32 products in TF32."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    from anomalyclip_tpu.ops.pallas import attention

    return jax, attention


def _inputs(rng, shapes, dtype_name):
    """Seeded numpy inputs, rounded to the dtype once -> (jax arrays, torch tensors)."""
    import jax.numpy as jnp

    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jdtype = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    tdtype = DTYPES[dtype_name][0]
    return ([jnp.asarray(a, jdtype) for a in arrays],
            [torch.from_numpy(a).to(tdtype) for a in arrays])


def _close(got, want, dtype_name, what=""):
    """rtol and atol * max|ref| of the dtype's tolerance."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    tol = DTYPES[dtype_name][1]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * float(np.abs(want).max()), err_msg=what)


# ---------------------------------------------------------------------------
# the plain backwards against the Pallas backward kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize(
    "b,l,d,h",
    [
        (2, 577, 256, 4),  # the @336 length: a ragged final q tile
        (2, 128, 128, 2),  # exact tiling
    ],
)
def test_mha_qtile_bwd_plain_matches_pallas(jax_side, b, l, d, h, dtype_name):
    _, jattn = jax_side
    shapes = [(b, l, d), (b, l, 2 * d), (b, l, d)]
    (jq, jkv, jg), (q, kv, g) = _inputs(np.random.default_rng(10), shapes, dtype_name)
    dq, dkv = tattn.mha_qtile_bwd_reference(q, kv, g, h)
    assert dq.shape == (b, l, d) and dkv.shape == (b, l, 2 * d)
    assert dq.dtype == q.dtype and dkv.dtype == kv.dtype
    want_dq, want_dkv = jattn._mha_qtile_bwd_impl(jq, jkv, jg, h, True)
    _close(dq, want_dq, dtype_name, "dq")
    _close(dkv, want_dkv, dtype_name, "dkv")


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("n,l,dh", [(2, 577, 64), (2, 1100, 32)])  # 1100: ragged on both axes
def test_flash_bwd_plain_matches_pallas(jax_side, n, l, dh, dtype_name):
    """Both sides get the Pallas forward's output and log-sum-exp, the latter
    from lane 0 of its lane-broadcast (N, L, 128) layout."""
    _, jattn = jax_side
    (jq, jk, jv, jg), (q, k, v, g) = _inputs(np.random.default_rng(11), [(n, l, dh)] * 4, dtype_name)
    jout, jlse = jattn._flash_impl(jq, jk, jv, True, save_lse=True)
    want = jattn._flash_bwd_impl(jq, jk, jv, jg, jlse, jout, True)
    out = torch.from_numpy(np.array(jout, dtype=np.float32)).to(q.dtype)
    lse = torch.from_numpy(np.asarray(jlse)[..., 0].copy())
    got = tattn.flash_attention_bwd_reference(q, k, v, g, lse, out)
    for name, ours, theirs in zip(("dq", "dk", "dv"), got, want):
        assert ours.shape == (n, l, dh) and ours.dtype == q.dtype
        _close(ours, theirs, dtype_name, name)


def test_the_two_plain_backwards_differ_in_bf16_only():
    """delta from P o dP (K7) and delta from the rounded output (K9, K10) are
    one number in fp32 and two in bf16: the plain versions are not shared."""
    rng = np.random.default_rng(12)
    arrays = [torch.from_numpy(rng.standard_normal((2, 200, 64)).astype(np.float32)) for _ in range(4)]
    for dtype, same in ((torch.float32, True), (torch.bfloat16, False)):
        q, k, v, g = (a.to(dtype) for a in arrays)
        out, lse = tattn.flash_attention_reference(q, k, v, save_lse=True)
        flash = tattn.flash_attention_bwd_reference(q, k, v, g, lse, out)
        whole = tattn.attention_bwd_reference(*(t[:, None] for t in (q, k, v, g)))
        gap = max((a.float() - b[:, 0].float()).abs().max().item() for a, b in zip(flash, whole))
        top = max(b.float().abs().max().item() for b in whole)
        assert (gap <= FP32_TOL * top) == same, (dtype, gap, top)
        assert gap <= BF16_TOL * top


# ---------------------------------------------------------------------------
# autograd through the entries against jax.grad through the Pallas entries
# ---------------------------------------------------------------------------


def _grads(jax, jfn, tfn, jarrays, tensors):
    """d sum(fn^2) / d inputs on both sides, the sum taken in fp32."""
    import jax.numpy as jnp

    want = jax.grad(
        lambda *a: (jfn(*a).astype(jnp.float32) ** 2).sum(), argnums=tuple(range(len(jarrays)))
    )(*jarrays)
    leaves = [t.requires_grad_(True) for t in tensors]
    got = torch.autograd.grad((tfn(*leaves).float() ** 2).sum(), leaves)
    return got, want


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_mha_qtile_grad_matches_jax(jax_side, dtype_name):
    jax, jattn = jax_side
    b, l, d, h = 2, 150, 128, 2
    jarrays, tensors = _inputs(np.random.default_rng(13), [(b, l, d), (b, l, 2 * d)], dtype_name)
    got, want = _grads(jax, lambda q, kv: jattn.fused_mha_qtile(q, kv, h, True),
                       lambda q, kv: tattn.fused_mha_qtile(q, kv, h), jarrays, tensors)
    for name, ours, theirs in zip(("dq", "dkv"), got, want):
        assert ours.dtype == tensors[0].dtype
        _close(ours, theirs, dtype_name, name)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_flash_grad_matches_jax(jax_side, dtype_name):
    """Three of the port's KV blocks, the last one ragged; K8 with its lse, then
    K9 and K10, on the JAX side."""
    jax, jattn = jax_side
    jarrays, tensors = _inputs(np.random.default_rng(14), [(2, 300, 64)] * 3, dtype_name)
    got, want = _grads(jax, lambda q, k, v: jattn.flash_attention_heads(q, k, v, True),
                       tattn.flash_attention_heads, jarrays, tensors)
    for name, ours, theirs in zip(("dq", "dk", "dv"), got, want):
        _close(ours, theirs, dtype_name, name)


@pytest.mark.parametrize(
    "shape,causal,dtype_name",
    [
        ((2, 2, 77, 64), False, "float32"),
        ((2, 2, 77, 64), True, "float32"),
        ((2, 2, 77, 64), True, "bfloat16"),
        ((1, 2, 577, 64), False, "float32"),  # past the whole-block kernel: the flash entry
        ((1, 2, 577, 64), False, "bfloat16"),
    ],
)
def test_fused_attention_grad_matches_jax(jax_side, shape, causal, dtype_name):
    jax, jattn = jax_side
    jarrays, tensors = _inputs(np.random.default_rng(15), [shape] * 3, dtype_name)
    got, want = _grads(jax, lambda q, k, v: jattn.fused_attention(q, k, v, causal, True),
                       lambda q, k, v: tattn.fused_attention(q, k, v, causal), jarrays, tensors)
    for name, ours, theirs in zip(("dq", "dk", "dv"), got, want):
        assert ours.shape == shape
        _close(ours, theirs, dtype_name, name)


def test_flash_lse_is_not_differentiated():
    q, k, v = (torch.randn(2, 70, 32, requires_grad=True) for _ in range(3))
    out, lse = tattn.flash_attention_heads(q, k, v, save_lse=True)
    assert out.requires_grad and not lse.requires_grad
    with torch.no_grad():
        assert torch.equal(tattn.flash_attention_heads(q, k, v), out)


# ---------------------------------------------------------------------------
# the backward's routing by shared memory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "l,dh,itemsize,causal,route",
    [
        (77, 64, 4, True, "whole"),  # the text towers
        (77, 64, 2, True, "whole"),
        (32, 32, 4, False, "whole"),  # the temporal model's two axes
        (16, 32, 4, False, "whole"),
        (117, 64, 4, False, "whole"),  # the last length whose L x L tiles fit at dh 64
        (118, 64, 4, False, "blocked"),
        (197, 64, 4, False, "blocked"),  # the ViT-B/16 tower
        (197, 64, 2, False, "blocked"),
        (577, 64, 4, False, "blocked"),  # the ViT-L/14@336px tower
        (2048, 32, 2, False, "blocked"),
        (197, 64, 4, True, "blocked"),  # causal past the whole-head kernel: the pair masks
        (200, 16, 4, False, "blocked"),  # the small head dims past it
        (300, 8, 2, True, "blocked"),
    ],
)
def test_backward_route(l, dh, itemsize, causal, route):
    """The route follows the shared memory alone: both kernels take the mask."""
    assert tattn.attention_bwd_route(l, dh, itemsize) == route
    assert tattn.attention_bwd_route(l, dh, itemsize, tattn.smem_limit(torch.device("cpu"))) == route


def test_backward_route_follows_the_shared_memory_limit():
    # K3 at the text shape needs 127,512 B; the blocked pair 99,584 B in fp32 at dh 64
    assert tattn.mha_bwd_smem_bytes(77, 64) == 127_512
    assert tattn.blocked_bwd_smem_bytes(64, 4) == 99_584 and tattn.blocked_bwd_smem_bytes(64, 2) == 83_200
    assert tattn.attention_bwd_route(77, 64, 4, smem=120_000) == "blocked"
    assert tattn.mha_bwd_smem_bytes(197, 64) == 515_352
    # on a card with too little shared memory for either kernel there is no
    # route, and the wrapper raises with what each needs
    assert tattn.attention_bwd_route(197, 64, 4, smem=90_000) is None
    assert tattn.attention_bwd_route(197, 64, 2, smem=90_000) == "blocked"


# ---------------------------------------------------------------------------
# the wrappers of the KV-blocked kernels, the library replaced by numpy
# ---------------------------------------------------------------------------


class NumpyBlockedKernels:
    """``acl_blocked_dq`` and ``acl_blocked_dkv`` in numpy (fp32 only): the
    arithmetic of ops/csrc/mha_blocked_bwd.cu without its tiling, reading and
    writing through the raw pointers and (batch, head, row) element strides the
    wrappers pass, so that a wrong view, stride or output layout shows; and the
    split-TF32 pair's two entries (mha_tf32_bwd.cu, fp32 at head dim 64), whose
    row statistics are the log-sum-exp and delta."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _view(address, strides, shape):
        b, h, l, dh = shape
        steps = (*strides, 1)
        span = 1 + sum((n - 1) * s for n, s in zip(shape, steps))
        flat = np.ctypeslib.as_array(ctypes.cast(address, ctypes.POINTER(ctypes.c_float)), (span,))
        return np.lib.stride_tricks.as_strided(flat, shape, [4 * s for s in steps])

    def _operands(self, ptrs, strides, count, shape):
        return [self._view(ptrs[i], [strides[3 * i + j] for j in range(3)], shape)
                for i in range(count)]

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

    @classmethod
    def _p_and_ds(cls, q, k, v, g, m, l, delta, causal, scale):
        s = cls._scores(q, k, causal, scale)
        p = np.exp(s - m[..., None]) / (1.0 if l is None else l[..., None])
        dp = np.einsum("bhqd,bhkd->bhqk", g, v)
        return p, p * (dp - delta[..., None]) * scale

    def _dq(self, tag, ptrs, strides, m, l, delta, recompute, shape, causal, scale):
        self.calls.append(tag + (" causal" if causal else ""))
        q, k, v, g, dq = self._operands(ptrs, strides, 5, shape)
        m, l, delta = (self._stat(t, shape[:3]) for t in (m, l, delta))
        if recompute:
            s = self._scores(q, k, causal, scale)
            top = s.max(axis=-1)
            e = np.exp(s - top[..., None])
            total = e.sum(axis=-1)
            delta[...] = (e / total[..., None] * np.einsum("bhqd,bhkd->bhqk", g, v)).sum(axis=-1)
            if l is None:  # the split-TF32 pair hands over the log-sum-exp alone
                m[...] = top + np.log(total)
            else:
                m[...], l[...] = top, total
        _, ds = self._p_and_ds(q, k, v, g, m, l, delta, causal, scale)
        dq[...] = np.einsum("bhqk,bhkd->bhqd", ds, k)
        return 0

    def acl_blocked_dq(self, dtype, ptrs, strides, m, l, delta, recompute, b, h, seq, dh, causal, scale,
                       stream):
        assert dtype == 0
        return self._dq("dq", ptrs, strides, m, l, delta, recompute, (b, h, seq, dh), causal, scale)

    def acl_blocked_dq_tf32(self, ptrs, strides, lse, delta, recompute, b, h, seq, dh, causal, scale,
                            stream):
        assert dh == 64
        return self._dq("dq_tf32", ptrs, strides, lse, ctypes.c_void_p(None), delta, recompute,
                        (b, h, seq, dh), causal, scale)

    def acl_blocked_dkv_tf32(self, ptrs, strides, lse, delta, b, h, seq, dh, causal, scale, stream):
        assert dh == 64
        return self._dkv("dkv_tf32", ptrs, strides, lse, ctypes.c_void_p(None), delta, (b, h, seq, dh),
                         causal, scale)

    def acl_blocked_dkv(self, dtype, ptrs, strides, m, l, delta, b, h, seq, dh, causal, scale, stream):
        assert dtype == 0
        return self._dkv("dkv", ptrs, strides, m, l, delta, (b, h, seq, dh), causal, scale)

    def _dkv(self, tag, ptrs, strides, m, l, delta, shape, causal, scale):
        self.calls.append(tag + (" causal" if causal else ""))
        b, h, seq, dh = shape
        q, k, v, g, dk, dv = self._operands(ptrs, strides, 6, (b, h, seq, dh))
        m, l, delta = (self._stat(t, (b, h, seq)) for t in (m, l, delta))
        p, ds = self._p_and_ds(q, k, v, g, m, l, delta, causal, scale)
        dk[...] = np.einsum("bhqk,bhqd->bhkd", ds, q)
        dv[...] = np.einsum("bhqk,bhqd->bhkd", p, g)
        return 0


@pytest.fixture
def numpy_kernels(monkeypatch):
    """The kernel launches on CPU tensors: the library in numpy, the device
    check of the shape check and the stream lookup out of the way."""
    fake = NumpyBlockedKernels()
    monkeypatch.setattr(tattn, "load_library", lambda: fake)
    monkeypatch.setattr(tattn, "_stream", lambda t: None)
    monkeypatch.setattr(
        tattn, "_check_kernel_shape", lambda name, t, d, h, smem: d // h
    )
    tattn.reset_launch_counts()
    return fake


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _all_close(got, want):
    top = max(w.abs().max().item() for w in want)
    for ours, theirs in zip(got, want):
        torch.testing.assert_close(ours, theirs, rtol=0, atol=FP32_TOL * top)


def _counts(**expected):
    return {k: expected.get(k, 0) for k in tattn.launch_counts}


def test_qtile_bwd_wrapper_reads_and_writes_in_place(numpy_kernels):
    """K7: q and kv as column slices of one packed tensor, dk|dv written into
    the two halves of one (B, L, 2D) tensor."""
    rng = np.random.default_rng(20)
    x, g = _randn(rng, 2, 150, 3 * 64), _randn(rng, 2, 150, 64)
    q, kv = x[..., :64], x[..., 64:]
    got = tattn.mha_qtile_bwd_kernel(q, kv, g, 2)
    assert got[1].shape == (2, 150, 128) and got[1].is_contiguous()
    _all_close(got, tattn.mha_qtile_bwd_reference(q, kv, g, 2))
    assert numpy_kernels.calls == ["dq", "dkv"]
    assert tattn.launch_counts == _counts(mha_qtile_bwd=1)


def test_qkv_bwd_wrapper_takes_the_blocked_route(numpy_kernels):
    """K3 past its whole-head kernel: the ViT-B/16 length, a packed dqkv."""
    rng = np.random.default_rng(21)
    qkv, g = _randn(rng, 2, 197, 3 * 128), _randn(rng, 2, 197, 128)
    got = tattn.mha_qkv_bwd_kernel(qkv, g, 2, False)
    assert got.shape == qkv.shape
    _all_close([got], [tattn.mha_qkv_bwd_reference(qkv, g, 2, False)])
    # fp32 at head dim 64: the split-TF32 pair
    assert numpy_kernels.calls == ["dq_tf32", "dkv_tf32"]
    assert tattn.launch_counts == _counts(mha_qkv_bwd=1)
    # the same route with the causal mask handed on to both passes
    got = tattn.mha_qkv_bwd_kernel(qkv, g, 2, True)
    _all_close([got], [tattn.mha_qkv_bwd_reference(qkv, g, 2, True)])
    assert numpy_kernels.calls[2:] == ["dq_tf32 causal", "dkv_tf32 causal"]
    assert tattn.launch_counts == _counts(mha_qkv_bwd=2)
    # and at head dim 32 the CUDA-core pair
    got = tattn.mha_qkv_bwd_kernel(qkv, g, 4, False)
    _all_close([got], [tattn.mha_qkv_bwd_reference(qkv, g, 4, False)])
    assert numpy_kernels.calls[4:] == ["dq", "dkv"]


def test_bld_bwd_wrapper_takes_the_blocked_route(numpy_kernels):
    """K4 past its whole-head kernel, k and v the halves of one kv, g expanded
    from a scalar as ``sum().backward()`` hands it over."""
    rng = np.random.default_rng(22)
    q, kv = _randn(rng, 2, 130, 64), _randn(rng, 2, 130, 128)
    g = torch.ones(()).expand(2, 130, 64)
    got = tattn.mha_bld_bwd_kernel(q, kv[..., :64], kv[..., 64:], g, 1, False)
    _all_close(got, tattn.mha_bld_bwd_reference(q, kv[..., :64], kv[..., 64:], g, 1, False))
    assert tattn.launch_counts == _counts(mha_bld_bwd=1)


def test_fused_attention_bwd_wrapper_reads_split_heads_in_place(numpy_kernels):
    """K5's backward past K4's kernel: (B, H, L, Dh) views of one packed
    projection go to the blocked pair as they are, without a fold or a copy."""
    rng = np.random.default_rng(23)
    packed = _randn(rng, 2, 197, 3, 2, 64)
    q, k, v = packed.permute(2, 0, 3, 1, 4)
    g = _randn(rng, 2, 2, 197, 64)
    got = tattn.fused_attention_bwd_kernel(q, k, v, g, False)
    assert all(t.shape == (2, 2, 197, 64) for t in got)
    _all_close(got, tattn.attention_bwd_reference(q, k, v, g, False))
    assert tattn.launch_counts == _counts(fused_attention=1)


def test_flash_bwd_wrapper_hands_over_the_saved_statistics(numpy_kernels):
    """K9 and K10 over per-head (N, L, dh): the log-sum-exp as m, no l, delta
    from the output; one launch and one count each."""
    rng = np.random.default_rng(24)
    q, k, v, g = (_randn(rng, 3, 150, 32) for _ in range(4))
    out, lse = tattn.flash_attention_reference(q, k, v, save_lse=True)
    got = tattn.flash_bwd_kernel(q, k, v, g, lse, out)
    _all_close(got, tattn.flash_attention_bwd_reference(q, k, v, g, lse, out))
    assert numpy_kernels.calls == ["dq", "dkv"]
    assert tattn.launch_counts == _counts(flash_dq=1, flash_dkv=1)
    # with the causal mask: the forward's statistics are the masked rows'
    out, lse = tattn.flash_attention_reference(q, k, v, save_lse=True, causal=True)
    got = tattn.flash_bwd_kernel(q, k, v, g, lse, out, True)
    _all_close(got, tattn.flash_attention_bwd_reference(q, k, v, g, lse, out, True))
    whole = tattn.attention_bwd_reference(*(t.unsqueeze(0) for t in (q, k, v, g)), True)
    _all_close(got, [t.squeeze(0) for t in whole])
    assert numpy_kernels.calls[2:] == ["dq causal", "dkv causal"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


_GPU_DTYPES = [(torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)]


def _gpu_close(got, want, tol):
    """|got - want| <= tol * max|want| over the tuple, absolute, in fp32."""
    top = max(w.float().abs().max().item() for w in want)
    for ours, theirs in zip(got, want):
        torch.testing.assert_close(ours.float(), theirs.float(), rtol=0, atol=tol * top)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _GPU_DTYPES)
@pytest.mark.parametrize("b,l,d,heads", [(32, 577, 1024, 16), (4, 128, 256, 8), (3, 1100, 128, 2)])
def test_mha_qtile_bwd_kernel_matches_plain(cuda, dtype, tol, b, l, d, heads):
    """K7 at the ViT-L/14@336px shape, at an exact tiling with dh 32, and
    ragged on both axes; q and kv are views of one tensor."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(b, l, 3 * d, device=cuda, generator=gen).to(dtype)
    g = torch.randn(b, l, d, device=cuda, generator=gen).to(dtype)
    tattn.reset_launch_counts()
    got = tattn.mha_qtile_bwd_kernel(x[..., :d], x[..., d:], g, heads)
    want = tattn.mha_qtile_bwd_reference(x[..., :d], x[..., d:], g, heads)
    torch.cuda.synchronize()
    assert tattn.launch_counts == _counts(mha_qtile_bwd=1)
    _gpu_close(got, want, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _GPU_DTYPES)
@pytest.mark.parametrize("n,l,dh", [(512, 577, 64), (8, 1100, 64), (16, 256, 32)])
def test_flash_bwd_kernels_match_plain(cuda, dtype, tol, n, l, dh):
    """K9 and K10 with the log-sum-exp and the output of K8."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, g = torch.randn(4, n, l, dh, device=cuda, generator=gen).to(dtype)
    out, lse = tattn.flash_attention_heads(q, k, v, save_lse=True)
    tattn.reset_launch_counts()
    got = tattn.flash_bwd_kernel(q, k, v, g, lse, out)
    want = tattn.flash_attention_bwd_reference(q, k, v, g, lse, out)
    torch.cuda.synchronize()
    assert tattn.launch_counts == _counts(flash_dq=1, flash_dkv=1)
    _gpu_close(got, want, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _GPU_DTYPES)
def test_whole_block_entries_take_the_blocked_route_on_the_card(cuda, dtype, tol):
    """K3's and K4's entries and K5's backward at the ViT-B/16 length."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    qkv = torch.randn(32, 197, 3 * 768, device=cuda, generator=gen).to(dtype)
    g = torch.randn(32, 197, 768, device=cuda, generator=gen).to(dtype)
    q, k, v = qkv.split(768, dim=-1)
    tattn.reset_launch_counts()
    _gpu_close([tattn.mha_qkv_bwd_kernel(qkv, g, 12, False)],
               [tattn.mha_qkv_bwd_reference(qkv, g, 12, False)], tol)
    _gpu_close(tattn.mha_bld_bwd_kernel(q, k, v, g, 12, False),
               tattn.mha_bld_bwd_reference(q, k, v, g, 12, False), tol)
    heads = [t.unflatten(-1, (12, 64)).transpose(1, 2) for t in (q, k, v, g)]
    _gpu_close(tattn.fused_attention_bwd_kernel(*heads, False),
               tattn.attention_bwd_reference(*heads, False), tol)
    torch.cuda.synchronize()
    assert tattn.launch_counts == _counts(mha_qkv_bwd=1, mha_bld_bwd=1, fused_attention=1)


@pytest.mark.gpu
def test_autograd_through_the_long_entries_on_the_card(cuda):
    """Each direction launches its kernel once, and the gradients agree with the
    plain path's at 1e-5 * max."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(2, 577, 128, device=cuda, generator=gen, dtype=torch.bfloat16).float()
    kv = torch.randn(2, 577, 256, device=cuda, generator=gen)
    heads = torch.randn(3, 4, 577, 64, device=cuda, generator=gen)
    whole = torch.randn(3, 2, 2, 197, 64, device=cuda, generator=gen)
    leaves = [t.requires_grad_(True) for t in (q, kv, heads, whole)]

    def grads():
        loss = (tattn.fused_mha_qtile(q.bfloat16(), kv.bfloat16(), 2).float() ** 2).sum()
        loss = loss + (tattn.flash_attention_heads(*heads) ** 2).sum()
        loss = loss + (tattn.fused_attention(*whole) ** 2).sum()
        return torch.autograd.grad(loss, leaves)

    tattn.reset_launch_counts()
    got = grads()
    torch.cuda.synchronize()
    assert tattn.launch_counts == _counts(
        fused_mha_qtile=1, mha_qtile_bwd=1, flash_attention_heads=1, flash_dq=1, flash_dkv=1,
        fused_attention=2,
    )
    with tattn.attention_impl("reference"):
        want = grads()
    for ours, theirs, tol in zip(got, want, (BF16_TOL, BF16_TOL, FP32_TOL, FP32_TOL)):
        _gpu_close([ours], [theirs], tol)


@pytest.mark.gpu
def test_causal_backward_past_the_whole_head_kernel_raises_on_the_card(cuda):
    """It raised while the KV-blocked pair had no mask; now both directions of a
    causal shape past the whole-head kernel launch, and only what no kernel is
    instantiated for raises."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    qkv = torch.randn(2, 197, 3 * 128, device=cuda, generator=gen)
    g = torch.randn(2, 197, 128, device=cuda, generator=gen)
    tattn.reset_launch_counts()
    _gpu_close([tattn.mha_qkv_bwd_kernel(qkv, g, 2, True)],
               [tattn.mha_qkv_bwd_reference(qkv, g, 2, True)], FP32_TOL)
    q = torch.randn(1, 2, 197, 64, device=cuda, generator=gen).requires_grad_(True)
    out = tattn.fused_attention(q, q, q, True)  # the forward fits the whole-block kernel
    (got,) = torch.autograd.grad(out.sum(), q)
    torch.cuda.synchronize()
    assert tattn.launch_counts == _counts(mha_qkv_bwd=1, fused_attention=2)
    want = sum(tattn.attention_bwd_reference(q, q, q, torch.ones_like(q), True))
    _gpu_close([got], [want], FP32_TOL)
    with pytest.raises(ValueError, match="head dim 128"):
        tattn.mha_qkv_bwd_kernel(torch.zeros(2, 197, 3 * 128, device=cuda), g, 1, True)
