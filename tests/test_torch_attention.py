"""The port's attention entries against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; those are held
against ``fused_mha_qkv`` / ``fused_mha_bld`` in Pallas interpret mode and
against the XLA formulation, fp32 at rtol/atol 1e-5 (attention.py:22-25). The
plain backwards are held against the Pallas backwards (``_mha_qkv_bwd_impl``,
``_mha_bld_bwd_impl``) in interpret mode, and the autograd entries' gradients
against ``jax.grad``, at rtol 1e-5 / atol 1e-5 * max|ref|
(tests/test_pallas_attention.py:349-354).
The ``gpu`` cases hold each CUDA kernel, forward and backward, against its
plain version on the card at the main path's shapes: fp32 within 1e-5, bf16
within 5e-2 (absolute, scaled by max|ref| for the backwards; the plain versions
round to bf16 where the kernels do). This module
imports JAX only in the CPU cases, which skip where JAX is missing, so the
``gpu`` cases also run with ``python -m pytest --noconftest -m gpu`` on this
file (tests/conftest.py imports JAX).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("shape,heads", [((2, 77, 3 * 64), 4), ((2, 197, 3 * 128), 2)])
@pytest.mark.parametrize("causal", [False, True])
def test_mha_qkv_plain_matches_pallas_and_xla(jax_side, shape, heads, causal):
    jnp, jattn = jax_side
    qkv = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = tattn.fused_mha_qkv(torch.from_numpy(qkv), heads, causal).numpy()
    pallas = np.asarray(jattn.fused_mha_qkv(jnp.asarray(qkv), heads, causal, True))
    d = shape[-1] // 3
    j = jnp.asarray(qkv)
    xla = np.asarray(jattn._xla_mha_bld(j[..., :d], j[..., d : 2 * d], j[..., 2 * d :], heads, causal))
    np.testing.assert_allclose(got, pallas, rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_allclose(got, xla, rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("shape", [(4, 32, 64), (8, 16, 64)])
def test_mha_bld_plain_matches_pallas(jax_side, shape):
    """k and v are views of one (B, L, 2D) kv, as in the temporal model."""
    jnp, jattn = jax_side
    rng = np.random.default_rng(1)
    b, l, d = shape
    q = rng.standard_normal(shape).astype(np.float32)
    kv = rng.standard_normal((b, l, 2 * d)).astype(np.float32)
    tq, tkv = torch.from_numpy(q), torch.from_numpy(kv)
    got = tattn.fused_mha_bld(tq, tkv[..., :d], tkv[..., d:], 8).numpy()
    want = np.asarray(
        jattn.fused_mha_bld(jnp.asarray(q), jnp.asarray(kv[..., :d]), jnp.asarray(kv[..., d:]),
                            8, False, True)
    )
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)


def _bwd_tol(want: np.ndarray) -> dict:
    return dict(rtol=FP32_TOL, atol=FP32_TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("causal", [False, True])
def test_mha_qkv_bwd_plain_matches_pallas(jax_side, causal):
    jnp, jattn = jax_side
    rng = np.random.default_rng(2)
    qkv = rng.standard_normal((2, 77, 3 * 64)).astype(np.float32)
    g = rng.standard_normal((2, 77, 64)).astype(np.float32)
    got = tattn.mha_qkv_bwd_reference(torch.from_numpy(qkv), torch.from_numpy(g), 4, causal)
    want = np.asarray(jattn._mha_qkv_bwd_impl(jnp.asarray(qkv), jnp.asarray(g), 4, causal, True))
    assert got.shape == qkv.shape
    np.testing.assert_allclose(got.numpy(), want, **_bwd_tol(want))


@pytest.mark.parametrize("shape", [(4, 32, 64), (8, 16, 64)])
def test_mha_bld_bwd_plain_matches_pallas(jax_side, shape):
    """k and v are views of one (B, L, 2D) kv, as in the temporal model."""
    jnp, jattn = jax_side
    rng = np.random.default_rng(3)
    b, l, d = shape
    q = rng.standard_normal(shape).astype(np.float32)
    kv = rng.standard_normal((b, l, 2 * d)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    tkv = torch.from_numpy(kv)
    got = tattn.mha_bld_bwd_reference(
        torch.from_numpy(q), tkv[..., :d], tkv[..., d:], torch.from_numpy(g), 8
    )
    want = jattn._mha_bld_bwd_impl(
        jnp.asarray(q), jnp.asarray(kv[..., :d]), jnp.asarray(kv[..., d:]), jnp.asarray(g),
        8, False, True,
    )
    for name, ours, theirs in zip("qkv", got, want):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(ours.numpy(), theirs, err_msg=f"d{name}", **_bwd_tol(theirs))


@pytest.mark.parametrize("causal", [False, True])
def test_mha_qkv_grad_matches_jax(jax_side, causal):
    """torch.autograd through the port's entry against jax.grad through the
    Pallas entry's custom VJP, both in interpret/plain mode, of sum(out^2)."""
    jnp, jattn = jax_side
    import jax

    qkv = np.random.default_rng(4).standard_normal((2, 77, 3 * 64)).astype(np.float32)
    want = np.asarray(jax.grad(
        lambda t: jnp.sum(jattn.fused_mha_qkv(t, 4, causal, True) ** 2)
    )(jnp.asarray(qkv)))
    t = torch.from_numpy(qkv).requires_grad_(True)
    (got,) = torch.autograd.grad((tattn.fused_mha_qkv(t, 4, causal) ** 2).sum(), t)
    np.testing.assert_allclose(got.numpy(), want, **_bwd_tol(want))


def test_mha_bld_grad_matches_jax(jax_side):
    """q and one kv that requires grad, k and v sliced from it: autograd adds
    dk and dv into kv's gradient."""
    jnp, jattn = jax_side
    import jax

    rng = np.random.default_rng(5)
    b, l, d = 8, 16, 64
    q = rng.standard_normal((b, l, d)).astype(np.float32)
    kv = rng.standard_normal((b, l, 2 * d)).astype(np.float32)

    def jax_loss(q_, kv_):
        return jnp.sum(jattn.fused_mha_bld(q_, kv_[..., :d], kv_[..., d:], 8, False, True) ** 2)

    want = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(kv))
    tq = torch.from_numpy(q).requires_grad_(True)
    tkv = torch.from_numpy(kv).requires_grad_(True)
    out = tattn.fused_mha_bld(tq, tkv[..., :d], tkv[..., d:], 8)
    got = torch.autograd.grad((out**2).sum(), (tq, tkv))
    for ours, theirs in zip(got, want):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(ours.numpy(), theirs, **_bwd_tol(theirs))


def test_cpu_wrappers_count_no_launches():
    """On the CPU both directions run the plain versions: no launch is counted."""
    tattn.reset_launch_counts()
    x = torch.randn(2, 16, 3 * 64, requires_grad=True)
    out = tattn.fused_mha_qkv(x, 2) + tattn.fused_mha_bld(x[..., :64], x[..., 64:128], x[..., 128:], 2)
    out.sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape
    assert tattn.launch_counts == dict.fromkeys(
        ("fused_mha_qkv", "fused_mha_bld", "mha_qkv_bwd", "mha_bld_bwd",
         "fused_mha_qtile", "flash_attention_heads", "fused_attention",
         "mha_qtile_bwd", "flash_dq", "flash_dkv"), 0
    )


def test_attention_impl_rejects_unknown():
    with pytest.raises(ValueError):
        with tattn.attention_impl("pallas"):
            pass


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


_GPU_DTYPES = [(torch.float32, 1e-5), (torch.bfloat16, 5e-2)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _GPU_DTYPES)
@pytest.mark.parametrize(
    "b,l,d,heads,causal", [(256, 197, 768, 12, False), (14, 77, 512, 8, True)]
)
def test_mha_qkv_kernel_matches_plain(cuda, dtype, tol, b, l, d, heads, causal):
    gen = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(b, l, 3 * d, device=cuda, generator=gen).to(dtype)
    before = tattn.launch_counts["fused_mha_qkv"]
    got = tattn.fused_mha_qkv(qkv, heads, causal)
    with tattn.attention_impl("reference"):
        want = tattn.fused_mha_qkv(qkv, heads, causal)
    torch.cuda.synchronize()
    assert tattn.launch_counts["fused_mha_qkv"] == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _GPU_DTYPES)
@pytest.mark.parametrize("b,l,d", [(64, 32, 256), (128, 16, 256), (1024, 32, 128)])  # dh 32, 32, 16
def test_mha_bld_kernel_matches_plain(cuda, dtype, tol, b, l, d):
    heads = 8
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(b, l, d, device=cuda, generator=gen).to(dtype)
    kv = torch.randn(b, l, 2 * d, device=cuda, generator=gen).to(dtype)
    before = tattn.launch_counts["fused_mha_bld"]
    got = tattn.fused_mha_bld(q, kv[..., :d], kv[..., d:], heads)
    want = tattn.mha_bld_reference(q, kv[..., :d], kv[..., d:], heads)
    torch.cuda.synchronize()
    assert tattn.launch_counts["fused_mha_bld"] == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.gpu
def test_kernel_rejects_unsupported_head_dim(cuda):
    qkv = torch.zeros(2, 10, 3 * 48, device=cuda)
    with pytest.raises(ValueError, match=r"\(2, 10, 144\)"):
        tattn.fused_mha_qkv(qkv, 1)


@pytest.mark.gpu
def test_mha_bld_kernel_batch_beyond_grid_y_z_limit(cuda):
    """Batches above 65535 (long videos fold many grids into the batch) launch."""
    b, l, d, heads = 66_000, 16, 64, 2
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(b, l, d, device=cuda, generator=gen)
    kv = torch.randn(b, l, 2 * d, device=cuda, generator=gen)
    got = tattn.fused_mha_bld(q, kv[..., :d], kv[..., d:], heads)
    want = tattn.mha_bld_reference(q, kv[..., :d], kv[..., d:], heads)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _bwd_close(got, want, tol):
    """|got - want| <= tol * max|want|, absolute, in fp32."""
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol * want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _GPU_DTYPES)
def test_mha_qkv_bwd_kernel_matches_plain(cuda, dtype, tol):
    """K3 at the text tower's shape: (14, 77, 1536), 8 heads, causal."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(14, 77, 3 * 512, device=cuda, generator=gen).to(dtype)
    g = torch.randn(14, 77, 512, device=cuda, generator=gen).to(dtype)
    before = tattn.launch_counts["mha_qkv_bwd"]
    got = tattn.mha_qkv_bwd_kernel(qkv, g, 8, True)
    want = tattn.mha_qkv_bwd_reference(qkv, g, 8, True)
    torch.cuda.synchronize()
    assert tattn.launch_counts["mha_qkv_bwd"] == before + 1
    _bwd_close(got, want, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _GPU_DTYPES)
@pytest.mark.parametrize("b,l,d", [(1024, 32, 256), (2048, 16, 256), (2048, 16, 128)])  # dh 32, 32, 16
def test_mha_bld_bwd_kernel_matches_plain(cuda, dtype, tol, b, l, d):
    """K4 at the temporal model's shapes, k and v the halves of one kv."""
    heads = 8
    gen = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(b, l, d, device=cuda, generator=gen).to(dtype)
    kv = torch.randn(b, l, 2 * d, device=cuda, generator=gen).to(dtype)
    g = torch.randn(b, l, d, device=cuda, generator=gen).to(dtype)
    before = tattn.launch_counts["mha_bld_bwd"]
    got = tattn.mha_bld_bwd_kernel(q, kv[..., :d], kv[..., d:], g, heads, False)
    want = tattn.mha_bld_bwd_reference(q, kv[..., :d], kv[..., d:], g, heads)
    torch.cuda.synchronize()
    assert tattn.launch_counts["mha_bld_bwd"] == before + 1
    for ours, theirs in zip(got, want):
        _bwd_close(ours, theirs, tol)


@pytest.mark.gpu
def test_autograd_launches_each_kernel_once(cuda):
    """Under autograd on the card each direction launches its kernel once; the
    gradient matches the plain versions' at 1e-5 * max."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    qkv = torch.randn(14, 77, 3 * 512, device=cuda, generator=gen, requires_grad=True)
    q = torch.randn(64, 32, 256, device=cuda, generator=gen, requires_grad=True)
    kv = torch.randn(64, 32, 512, device=cuda, generator=gen, requires_grad=True)

    def grads():
        out = tattn.fused_mha_qkv(qkv, 8, True)
        out2 = tattn.fused_mha_bld(q, kv[..., :256], kv[..., 256:], 8)
        return torch.autograd.grad((out**2).sum() + (out2**2).sum(), (qkv, q, kv))

    tattn.reset_launch_counts()
    got = grads()
    torch.cuda.synchronize()
    once = ("fused_mha_qkv", "fused_mha_bld", "mha_qkv_bwd", "mha_bld_bwd")
    assert tattn.launch_counts == {k: int(k in once) for k in tattn.launch_counts}
    with tattn.attention_impl("reference"):
        want = grads()
    torch.cuda.synchronize()
    for ours, theirs in zip(got, want):
        _bwd_close(ours, theirs, FP32_TOL)


@pytest.mark.gpu
def test_reference_impl_launches_no_kernel_in_backward(cuda):
    """The choice is kept from the forward: the backward, which autograd runs
    on its own thread, launches nothing under attention_impl("reference")."""
    qkv = torch.randn(2, 10, 3 * 64, device=cuda, requires_grad=True)
    q = torch.randn(2, 10, 64, device=cuda, requires_grad=True)
    tattn.reset_launch_counts()
    with tattn.attention_impl("reference"):
        out = tattn.fused_mha_qkv(qkv, 1).sum() + tattn.fused_mha_bld(q, q, q, 2).sum()
    out.backward()
    torch.cuda.synchronize()
    assert qkv.grad is not None and q.grad is not None
    assert tattn.launch_counts == dict.fromkeys(tattn.launch_counts, 0)


@pytest.mark.gpu
def test_bwd_kernels_reject_unsupported_shapes(cuda):
    qkv = torch.zeros(2, 10, 3 * 48, device=cuda)
    with pytest.raises(ValueError, match=r"\(2, 10, 144\)"):
        tattn.mha_qkv_bwd_kernel(qkv, torch.zeros(2, 10, 48, device=cuda), 1, False)
    # a causal L=197 at dh 64 needs more shared memory than the whole-head kernel
    # has: the KV-blocked pair takes it with the mask
    qkv = torch.randn(2, 197, 3 * 768, device=cuda)
    g = torch.randn(2, 197, 768, device=cuda)
    _bwd_close(tattn.mha_qkv_bwd_kernel(qkv, g, 12, True), tattn.mha_qkv_bwd_reference(qkv, g, 12, True),
               FP32_TOL)
    q = torch.randn(2, 200, 64, device=cuda)
    for ours, theirs in zip(tattn.mha_bld_bwd_kernel(q, q, q, q, 1, True),
                            tattn.mha_bld_bwd_reference(q, q, q, q, 1, True)):
        _bwd_close(ours, theirs, FP32_TOL)
    with pytest.raises(ValueError, match="float16"):
        tattn.mha_bld_bwd_kernel(q.half(), q.half(), q.half(), q.half(), 1, True)


def _op_case_on_card(name: str, dtype, cuda):
    """(the registered op's arguments) at the shapes the exported graphs and the
    ViT-L/14@336px towers hand it, views where the callers pass views: the
    towers' packed qkv, the temporal model's k and v halves of one projection,
    the core rung's (B, H, L, 64) views of one (B, L, 3, H, 64) projection."""
    gen = torch.Generator(device=cuda).manual_seed(11)

    def t(*shape):
        return torch.randn(shape, device=cuda, generator=gen).to(dtype)

    def heads(b, l, h, dh):
        return t(b, l, 3, h, dh).permute(2, 0, 3, 1, 4).unbind(0)

    def bld(b, l, d):
        kv = t(b, l, 2 * d)
        return t(b, l, d), kv[..., :d], kv[..., d:]

    cases = {
        "fused_mha_qkv image": (t(4, 197, 2304), 12, False),
        "fused_mha_qkv text": (t(14, 77, 1536), 8, True),
        "fused_mha_bld (g*32, 16, 256)": (*bld(128, 16, 256), 8, False),
        "fused_mha_bld (g*16, 32, 256)": (*bld(64, 32, 256), 8, False),
        "fused_mha_qtile L=577": (t(2, 577, 1024), t(2, 577, 2048), 16),
        "flash_attention_heads views": (*heads(2, 577, 16, 64), True, False),
        "flash_attention_heads per head": (t(32, 577, 64), t(32, 577, 64), t(32, 577, 64), False, False),
        "fused_attention L=197": (*heads(2, 197, 12, 64), False),
        "fused_attention L=197 causal": (*heads(2, 197, 12, 64), True),
        "fused_attention dh 32": (*heads(2, 77, 8, 32), False),
    }
    return cases[name]


# each case in fp32 and bf16, but K6, which only the bf16 ViT-L/14@336px tower
# launches (the fp32 one takes K8; K6 in fp32 at L=577 is refused for its
# shared memory)
_OP_CASES_ON_CARD = [
    (case, dtype)
    for case in ("fused_mha_qkv image", "fused_mha_qkv text", "fused_mha_bld (g*32, 16, 256)",
                 "fused_mha_bld (g*16, 32, 256)", "fused_mha_qtile L=577", "flash_attention_heads views",
                 "flash_attention_heads per head", "fused_attention L=197", "fused_attention L=197 causal",
                 "fused_attention dh 32")
    for dtype in (torch.float32, torch.bfloat16)
    if not (case.startswith("fused_mha_qtile") and dtype == torch.float32)
]


@pytest.mark.gpu
@pytest.mark.parametrize("case,dtype", _OP_CASES_ON_CARD,
                         ids=[f"{case} {str(dtype)[6:]}" for case, dtype in _OP_CASES_ON_CARD])
def test_registered_op_fake_strides_are_the_kernels_on_the_card(cuda, dtype, case):
    """Each registered op's fake implementation gives the shape, type and
    strides its kernel writes on the card (the CPU cases cannot show it: there
    the real implementation is the plain version), and torch.library.opcheck's
    schema, autograd-registration and fake-tensor checks pass on CUDA tensors.
    Its fourth check, a trace of forward and backward, passes on the CPU
    (tests/test_torch_export.py) and not here: the backwards launch their
    kernels through ctypes without being operators themselves, so a traced
    backward reaches a data pointer of a fake tensor (ROADMAP.md, section 3)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    name = case.split(" ")[0]
    op = tattn.REGISTERED_OPS[name]
    args = _op_case_on_card(case, dtype, cuda)
    before = tattn.launch_counts[name]
    real = op(*args)
    torch.cuda.synchronize()
    assert tattn.launch_counts[name] == before + 1  # the kernel, not the plain version
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    real, fake = (out if isinstance(out, tuple) else (out,) for out in (real, fake))
    for r, f in zip(real, fake, strict=True):
        assert (tuple(r.shape), r.stride(), r.dtype) == (tuple(f.shape), f.stride(), f.dtype), case
    torch.library.opcheck(op, tuple(a.detach().requires_grad_(True) if isinstance(a, torch.Tensor) else a
                                    for a in args),
                          test_utils=("test_schema", "test_autograd_registration", "test_faketensor"))
