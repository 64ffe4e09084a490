"""The port's attention entries against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; those are held
against ``fused_mha_qkv`` / ``fused_mha_bld`` in Pallas interpret mode and
against the XLA formulation, fp32 at rtol/atol 1e-5 (attention.py:22-25).
The ``gpu`` cases hold each CUDA kernel against its plain version on the card
at the main path's shapes: fp32 within 1e-5, bf16 within 5e-2 (absolute; the
plain version rounds P to bf16 where the kernel does). This module
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


def test_cpu_wrappers_count_no_launches():
    tattn.reset_launch_counts()
    x = torch.randn(2, 16, 3 * 64)
    tattn.fused_mha_qkv(x, 2)
    tattn.fused_mha_bld(x[..., :64], x[..., 64:128], x[..., 128:], 2)
    assert tattn.launch_counts == {"fused_mha_qkv": 0, "fused_mha_bld": 0}


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
@pytest.mark.parametrize("b,l", [(64, 32), (128, 16)])
def test_mha_bld_kernel_matches_plain(cuda, dtype, tol, b, l):
    d, heads = 256, 8
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


@pytest.mark.gpu
def test_kernel_refuses_autograd(cuda):
    qkv = torch.zeros(2, 10, 3 * 64, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError):
        tattn.fused_mha_qkv(qkv, 1)
    with torch.no_grad():
        assert tattn.fused_mha_qkv(qkv, 1).shape == (2, 10, 64)
