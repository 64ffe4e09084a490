"""The port's long-sequence attention and its dispatch ladder against the JAX
package.

On the CPU the entries run their plain PyTorch versions; those are held against
the Pallas kernels in interpret mode, as tests/test_pallas_attention.py runs
them: ``fused_mha_qtile`` (K6), ``flash_attention_heads`` (K8, with its
log-sum-exp) and ``fused_attention`` (K5) on its whole-block and flash branches,
fp32 at rtol 1e-5 / atol 1e-5 * max|ref| and bf16 at 5e-2. The ladder
(``attention_rung``) must pick the JAX package's rung under
``attention_impl("pallas")`` at every supported tower shape, and a tower at
L=577 must take the q-tiled entry in bf16 and the core rung into the flash
entry in fp32. With the kernel path forced, each entry's backward goes through
its backward launch once (the backward kernels themselves are held in
tests/test_torch_long_attention_bwd.py). The ``gpu`` cases hold each forward
kernel against its plain version on the card; like
tests/test_torch_attention.py, this module imports JAX only in the CPU cases,
so ``python -m pytest --noconftest -m gpu`` runs them without JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from anomalyclip_tpu_torch.models.clip import model as tclip
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
    """fp32: rtol 1e-5, atol 1e-5 * max|ref|; bf16: 5e-2 absolute and relative."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    if dtype_name == "float32":
        tol = dict(rtol=FP32_TOL, atol=FP32_TOL * float(np.abs(want).max()))
    else:
        tol = dict(rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize(
    "b,l,d,h",
    [
        (2, 577, 256, 4),  # the @336 length: a ragged final q tile
        (2, 128, 128, 2),
    ],
)
def test_mha_qtile_plain_matches_pallas(jax_side, b, l, d, h, dtype_name):
    _, jattn = jax_side
    (jq, jkv), (q, kv) = _inputs(np.random.default_rng(0), [(b, l, d), (b, l, 2 * d)], dtype_name)
    got = tattn.fused_mha_qtile(q, kv, h)
    assert got.dtype == q.dtype and got.shape == (b, l, d)
    _close(got, jattn.fused_mha_qtile(jq, jkv, h, True), dtype_name)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("n,l,dh", [(2, 577, 64), (4, 64, 64)])
def test_flash_plain_matches_pallas(jax_side, n, l, dh, dtype_name):
    """Out and the (N, L) log-sum-exp; 577 keys are five of the port's KV
    blocks and two of the Pallas kernel's, the last one ragged in both."""
    _, jattn = jax_side
    jqkv, qkv = _inputs(np.random.default_rng(1), [(n, l, dh)] * 3, dtype_name)
    out, lse = tattn.flash_attention_heads(*qkv, save_lse=True)
    assert out.dtype == qkv[0].dtype and lse.shape == (n, l) and lse.dtype == torch.float32
    want_out, want_lse = jattn._flash_impl(*jqkv, True, save_lse=True)
    _close(out, jattn.flash_attention_heads(*jqkv, True), dtype_name, "out")
    _close(out, want_out, dtype_name, "out (save_lse)")
    _close(lse, np.asarray(want_lse)[..., 0], dtype_name, "lse")
    assert torch.equal(tattn.flash_attention_heads(*qkv), out)


def test_flash_plain_rounds_per_kv_block(jax_side, monkeypatch):
    """With the Pallas kernel's KV block the bf16 plain version rounds where
    that kernel rounds: far inside the bf16 tolerance. The block is chosen at
    each call (``flash_reference_block``), so setting the choice takes effect."""
    _, jattn = jax_side
    jqkv, qkv = _inputs(np.random.default_rng(2), [(2, 577, 64)] * 3, "bfloat16")
    kernel_block = tattn.flash_attention_reference(*qkv)
    monkeypatch.setattr(tattn, "flash_reference_block", lambda dtype, dh: jattn._FLASH_LKV)
    got = tattn.flash_attention_reference(*qkv)
    assert torch.equal(got, tattn.flash_attention_reference(*qkv, block=jattn._FLASH_LKV))
    assert not torch.equal(got, kernel_block)
    want = np.asarray(jattn.flash_attention_heads(*jqkv, True), dtype=np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2e-2)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize(
    "shape,causal,route",
    [
        ((2, 4, 77, 64), False, "whole"),
        ((2, 4, 77, 64), True, "whole"),
        ((2, 4, 197, 64), False, "whole"),
        ((1, 2, 577, 64), False, "flash"),  # past the whole-block kernel's shared memory
        ((1, 2, 577, 64), True, "flash"),  # causal past it: the flash entry with the mask
    ],
)
def test_fused_attention_plain_matches_pallas(jax_side, monkeypatch, shape, causal, route, dtype_name):
    _, jattn = jax_side
    flash_calls = []
    real_flash = tattn._flash_heads
    monkeypatch.setattr(tattn, "_flash_heads", lambda *a: (flash_calls.append(a[0].shape), real_flash(*a))[1])
    jqkv, qkv = _inputs(np.random.default_rng(3), [shape] * 3, dtype_name)
    got = tattn.fused_attention(*qkv, causal)
    assert got.shape == shape and got.dtype == qkv[0].dtype
    _close(got, jattn.fused_attention(*jqkv, causal, True), dtype_name)
    # the flash branch takes the four-dimensional views as they are
    assert flash_calls == ([shape] if route == "flash" else [])


# ---------------------------------------------------------------------------
# the dispatch ladder
# ---------------------------------------------------------------------------

# every supported tower shape: (B, L, D), heads, causal, the rung in fp32 and bf16
TOWER_SHAPES = [
    ((256, 197, 768), 12, False, "mha", "mha"),  # ViT-B/16
    ((256, 50, 768), 12, False, "mha", "mha"),  # ViT-B/32
    ((64, 257, 1024), 16, False, "mha", "mha"),  # ViT-L/14
    ((256, 257, 1024), 16, False, "mha", "mha"),
    ((256, 577, 1024), 16, False, "core", "qtile"),  # ViT-L/14@336px
    ((14, 77, 512), 8, True, "mha", "mha"),  # text towers
    ((14, 77, 768), 12, True, "mha", "mha"),
]


@pytest.mark.parametrize("shape,heads,causal,fp32_rung,bf16_rung", TOWER_SHAPES)
def test_ladder_picks_the_jax_rung(jax_side, shape, heads, causal, fp32_rung, bf16_rung):
    from anomalyclip_tpu.models.clip import model as jclip

    for itemsize, want in ((4, fp32_rung), (2, bf16_rung)):
        ours = tclip.attention_rung(*shape, heads, itemsize, causal)
        with jclip.attention_impl("pallas"):
            theirs = jclip.attention_rung(*shape, heads, itemsize, causal)
        assert ours == theirs == want, (shape, itemsize, ours, theirs)


def test_ladder_follows_the_shared_memory_limit():
    assert tattn.smem_limit(torch.device("cpu")) == tattn.H100_SMEM_OPTIN
    # K1 stages K and V as fp32: it fits L=420 at dh 64 on the H100, not L=421
    assert tattn.mha_smem_bytes(420, 64) <= tattn.H100_SMEM_OPTIN < tattn.mha_smem_bytes(421, 64)
    assert tclip.attention_rung(8, 420, 1024, 16, 4, False) == "mha"
    assert tclip.attention_rung(8, 421, 1024, 16, 2, False) == "qtile"
    assert tclip.attention_rung(8, 421, 1024, 16, 2, True) == "core"  # causal: no qtile
    assert tclip.attention_rung(256, 577, 1024, 16, 2, False, smem=100_000) == "core"
    # the flash kernel's shared memory does not grow with L
    assert tattn.flash_smem_bytes(64, 4) == 103_424 and tattn.flash_smem_bytes(64, 2) == 70_656


@pytest.mark.parametrize(
    "dtype_name,shape,heads,causal,rung",
    [
        ("float32", (2, 577, 128), 2, False, "core"),
        ("bfloat16", (2, 577, 128), 2, False, "qtile"),  # q and k|v as two GEMMs
        ("float32", (2, 77, 128), 2, True, "mha"),
    ],
)
def test_multi_head_attention_matches_jax(jax_side, dtype_name, shape, heads, causal, rung):
    """Each rung of ``multi_head_attention``, projections included, against the
    JAX ``multi_head_attention`` (its XLA formulation on the CPU) with the same
    weights."""
    from anomalyclip_tpu.models.clip import model as jclip

    b, l, d = shape
    dtype, _ = DTYPES[dtype_name]
    assert tclip.attention_rung(b, l, d, heads, dtype.itemsize, causal) == rung
    import jax.numpy as jnp

    rng = np.random.default_rng(8)
    arrays = {
        "x": rng.standard_normal(shape),
        "qkv_w": rng.standard_normal((d, 3 * d)) * d**-0.5,  # unit-variance projections
        "qkv_b": rng.standard_normal(3 * d) * 0.1,
        "out_w": rng.standard_normal((d, d)) * d**-0.5,
        "out_b": rng.standard_normal(d) * 0.1,
    }
    jdtype = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    j = {k: jnp.asarray(a.astype(np.float32), jdtype) for k, a in arrays.items()}
    t = {k: torch.from_numpy(a.astype(np.float32)).to(dtype) for k, a in arrays.items()}
    got = tclip.multi_head_attention(t.pop("x"), t, heads, causal)
    assert got.shape == shape and got.dtype == dtype
    _close(got, jclip.multi_head_attention(j.pop("x"), j, heads, causal), dtype_name)


def _l577_config():
    """A narrow tower with ViT-L/14@336px's sequence: 336 px, patch 14, L=577,
    width 128 = 2 heads of 64."""
    return tclip.CLIPConfig(
        embed_dim=64, image_resolution=336, vision_layers=2, vision_width=128,
        vision_patch_size=14, transformer_width=64, transformer_heads=4, transformer_layers=2,
    )


@pytest.mark.parametrize(
    "dtype,calls",
    [
        (torch.bfloat16, {"fused_mha_qtile": 2}),
        (torch.float32, {"fused_attention": 2, "flash_attention_heads": 2}),
    ],
)
def test_encode_image_at_l577_takes_the_rungs(monkeypatch, dtype, calls):
    """bf16: the q-tiled entry; fp32: the core rung, whose fused_attention
    routes to the flash entry. One call per layer; nothing takes K1."""
    seen = {k: 0 for k in ("fused_mha_qkv", "fused_mha_qtile", "fused_attention",
                           "flash_attention_heads")}

    def record(module, name):
        real = getattr(module, name)

        def wrapper(*args, **kwargs):
            seen[name] += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapper)

    for name in ("fused_mha_qkv", "fused_mha_qtile", "fused_attention"):
        record(tclip, name)
    real_flash = tattn._flash_heads  # the flash entry's call of its op

    def flash(*args):
        seen["flash_attention_heads"] += 1
        return real_flash(*args)

    monkeypatch.setattr(tattn, "_flash_heads", flash)
    cfg = _l577_config()
    params = tclip.init_clip_params(torch.Generator().manual_seed(0), cfg)
    frames = torch.from_numpy(
        np.random.default_rng(4).integers(0, 256, (2, 336, 336, 3), dtype=np.uint8)
    )
    out = tclip.encode_image(params, cfg, frames, dtype)
    assert out.shape == (2, cfg.embed_dim) and out.dtype == dtype
    assert torch.isfinite(out.float()).all()
    assert seen == {k: calls.get(k, 0) for k in seen}


def test_encode_image_at_l577_matches_jax(jax_side):
    """fp32, the core rung's flash plain version against the JAX tower on the
    same converted weights, at the composed-module tolerance of test_golden.py."""
    jax, _ = jax_side
    from anomalyclip_tpu.models.clip import model as jclip
    from anomalyclip_tpu_torch import convert

    jcfg = jclip.CLIPConfig(**{f: getattr(_l577_config(), f) for f in _l577_config().__dataclass_fields__})
    jparams = jclip.init_clip_params(jax.random.PRNGKey(5), jcfg)
    tparams = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    frames = np.random.default_rng(5).integers(0, 256, (2, 336, 336, 3), dtype=np.uint8)
    want = np.asarray(jclip.encode_image(jparams, jcfg, jax.numpy.asarray(frames)))
    got = tclip.encode_image(tparams, _l577_config(), torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# gradients: through the plain versions on the CPU, through the launches on the kernel path
# ---------------------------------------------------------------------------


def _new_entry_calls():
    """(name, the call, its inputs): one call of each new entry at a small shape."""
    rng = np.random.default_rng(6)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).requires_grad_(True)

    return [
        ("fused_mha_qtile", lambda q, kv: tattn.fused_mha_qtile(q, kv, 2), (t(2, 40, 64), t(2, 40, 128))),
        ("flash_attention_heads", lambda q, k, v: tattn.flash_attention_heads(q, k, v),
         (t(2, 150, 32), t(2, 150, 32), t(2, 150, 32))),
        ("fused_attention", lambda q, k, v: tattn.fused_attention(q, k, v, True),
         (t(1, 2, 40, 32), t(1, 2, 40, 32), t(1, 2, 40, 32))),
    ]


def test_cpu_autograd_through_the_new_entries():
    for name, call, inputs in _new_entry_calls():
        grads = torch.autograd.grad((call(*inputs) ** 2).sum(), inputs)
        for g, x in zip(grads, inputs):
            assert g.shape == x.shape and torch.isfinite(g).all() and g.abs().max() > 0, name


def test_flash_plain_grad_matches_jax(jax_side):
    """The KV-blocked plain version differentiates to the exact softmax VJP:
    held against jax.grad through the Pallas entry (its K9/K10 backward in
    interpret mode) across two of the port's KV blocks."""
    jax, jattn = jax_side
    rng = np.random.default_rng(7)
    arrays = [rng.standard_normal((2, 150, 32)).astype(np.float32) for _ in range(3)]
    want = jax.grad(
        lambda q, k, v: (jattn.flash_attention_heads(q, k, v, True) ** 2).sum(), argnums=(0, 1, 2)
    )(*arrays)
    inputs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    got = torch.autograd.grad((tattn.flash_attention_heads(*inputs) ** 2).sum(), inputs)
    for ours, theirs in zip(got, want):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=FP32_TOL, atol=FP32_TOL * np.abs(theirs).max())


@pytest.mark.parametrize(
    "index,launches",
    [(0, ("mha_qtile_bwd_kernel",)), (1, ("flash_dq_kernel", "flash_dkv_kernel")),
     (2, ("fused_attention_bwd_kernel",))],
)
def test_kernel_path_backward_raises(monkeypatch, index, launches):
    """With the kernel path forced (the launches replaced by the plain
    versions, which a CPU tensor needs), the backward no longer raises: it
    calls each of the entry's backward launches once, and the gradient is the
    plain path's."""
    name, call, inputs = _new_entry_calls()[index]
    want = torch.autograd.grad((call(*inputs) ** 2).sum(), inputs)

    calls = []

    def counted(launch, plain):
        def wrapper(*args):
            calls.append(launch)
            return plain(*args)

        monkeypatch.setattr(tattn, launch, wrapper)

    monkeypatch.setattr(tattn, "_use_reference", lambda t: False)
    monkeypatch.setattr(tattn, "mha_qtile_fwd_kernel", tattn.mha_qtile_reference)
    monkeypatch.setattr(tattn, "flash_fwd_kernel", tattn.flash_attention_reference)
    monkeypatch.setattr(tattn, "fused_attention_fwd_kernel", tattn.fused_attention_reference)
    counted("mha_qtile_bwd_kernel", tattn.mha_qtile_bwd_reference)
    counted("fused_attention_bwd_kernel", tattn.attention_bwd_reference)
    counted("flash_dq_kernel", tattn.flash_dq_reference)
    counted("flash_dkv_kernel", tattn.flash_dkv_reference)
    out = call(*inputs)
    assert out.requires_grad
    got = torch.autograd.grad((out**2).sum(), inputs)
    assert tuple(calls) == launches
    for ours, theirs in zip(got, want):
        torch.testing.assert_close(ours, theirs, rtol=0, atol=FP32_TOL * theirs.abs().max().item())


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
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,l,dtype,tol", [(256, 577, torch.bfloat16, BF16_TOL), (64, 400, torch.float32, FP32_TOL)]
)
def test_mha_qtile_kernel_matches_plain(cuda, b, l, dtype, tol):
    """K6 at the ViT-L/14@336px bf16 shape and at an fp32 shape that fits; q
    and kv are views of one tensor, as the qtile rung over a packed qkv."""
    d, heads = 1024, 16
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(b, l, 3 * d, device=cuda, generator=gen).to(dtype)
    before = tattn.launch_counts["fused_mha_qtile"]
    got = tattn.fused_mha_qtile(x[..., :d], x[..., d:], heads)
    want = tattn.mha_qtile_reference(x[..., :d], x[..., d:], heads)
    torch.cuda.synchronize()
    assert tattn.launch_counts["fused_mha_qtile"] == before + 1
    _gpu_close(got, want, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _GPU_DTYPES)
def test_flash_kernel_matches_plain(cuda, dtype, tol):
    """K8 at the fp32 tower's per-head shape, with the log-sum-exp."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = torch.randn(3, 4096, 577, 64, device=cuda, generator=gen).to(dtype)
    before = tattn.launch_counts["flash_attention_heads"]
    out, lse = tattn.flash_attention_heads(q, k, v, save_lse=True)
    want_out, want_lse = tattn.flash_attention_reference(q, k, v, save_lse=True)
    torch.cuda.synchronize()
    assert tattn.launch_counts["flash_attention_heads"] == before + 1
    _gpu_close(out, want_out, tol)
    _gpu_close(lse, want_lse, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _GPU_DTYPES)
@pytest.mark.parametrize(
    "shape,causal,flash",
    [((256, 12, 197, 64), False, 0), ((256, 12, 197, 64), True, 0), ((32, 16, 577, 64), False, 1)],
)
def test_fused_attention_kernel_matches_plain(cuda, dtype, tol, shape, causal, flash):
    """K5 on its whole-block branch (K2's kernel, heads folded), which counts
    under fused_attention, and its flash branch, which launches K8 and counts
    under flash_attention_heads alone."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = torch.randn(3, *shape, device=cuda, generator=gen).to(dtype)
    tattn.reset_launch_counts()
    got = tattn.fused_attention(q, k, v, causal)
    want = tattn.fused_attention_reference(q, k, v, causal)
    torch.cuda.synchronize()
    assert tattn.launch_counts["fused_attention"] == 1 - flash
    assert tattn.launch_counts["flash_attention_heads"] == flash
    assert tattn.launch_counts["fused_mha_bld"] == 0
    _gpu_close(got, want, tol)


@pytest.mark.gpu
def test_long_kernels_reject_what_they_do_not_take(cuda):
    # fp32 K and V of a head at L=577 exceed a block's shared memory
    q = torch.zeros(2, 577, 128, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        tattn.fused_mha_qtile(q, torch.zeros(2, 577, 256, device=cuda), 2)
    with pytest.raises(ValueError, match=r"\(2, 10, 48\)"):
        tattn.flash_attention_heads(*torch.zeros(3, 2, 10, 48, device=cuda))
    # the whole-block kernel's wrapper refuses a causal shape past its shared
    # memory; the entry, which chooses by shape before the call, launches the
    # flash kernel with the mask
    with pytest.raises(ValueError, match="shared memory"):
        tattn.fused_attention_fwd_kernel(*torch.zeros(3, 1, 2, 577, 64, device=cuda), True)
    tattn.reset_launch_counts()
    assert tattn.fused_attention(*torch.zeros(3, 1, 2, 577, 64, device=cuda), True).shape == (1, 2, 577, 64)
    assert tattn.launch_counts["flash_attention_heads"] == 1
    with tattn.attention_impl("reference"):
        assert tattn.fused_attention(*torch.zeros(3, 1, 2, 577, 64, device=cuda), True).shape == (1, 2, 577, 64)
    assert sum(tattn.launch_counts.values()) == 1
