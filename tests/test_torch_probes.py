"""The port's attention probes and measurement scripts against the JAX package's.

On the CPU the probe wrappers run their plain PyTorch versions. Held here:

- each plain version against the Pallas body that the JAX script launches, in
  interpret mode: the JAX scripts (scripts/bench_attn_l14.py, probe_qkv_gb.py,
  probe_qtile_vmem.py) are loaded by file path and left as they are; their
  module globals are set small (B=2, D=128, two heads of 64; L stays 577, and
  576 for the aligned case) and ``pallas_call`` is wrapped to drop the TPU
  compiler parameters and run in interpret mode. fp32 within 1e-5 and bf16
  within 5e-2, absolute (anomalyclip_tpu/ops/pallas/attention.py:22-25);
- the KV-part plain version against the whole-row one, and its short last part;
  the plain versions against the shipped kernels' plain versions at their
  rounding blocks (bf16 64-key blocks, fp32 split-TF32 products);
- the Python of each wrapper (shape checks, views and strides, counters, the
  refusals with their sizes) with the library replaced by a numpy version of
  its entries that reads and writes through the pointers it is given;
- the shared-memory formulas at the scripts' shapes and the rung each
  ``validate_*`` shape takes;
- the tower ablation at the tiny width against the JAX package's three towers on
  converted weights, and that the patched attention is put back;
- every script with ``--device cpu``: it runs to the end and prints no times;
- the entry points' device defaults.

The ``gpu`` cases hold each kernel against its plain version on the card, at
each knob (rows, warps, residency, parts, heads a block, the softmax), hold the
tile probe at the shipped block equal to ``fused_mha_qtile`` and
``fused_mha_qkv`` to the bit, and import no JAX.
"""

from __future__ import annotations

import ctypes
import importlib
import importlib.util
import inspect
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from anomalyclip_tpu_torch.models.clip import model as tclip
from anomalyclip_tpu_torch.ops import attention as tattn
from anomalyclip_tpu_torch.ops import attention_probes as probes
from anomalyclip_tpu_torch.scripts import bench_attn_l14 as tbench
from anomalyclip_tpu_torch.scripts import validate_pickgb, validate_qtile_config

ROOT = Path(__file__).resolve().parents[1]
FP32_TOL, BF16_TOL = 1e-5, 5e-2
TOL = {"float32": FP32_TOL, "bfloat16": BF16_TOL}
TDTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B, D, H = 2, 128, 2  # the small globals both sides run at: two heads of 64


@pytest.fixture(scope="module")
def jax_side():
    """(jax, the JAX package's Pallas attention module), JAX on the CPU."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platforms", "cpu")
    from anomalyclip_tpu.ops.pallas import attention

    return jax, attention


@pytest.fixture
def interpret_mode(jax_side, monkeypatch):
    """Every ``pallas_call`` runs in interpret mode, without the TPU's compiler
    parameters: the scripts' own calls pass neither."""
    from jax.experimental import pallas as pl

    real = pl.pallas_call

    def interpreted(*args, compiler_params=None, interpret=None, **kwargs):
        return real(*args, interpret=True, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interpreted)


def _load_script(name: str):
    """A script of the JAX package as a module, by file path, untouched."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = path  # the scripts put the repository root in front
    return module


def _small(module, l: int):
    module.B, module.D, module.H, module.L = B, D, H, l
    module.DH, module.SCALE = D // H, 1.0 / math.sqrt(D // H)
    return module


def _inputs(rng, shapes, dtype_name, scale=1.0):
    """Seeded numpy inputs, rounded to the dtype once -> (jax arrays, torch tensors)."""
    import jax.numpy as jnp

    arrays = [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]
    jdtype = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    return ([jnp.asarray(a, jdtype) for a in arrays],
            [torch.from_numpy(a).to(TDTYPE[dtype_name]) for a in arrays])


def _close(got, want, dtype_name, what=""):
    got = got.detach().float().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype_name], err_msg=what)


# ---------------------------------------------------------------------------
# the plain versions against the JAX scripts' Pallas bodies in interpret mode
# ---------------------------------------------------------------------------

def _tile_plain(q, kv):
    return probes.tile_reference(q, kv[..., :D], kv[..., D:], H)


# variant -> its plain version as f(q, kv), and whether a block's shared memory
# fits at L=577 in (fp32, bf16): K and V of a head resident in fp32 do not
VARIANTS = {
    "qtile-lq120": (_tile_plain, (True, True)),
    "qtile-lq120-resident": (_tile_plain, (False, True)),
    "qtilegb2-lq128": (_tile_plain, (True, True)),
    "twopass-gb2": (lambda q, kv: probes.parts_reference(q, kv, H, 2), (True, True)),
    "whole-gb1": (_tile_plain, (False, True)),
    "pair-gb2": (lambda q, kv: probes.parts_reference(q, kv, H, probes.pair_parts(q)), (True, True)),
    "nosoftmax": (lambda q, kv: probes.nosoftmax_reference(q, kv, H), (True, True)),
}


@pytest.mark.parametrize("dtype_name", list(TOL))
@pytest.mark.parametrize("l", [577, 576])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_plain_matches_the_jax_scripts_pallas_body(
    jax_side, interpret_mode, monkeypatch, variant, l, dtype_name
):
    jbench = _small(_load_script("bench_attn_l14"), l)
    monkeypatch.setattr(tbench, "H", H)
    monkeypatch.setattr(tbench, "D", D)
    # nosoftmax has no normalisation: its output grows with the inputs, so it
    # gets the script's own input scale, under which the absolute limits hold
    scale = 0.02 if variant == "nosoftmax" else 1.0
    (jq, jkv), (q, kv) = _inputs(np.random.default_rng(30), [(B, l, D), (B, l, 2 * D)], dtype_name, scale)
    plain, fits = VARIANTS[variant]
    got = plain(q, kv)
    assert got.dtype == q.dtype
    # the port's residency suffix is not in the JAX grammar: its q tile keeps K and V resident
    _close(got, jbench.make_variant(variant.removesuffix("-resident"))(jq, jkv), dtype_name, variant)
    # the port's variant of that name: on the CPU its plain version, or, where a
    # block would not fit the card, the refusal with the sizes (as the TPU
    # variant fails in its compiler)
    ours = tbench.make_variant(variant)
    if fits[dtype_name == "bfloat16"]:
        assert torch.equal(ours.run(q, kv), got)
    else:
        with pytest.raises(probes.ProbeDoesNotFit, match=r"needs \d+ B .* given 232448 B"):
            ours.run(q, kv)


@pytest.mark.parametrize("dtype_name", list(TOL))
def test_whole_variant_runs_where_it_fits(jax_side, interpret_mode, monkeypatch, dtype_name):
    """``whole`` at a ``--seq`` whose K and V fit resident as fp32."""
    l = 360
    jbench = _small(_load_script("bench_attn_l14"), l)
    monkeypatch.setattr(tbench, "H", H)
    monkeypatch.setattr(tbench, "D", D)
    (jq, jkv), (q, kv) = _inputs(np.random.default_rng(31), [(B, l, D), (B, l, 2 * D)], dtype_name)
    _close(tbench.make_variant("whole-gb1").run(q, kv), jbench.make_variant("whole-gb1")(jq, jkv),
           dtype_name)


@pytest.mark.parametrize("dtype_name", list(TOL))
@pytest.mark.parametrize("l,causal", [(197, False), (77, True)])
def test_probe_qkv_plain_matches_the_jax_probe(jax_side, interpret_mode, l, causal, dtype_name):
    jprobe = _load_script("probe_qkv_gb")
    (jqkv,), (qkv,) = _inputs(np.random.default_rng(32), [(B, l, 3 * D)], dtype_name)
    for limit in (None, jprobe.LIMIT):
        want = jprobe.make(B, l, D, H, 2, limit, causal)(jqkv)
        got = probes.probe_mha_qkv(qkv, H, causal, rows=32, warps=4)
        _close(got, want, dtype_name)


@pytest.mark.parametrize("dtype_name", list(TOL))
@pytest.mark.parametrize("gb,lq", [(2, 120), (1, 128)])
def test_probe_qtile_plain_matches_the_jax_probe(jax_side, interpret_mode, gb, lq, dtype_name):
    jprobe = _small(_load_script("probe_qtile_vmem"), 577)
    (jq, jkv), (q, kv) = _inputs(np.random.default_rng(33), [(B, 577, D), (B, 577, 2 * D)], dtype_name)
    got = probes.probe_mha_qtile(q, kv, H, rows=lq, warps=4 * gb)
    _close(got, jprobe.make(gb, lq)(jq, jkv), dtype_name)
    if dtype_name == "float32":
        # K and V of 577 keys resident fit as bf16 only
        with pytest.raises(probes.ProbeDoesNotFit, match="K and V resident"):
            probes.probe_mha_qtile(q, kv, H, rows=lq, warps=4 * gb, residency="resident")
    else:  # the residency moves no rounding
        assert torch.equal(probes.probe_mha_qtile(q, kv, H, rows=lq, warps=4 * gb, residency="resident"), got)


@pytest.mark.parametrize("l,parts", [(577, 2), (100, 3), (64, 1), (130, 4)])
def test_parts_plain_is_the_whole_row_function_in_fp32(l, parts):
    """The same function in another order; the last part is short whenever L is
    not a multiple of the part length (577 = 289 + 288, 100 = 34 + 34 + 32)."""
    rng = np.random.default_rng(34)
    q = torch.from_numpy(rng.standard_normal((2, l, D)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, l, 2 * D)).astype(np.float32))
    want = tattn.mha_qtile_reference(q, kv, H)
    torch.testing.assert_close(probes.parts_reference(q, kv, H, parts), want, rtol=0, atol=FP32_TOL)
    torch.testing.assert_close(probes.twopass_mha(q, kv, H, parts=parts), want, rtol=0, atol=FP32_TOL)
    # a tail of keys that the parts must not see: the answer ignores what lies
    # past L in a longer buffer
    longer = torch.cat([kv, torch.full((2, 7, 2 * D), 1e4)], dim=1)[:, :l]
    assert torch.equal(probes.parts_reference(q, longer, H, parts), probes.parts_reference(q, kv, H, parts))


def test_parts_plain_rounds_like_the_kernel_in_bf16():
    """p is rounded against the running max of its part, so the bf16 answer is
    not the whole-row plain version's to the bit, and is within the tolerance."""
    rng = np.random.default_rng(35)
    q = torch.from_numpy(rng.standard_normal((2, 300, D)).astype(np.float32)).bfloat16()
    kv = torch.from_numpy(rng.standard_normal((2, 300, 2 * D)).astype(np.float32)).bfloat16()
    whole, parts = tattn.mha_qtile_reference(q, kv, H), probes.parts_reference(q, kv, H, 2)
    assert not torch.equal(whole, parts)
    torch.testing.assert_close(parts.float(), whole.float(), rtol=0, atol=BF16_TOL)


@pytest.mark.parametrize("dtype_name", list(TOL))
@pytest.mark.parametrize("causal", [False, True])
def test_tile_plain_rounds_like_the_shipped_kernels_plain_versions(dtype_name, causal):
    """The tile probe's plain version is the one the shipped kernels are held
    to, to the bit: in bf16 the 64-key blocks of mha_tc.cu
    (``attention_blocked_reference``), in fp32 the split-TF32 products of
    mha_tf32.cu (``tf32x3_reference``)."""
    rng = np.random.default_rng(36)
    qkv = torch.from_numpy(rng.standard_normal((2, 150, 3 * D)).astype(np.float32)).to(TDTYPE[dtype_name])
    got = probes.probe_mha_qkv(qkv, H, causal, rows=48, warps=8, residency="resident")
    if dtype_name == "bfloat16":
        want = tattn.mha_qkv_reference(qkv, H, causal, block=tattn.MHA_TC_BLOCK_KV)
    else:
        want = tattn.mha_qkv_tf32x3_reference(qkv, H, causal)
    assert torch.equal(got, want)
    # and the whole-row plain version within the limit
    _close(got, tattn.mha_qkv_reference(qkv.float(), H, causal), dtype_name)


@pytest.mark.parametrize("l,parts,steps", [
    (577, 2, [(0, 64), (64, 128), (128, 192), (192, 256), (256, 289), (289, 353), (353, 417),
              (417, 481), (481, 545), (545, 577)]),
    (100, 3, [(0, 34), (34, 68), (68, 100)]),
    (130, 1, [(0, 64), (64, 128), (128, 130)]),
    (200, 2, [(0, 64), (64, 100), (100, 164), (164, 200)]),
])
def test_parts_steps_restart_at_each_part(l, parts, steps):
    """The parts probe sweeps each part in 64-key steps from its start, the last
    step of a part short: where bf16 rounds p."""
    assert probes.parts_steps(l, parts) == steps
    assert probes.tile_steps(l) == [(s, min(s + 64, l)) for s in range(0, l, 64)]


# ---------------------------------------------------------------------------
# the wrappers' Python, the library replaced by numpy
# ---------------------------------------------------------------------------


class NumpyProbeKernels:
    """The C entries of ops/csrc/mha_probe.cu in numpy (fp32 only): the kernels'
    arithmetic without their tiling, reading and writing through the raw
    pointers and (batch, row) element strides the wrappers pass, so that a wrong
    view, stride or argument order shows."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _view(address, bs, rs, shape):
        b, l, d = shape
        span = 1 + (b - 1) * bs + (l - 1) * rs + (d - 1)
        flat = np.ctypeslib.as_array(ctypes.cast(address, ctypes.POINTER(ctypes.c_float)), (span,))
        return np.lib.stride_tricks.as_strided(flat, shape, (4 * bs, 4 * rs, 4))

    @staticmethod
    def _attend(q, k, v, heads, causal, scale, softmax=True):
        b, l, d = q.shape
        qh, kh, vh = (t.reshape(b, l, heads, d // heads).transpose(0, 2, 1, 3) for t in (q, k, v))
        s = np.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
        if causal:
            s = np.where(np.tril(np.ones((l, l), bool)), s, -1e30)
        if softmax:
            s = np.exp(s - s.max(axis=-1, keepdims=True))
            s = s / s.sum(axis=-1, keepdims=True)
        return np.einsum("bhqk,bhkd->bhqd", s, vh).transpose(0, 2, 1, 3).reshape(b, l, d)

    def _out(self, out, shape):
        return self._view(out, shape[1] * shape[2], shape[2], shape)

    def acl_probe_qkv_fwd(self, dtype, resident, rows, warps, qkv, bs, rs, out, b, l, h, dh, causal,
                          scale, stream):
        assert dtype == 0
        self.calls.append(("qkv", resident, rows, warps))
        d = h * dh
        x = self._view(qkv, bs, rs, (b, l, 3 * d))
        self._out(out, (b, l, d))[...] = self._attend(
            x[..., :d], x[..., d:2 * d], x[..., 2 * d:], h, causal, scale)
        return 0

    def _qtile(self, tag, softmax, dtype, resident, rows, warps, q, q_bs, q_rs, kv, kv_bs, kv_rs, out,
               b, l, h, dh, scale, stream):
        assert dtype == 0
        self.calls.append((tag, resident, rows, warps))
        d = h * dh
        qv, kvv = self._view(q, q_bs, q_rs, (b, l, d)), self._view(kv, kv_bs, kv_rs, (b, l, 2 * d))
        self._out(out, (b, l, d))[...] = self._attend(
            qv, kvv[..., :d], kvv[..., d:], h, False, scale, softmax)
        return 0

    def acl_probe_qtile_fwd(self, *args):
        return self._qtile("qtile", True, *args)

    def acl_probe_nosoftmax_fwd(self, *args):
        return self._qtile("nosoftmax", False, *args)

    def acl_probe_bld_fwd(self, dtype, resident, rows, warps, q, q_bs, q_rs, k, k_bs, k_rs, v, v_bs,
                          v_rs, out, b, l, h, dh, causal, scale, stream):
        assert dtype == 0
        self.calls.append(("bld", resident, rows, warps))
        d = h * dh
        views = [self._view(p, bs, rs, (b, l, d))
                 for p, bs, rs in ((q, q_bs, q_rs), (k, k_bs, k_rs), (v, v_bs, v_rs))]
        self._out(out, (b, l, d))[...] = self._attend(*views, h, causal, scale)
        return 0

    def acl_mha_parts_fwd(self, dtype, hpb, rows, warps, part, q, q_bs, q_rs, k, k_bs, k_rs, v,
                          v_bs, v_rs, out, b, l, h, dh, scale, stream):
        assert dtype == 0 and h % hpb == 0
        self.calls.append(("parts", hpb, rows, warps, part))
        d = h * dh
        views = [self._view(p, bs, rs, (b, l, d))
                 for p, bs, rs in ((q, q_bs, q_rs), (k, k_bs, k_rs), (v, v_bs, v_rs))]
        self._out(out, (b, l, d))[...] = self._attend(*views, h, False, scale)
        return 0


@pytest.fixture
def numpy_kernels(monkeypatch):
    """The kernel launches on CPU tensors: the library in numpy; the reference
    branch, the device check and the stream lookup out of the way."""
    fake = NumpyProbeKernels()
    monkeypatch.setattr(probes, "load_library", lambda: fake)
    monkeypatch.setattr(tattn, "_use_reference", lambda t: False)
    monkeypatch.setattr(tattn, "_stream", lambda t: None)
    real_check = probes._check
    monkeypatch.setattr(probes, "_check", lambda name, t, *args: real_check(name, _AsCuda(t), *args))
    probes.reset_launch_counts()
    return fake


class _AsCuda:
    """A CPU tensor that says it is on the card, for the wrappers' shape checks."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda")

    def __getattr__(self, name):
        return getattr(self._t, name)


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _counts(**expected):
    return {k: expected.get(k, 0) for k in probes.launch_counts}


def test_tile_probe_wrappers_read_views_in_place_and_count(numpy_kernels):
    rng = np.random.default_rng(40)
    x = _randn(rng, 2, 150, 3 * D)
    got = probes.probe_mha_qkv(x, H, True, rows=32, warps=16)
    torch.testing.assert_close(got, tattn.mha_qkv_reference(x, H, True), rtol=0, atol=FP32_TOL)
    # q and kv as column slices of the packed projection, as the qtile rung has them
    q, kv = x[..., :D], x[..., D:]
    got = probes.probe_mha_qtile(q, kv, H, rows=73, warps=4)
    torch.testing.assert_close(got, tattn.mha_qtile_reference(q, kv, H), rtol=0, atol=FP32_TOL)
    got, want = probes.nosoftmax_mha(q, kv, H, rows=128), probes.nosoftmax_reference(q, kv, H)
    torch.testing.assert_close(got, want, rtol=0, atol=FP32_TOL * want.abs().max().item())
    got = probes.probe_mha_whole(q, kv[..., :D], kv[..., D:], H, warps=4)
    torch.testing.assert_close(got, tattn.mha_bld_reference(q, kv[..., :D], kv[..., D:], H),
                               rtol=0, atol=FP32_TOL)
    # K and V streamed by default, resident for whole; whole: L rows
    assert numpy_kernels.calls == [("qkv", 0, 32, 16), ("qtile", 0, 73, 4), ("nosoftmax", 0, 128, 4),
                                   ("bld", 1, 150, 4)]
    probes.probe_mha_qtile(q, kv, H, warps=8, residency="resident")
    assert numpy_kernels.calls[-1] == ("qtile", 1, 64, 8)
    assert probes.launch_counts == _counts(probe_mha_qkv=1, probe_mha_qtile=2, nosoftmax_mha=1,
                                           probe_mha_whole=1)


def test_parts_wrappers_cut_the_keys_and_count(numpy_kernels):
    rng = np.random.default_rng(41)
    x = _randn(rng, 2, 577, 3 * D)
    q, kv = x[..., :D], x[..., D:]
    want = tattn.mha_qtile_reference(q, kv, H)
    torch.testing.assert_close(probes.twopass_mha(q, kv, H), want, rtol=0, atol=FP32_TOL)
    torch.testing.assert_close(probes.twopass_mha(q, kv, H, parts=3, rows=32, warps=16), want,
                               rtol=0, atol=FP32_TOL)
    torch.testing.assert_close(probes.pair_mha(q, kv, H), want, rtol=0, atol=FP32_TOL)
    # twopass: ceil(577 / 2) and ceil(577 / 3) keys a part, one head a block; pair
    # in fp32: four parts of 145 keys are the fewest that fit two heads
    assert numpy_kernels.calls == [("parts", 1, 64, 4, 289), ("parts", 1, 32, 16, 193),
                                   ("parts", 2, 64, 8, 145)]
    assert probes.launch_counts == _counts(twopass_mha=2, pair_mha=1)


def test_probe_refusals_name_the_sizes(numpy_kernels):
    q, kv = torch.zeros(2, 577, D), torch.zeros(2, 577, 2 * D)
    with pytest.raises(probes.ProbeDoesNotFit, match="needs 358400 B of shared memory per block, given 232448 B"):
        probes.probe_mha_whole(q, kv[..., :D], kv[..., D:], H)
    with pytest.raises(probes.ProbeDoesNotFit, match="given 49152 B") as info:
        probes.probe_mha_qkv(torch.zeros(2, 197, 3 * D), H, smem_cap=probes.SMEM_DEFAULT)
    assert (info.value.need, info.value.have) == (tattn.mha_tf32_smem_bytes(64), 49152)
    with pytest.raises(probes.ProbeDoesNotFit, match="2 KV parts of 289 keys"):
        probes.twopass_mha(q, kv, H, rows=512)
    with pytest.raises(probes.ProbeDoesNotFit):
        probes.pair_mha(q, kv, H, rows=1024)
    assert numpy_kernels.calls == [] and probes.launch_counts == _counts()
    # what the kernels do not take
    with pytest.raises(ValueError, match="the probes take 64"):
        probes.probe_mha_qtile(torch.zeros(2, 50, 64), torch.zeros(2, 50, 128), 2)
    with pytest.raises(ValueError, match="5 warps per block"):
        probes.probe_mha_qtile(torch.zeros(2, 50, D), torch.zeros(2, 50, 2 * D), H, warps=5)
    with pytest.raises(ValueError, match="kv .* for q"):
        probes.twopass_mha(q, kv[:, :100], H)
    with pytest.raises(ValueError, match="16-byte boundary"):
        base = torch.zeros(2, 50, 2 * D + 2)
        probes.twopass_mha(torch.zeros(2, 50, D), base[..., 1:-1], H)
    with pytest.raises(ValueError, match="do not split into groups of 2"):
        probes.pair_mha(torch.zeros(2, 50, 3 * 64), torch.zeros(2, 50, 6 * 64), 3)
    with pytest.raises(ValueError, match="residency 'vmem' is not one of"):
        probes.probe_mha_qtile(torch.zeros(2, 50, D), torch.zeros(2, 50, 2 * D), H, residency="vmem")
    with pytest.raises(ValueError, match="qkv .*: every row must start at a 16-byte boundary"):
        base = torch.zeros(2, 50, 3 * D + 1)
        probes.probe_mha_qkv(base[..., 1:], H)
    assert numpy_kernels.calls == [] and probes.launch_counts == _counts()


def test_probes_on_the_cpu_run_the_plain_versions_and_count_nothing():
    probes.reset_launch_counts()
    rng = np.random.default_rng(42)
    q, kv = _randn(rng, 2, 90, D), _randn(rng, 2, 90, 2 * D)
    assert torch.equal(probes.probe_mha_qtile(q, kv, H, rows=32, warps=16),
                       tattn.mha_qtile_tf32x3_reference(q, kv, H))
    assert torch.equal(probes.nosoftmax_mha(q, kv, H), probes.nosoftmax_reference(q, kv, H))
    assert torch.equal(probes.pair_mha(q, kv, H), probes.parts_reference(q, kv, H, 1))
    assert probes.launch_counts == _counts()


# ---------------------------------------------------------------------------
# formulas and rungs, as pure functions
# ---------------------------------------------------------------------------


def test_shared_memory_formulas_at_the_scripts_shapes():
    tile = probes.tile_smem_bytes
    # streamed, the shipped block's shared memory whatever L: mha_tc.cu's and mha_tf32.cu's
    for l in (50, 197, 577, 1024):
        assert tile(l, 64, 2, 4, "streamed") == tattn.mha_tc_smem_bytes(64) == 46_080
        assert tile(l, 64, 4, 4, "streamed") == tattn.mha_tf32_smem_bytes(64) == 71_680
    assert tile(577, 64, 2, 16, "streamed") == 46_080 + 12 * 16 * 72 * 2  # the warps' q rows
    # resident: K and V of 640 rows at L=577 in bf16 (the TPU's form) fit; in fp32 not
    assert tile(577, 64, 2, 4, "resident") == 193_536 <= tattn.H100_SMEM_OPTIN
    assert tile(577, 64, 2, 16, "resident") == 221_184 <= tattn.H100_SMEM_OPTIN
    assert tile(577, 64, 4, 4, "resident") == 358_400 > tattn.H100_SMEM_OPTIN
    assert tile(360, 64, 4, 4, "resident") == 215_040 <= tattn.H100_SMEM_OPTIN < tile(400, 64, 4, 4, "resident")
    # 577 keys stage a tenth 64-row block for one key: 576 do not
    assert tile(576, 64, 2, 4, "resident") == 175_104 == tile(577, 64, 2, 4, "resident") - 64 * 2 * 72 * 2
    # twopass at L=577 in bf16: two blocks fit an SM's 227 KB
    assert probes.kv_part_length(577, 2) == 289
    twopass = probes.parts_smem_bytes(64, 289, 64, 2, 4, 1)
    assert twopass == 101_376 and 2 * twopass <= tattn.H100_SMEM_OPTIN
    # a warp that sweeps several tiles keeps their state in shared memory: 36
    # floats a lane a tile
    assert probes.tiles_per_warp(64, 4, 1) == 1 and probes.tiles_per_warp(64, 4, 2) == 2
    assert probes.parts_smem_bytes(64, 289, 64, 2, 4, 2) == 192_512 - 4 * 16 * 72 * 2 + 4 * 4 * 2 * 36 * 32
    # pair: both heads' halves in bf16 fit one block; in fp32 four parts are needed
    assert probes.parts_smem_bytes(64, 289, 64, 2, 8, 2) == 192_512
    assert probes.fewest_parts(577, 64, 64, 2, 8, 2, tattn.H100_SMEM_OPTIN) == 2
    assert probes.fewest_parts(577, 64, 64, 4, 8, 2, tattn.H100_SMEM_OPTIN) == 4
    assert probes.fewest_parts(197, 64, 64, 2, 8, 2, tattn.H100_SMEM_OPTIN) == 1
    with pytest.raises(probes.ProbeDoesNotFit):
        probes.fewest_parts(577, 64, 64, 2, 8, 2, 20_000)


@pytest.mark.parametrize("dtype_name", list(TOL))
@pytest.mark.parametrize("residency", ["streamed", "resident"])
def test_refusal_sizes_of_each_residency(dtype_name, residency):
    """The size a refusal names is the formula's at the wrapper's tiling, for
    each residency; under a cap the streamed block fits, the same call refuses."""
    q = torch.zeros(1, 577, D, dtype=TDTYPE[dtype_name])
    kv = torch.zeros(1, 577, 2 * D, dtype=TDTYPE[dtype_name])
    need = probes.tile_smem_bytes(577, 64, q.element_size(), 8, residency)
    have = min(need - 1, tattn.H100_SMEM_OPTIN)  # a cap above the card's limit is the limit
    with pytest.raises(probes.ProbeDoesNotFit, match=f"K and V {residency}") as info:
        probes.probe_mha_qtile(q, kv, H, warps=8, residency=residency, smem_cap=need - 1)
    assert (info.value.need, info.value.have) == (need, have)
    if need <= tattn.H100_SMEM_OPTIN:
        assert probes.probe_mha_qtile(q, kv, H, warps=8, residency=residency, smem_cap=need).shape == q.shape


def test_the_rung_each_validate_shape_takes():
    smem = tattn.H100_SMEM_OPTIN
    assert validate_pickgb.longest_mha_length(smem) == 420
    assert tattn.mha_smem_bytes(420, 64) <= smem < tattn.mha_smem_bytes(421, 64)
    for b, l, d, h, causal, _ in validate_pickgb.SHAPES:
        assert tclip.attention_rung(b, l, d, h, 2, causal) == "mha"
    (_, top, *_), (_, past, *_) = validate_pickgb.envelope_shapes(smem)
    assert tclip.attention_rung(32, top, 1024, 16, 2, False) == "mha"
    assert tclip.attention_rung(32, past, 1024, 16, 2, False) == "qtile"
    assert validate_qtile_config.longest_qtile_length(64, smem) == 789
    rungs = [tclip.attention_rung(b, l, d, h, 2, False) for b, l, d, h in validate_qtile_config.SHAPES]
    assert rungs == ["qtile", "core", "core", "core"]


# ---------------------------------------------------------------------------
# the tower ablation
# ---------------------------------------------------------------------------


def test_tower_ablation_matches_the_jax_towers(jax_side):
    """The tiny image tower under the fused, identity and plain attention on
    converted weights, against the JAX package's tower under the same three
    (its identity attention is the JAX script's)."""
    jax, _ = jax_side
    import jax.numpy as jnp

    from anomalyclip_tpu.models.clip import model as jclip
    from anomalyclip_tpu_torch import convert

    jcfg, tcfg = jclip.CLIPConfig.tiny(), tclip.CLIPConfig.tiny()
    jparams = jclip.init_clip_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    frames = np.random.default_rng(50).standard_normal((3, 32, 32, 3)).astype(np.float32)

    def identity_mha(x, attn, num_heads, causal=False):  # scripts/bench_attn_l14.py:332-335
        d = x.shape[-1]
        qkv = x @ attn["qkv_w"] + attn["qkv_b"]
        return qkv[..., 2 * d:] @ attn["out_w"] + attn["out_b"]

    def jax_tower(mode):
        if mode == "identity":
            real = jclip.multi_head_attention
            jclip.multi_head_attention = identity_mha
            try:
                return np.asarray(jclip.encode_image(jparams, jcfg, jnp.asarray(frames)))
            finally:
                jclip.multi_head_attention = real
        if mode == "plain":
            with jclip.attention_impl("xla"):
                return np.asarray(jclip.encode_image(jparams, jcfg, jnp.asarray(frames)))
        return np.asarray(jclip.encode_image(jparams, jcfg, jnp.asarray(frames)))

    features = {}
    for mode in ("fused", "identity", "plain"):
        with tbench.tower_attention(mode):
            features[mode] = tclip.encode_image(tparams, tcfg, torch.from_numpy(frames)).numpy()
        np.testing.assert_allclose(features[mode], jax_tower(mode), rtol=1e-4, atol=1e-4, err_msg=mode)
    assert np.abs(features["identity"] - features["fused"]).max() > 1e-3  # another function


def test_identity_attention_keeps_both_projections_on_the_qtile_rung():
    """At a qtile-rung shape v is the second half of the packed k|v GEMM."""
    rng = np.random.default_rng(51)
    d = 64
    x = _randn(rng, 1, 577, d).bfloat16()
    attn = {"qkv_w": _randn(rng, d, 3 * d).bfloat16(), "qkv_b": _randn(rng, 3 * d).bfloat16(),
            "out_w": _randn(rng, d, d).bfloat16(), "out_b": _randn(rng, d).bfloat16()}
    assert tclip.attention_rung(1, 577, d, 1, 2, False) == "qtile"
    want = (x @ attn["qkv_w"][:, 2 * d:] + attn["qkv_b"][2 * d:]) @ attn["out_w"] + attn["out_b"]
    torch.testing.assert_close(tbench.identity_mha(x, attn, 1).float(), want.float(), rtol=0, atol=BF16_TOL)


def test_tower_attention_is_put_back_after_an_exception():
    real = tclip.multi_head_attention
    with pytest.raises(RuntimeError, match="inside"):
        with tbench.tower_attention("identity"):
            assert tclip.multi_head_attention is tbench.identity_mha
            raise RuntimeError("inside")
    assert tclip.multi_head_attention is real
    with pytest.raises(ValueError, match="not fused, identity or plain"):
        with tbench.tower_attention("xla"):
            pass


# ---------------------------------------------------------------------------
# the scripts on the CPU
# ---------------------------------------------------------------------------

_SCRIPTS = [
    ("bench_eval", []),
    ("bench_latency", ["--path", "both"]),
    ("bench_train_step", []),
    ("bench_attn_l14", ["--check", "--variants",
                        "qtile,qtile-lq120,twopass,nosoftmax,plain,whole,pair-gb2,qtilegb4-lq73-resident,"
                        "twopass-lq512"]),
    ("bench_attn_l14", ["--check", "--seq", "400", "--variants", "whole-gb1,pair,nosoftmaxgb1-lq32"]),
    ("bench_attn_l14", ["--tower"]),
    ("probe_qkv_gb", ["text", "fp32"]),
    ("probe_qkv_gb", ["b16", "bf16", "32,4", "64,16,resident"]),
    ("probe_qtile_vmem", ["73,8", "145,16,resident"]),
    ("validate_pickgb", []),
    ("validate_qtile_config", []),
    ("bench_attn_bwd", ["--qtile"]),
    ("bench_mha_tc", []),
    ("bench_mha_tc", ["text", "--sass"]),
    ("probe_bf16_drift", ["--seeds", "1"]),
    ("bench_attn_bwd", ["--flash", "--dtype", "bf16"]),
    ("probe_int8_drift", []),
    ("probe_int8_drift", ["--dtype", "bf16"]),
]


@pytest.mark.parametrize("script,argv", _SCRIPTS, ids=[f"{s}{i}" for i, (s, _) in enumerate(_SCRIPTS)])
def test_script_runs_to_the_end_on_the_cpu_and_prints_no_times(script, argv, capsys):
    module = importlib.import_module(f"anomalyclip_tpu_torch.scripts.{script}")
    try:
        module.main([*argv, "--device", "cpu"])
    except SystemExit as exc:  # the validate scripts exit with their verdict
        assert exc.code == 0
    out = capsys.readouterr().out
    assert out.startswith("# device: cpu")
    assert " ms" not in out and "fps" not in out and "FAIL" not in out
    if script == "bench_attn_l14" and "twopass-lq512" in " ".join(argv):
        # whole at L=577 in bf16 fits resident; 32 tiles of a head over 4 warps keep
        # their state in shared memory, which does not fit
        assert "whole              max|diff|" in out
        assert "twopass-lq512      does not fit: needs 248832 B" in out


def test_probe_bf16_drift_returns_its_readings(capsys):
    """What the script prints it also returns, one entry a seed: per layer the
    stream's max, the kernel's local gap, one bf16 step of the stream and the gap
    in such steps, the streams' gaps, and the embedding's gaps. On the CPU the
    kernel form is the ``blocked`` plain one, so its gaps are 0."""
    from anomalyclip_tpu_torch.scripts import probe_bf16_drift as drift

    readings = drift.main(["--seeds", "2", "--device", "cpu"])
    capsys.readouterr()
    layers = tclip.CLIPConfig.tiny().vision_layers
    assert [r["seed"] for r in readings] == [0, 1] and all(r["frames"] == 2 for r in readings)
    for r in readings:
        assert [at["layer"] for at in r["layers"]] == list(range(1, layers + 1))
        for at in r["layers"]:
            assert set(at) == {"layer", "stream_max", "local_gap", "step", "local_steps", "stream_gap"}
            assert at["stream_max"] > 0 and at["step"] == drift.bf16_step(at["stream_max"])
            assert at["local_gap"] == at["local_steps"] == 0.0
            assert set(at["stream_gap"]) == {"kernel", "blocked128", "whole"}
            assert at["stream_gap"]["kernel"] == 0.0
        assert set(r["embedding"]) == {"max", "from_blocked", "from_fp32"}
        assert set(r["embedding"]["from_fp32"]) == set(drift.FORMS)
        assert 0 < r["embedding"]["from_fp32"]["blocked"] < 0.1 * r["embedding"]["max"]


@pytest.mark.parametrize("top,step", [(5.5, 2.0**-5), (6.6, 2.0**-5), (1.0, 2.0**-7), (0.99, 2.0**-8),
                                      (30.0, 2.0**-3), (0.0, 0.0)])
def test_bf16_step_of_a_magnitude(top, step):
    """2^(floor(log2 max|x|) - 7): the distance between neighbouring bf16 values
    there, checked against torch's own rounding."""
    from anomalyclip_tpu_torch.scripts import probe_bf16_drift as drift

    assert drift.bf16_step(top) == step
    if top:
        x = torch.tensor(top).bfloat16()
        above = torch.nextafter(x, torch.tensor(float("inf"), dtype=torch.bfloat16))
        assert (above.float() - x.float()).item() == step


def test_an_unknown_variant_or_group_ends_the_script():
    for name in ("foo", "qtile-xx3", "twopass-gb3", "whole-lq64"):
        with pytest.raises(SystemExit):
            tbench.make_variant(name)


def test_a_script_without_a_card_says_so(monkeypatch):
    from anomalyclip_tpu_torch.scripts import _bench_util

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match=r"bench_eval: no CUDA device \(--device cpu"):
        _bench_util.announce_device("bench_eval", "cuda", "something smaller")


@pytest.mark.parametrize("recorded,want", [([0, 0, 6000], 0.2), ([6000], 0.2), ([0, 0, 0], None)])
def test_device_ms_runs_a_silent_profiler_session_again(monkeypatch, recorded, want):
    """A profiler session that records no device time is run again, up to three
    in all, and then the device time is not measured (None, printed as such,
    and counted): what each session records is given in microseconds for 30
    calls."""
    import types

    import torch.profiler

    from anomalyclip_tpu_torch.scripts import _bench_util

    sessions, cuda = iter(recorded), torch.autograd.DeviceType.CUDA

    class Session:
        def __init__(self, activities):
            self.us = next(sessions)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return [types.SimpleNamespace(device_type=cuda,
                                          time_range=types.SimpleNamespace(elapsed_us=lambda: self.us))]

    monkeypatch.setattr(torch.profiler, "profile", Session)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(_bench_util, "device_readings", {"measured": 0, "not_measured": 0})
    calls = []
    got = _bench_util.device_ms(lambda: calls.append(1))
    assert _bench_util.device_readings == {"measured": int(want is not None), "not_measured": int(want is None)}
    if want is None:
        assert got is None and _bench_util.format_ms(got) == "not measured"
    else:
        assert got == pytest.approx(want) and _bench_util.format_ms(got) == f"{want:.4f} ms"
    assert len(calls) == 1 + 30 * len(recorded)


# ---------------------------------------------------------------------------
# the entry points run on the card unless asked for the CPU
# ---------------------------------------------------------------------------


def test_entry_points_default_to_the_card():
    from anomalyclip_tpu_torch import convert
    from anomalyclip_tpu_torch.eval.evaluator import GridScorer
    from anomalyclip_tpu_torch.predict import Predictor

    for fn in (Predictor.__init__, GridScorer.__init__, convert.params_from_jax,
               convert.bn_state_from_jax, convert.state_from_flat):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def test_grid_scorer_refuses_parameters_on_another_device():
    from anomalyclip_tpu_torch.eval.evaluator import GridScorer
    from anomalyclip_tpu_torch.scripts._bench_models import build_model

    model, frozen, trainable, bn_state = build_model("cpu", False, emb_size=32, depth=1, heads=2,
                                                     normal_id=3)
    with pytest.raises(ValueError, match=r"device is meta, but the frozen parameters are on cpu"):
        GridScorer(model, frozen, trainable, bn_state, np.zeros(64, np.float32), device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="device is cuda, but the frozen parameters are on cpu"):
            GridScorer(model, frozen, trainable, bn_state, np.zeros(64, np.float32))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


_GPU_DTYPES = [(torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)]


def _gpu_inputs(cuda, b, l, d, dtype, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(b, l, 3 * d, device=cuda, generator=gen).to(dtype)
    return x, x[..., :d], x[..., d:]


def _gpu_close(got, want, tol):
    torch.cuda.synchronize()
    top = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol * max(top, 1.0))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _GPU_DTYPES)
@pytest.mark.parametrize("rows,warps,residency", [(64, 4, "streamed"), (32, 4, "resident"), (128, 16, "streamed"),
                                                  (73, 8, "resident")])
@pytest.mark.parametrize("b,l,d,heads,causal", [(8, 197, 768, 12, False), (8, 77, 512, 8, True)])
def test_probe_qkv_kernel_matches_plain(cuda, dtype, tol, rows, warps, residency, b, l, d, heads, causal):
    x, _, _ = _gpu_inputs(cuda, b, l, d, dtype)
    probes.reset_launch_counts()
    got = probes.probe_mha_qkv(x, heads, causal, rows=rows, warps=warps, residency=residency)
    assert probes.launch_counts == _counts(probe_mha_qkv=1)
    _gpu_close(got, probes.tile_reference(*tattn._unpack_qkv(x), heads, causal), tol)
    assert probes.probe_blocks_per_sm(dtype, l, warps, residency) >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,d,heads,causal", [(8, 197, 768, 12, False), (8, 77, 512, 8, True), (3, 65, 1024, 16, False),
                                                (4, 400, 1024, 16, False)])
def test_tile_probe_at_the_shipped_block_is_the_shipped_kernel(cuda, dtype, b, l, d, heads, causal):
    """At 64 rows, 4 warps, K and V streamed, the tile probe gives the bits of
    ``fused_mha_qkv`` and ``fused_mha_qtile`` (mha_tc.cu in bf16, mha_tf32.cu in
    fp32)."""
    x, q, kv = _gpu_inputs(cuda, b, l, d, dtype, seed=3)
    tattn.reset_launch_counts()
    assert torch.equal(probes.probe_mha_qkv(x, heads, causal), tattn.fused_mha_qkv(x, heads, causal))
    if not causal:
        assert torch.equal(probes.probe_mha_qtile(q, kv, heads), tattn.fused_mha_qtile(q, kv, heads))
    route = "mha_tc" if dtype == torch.bfloat16 else "mha_tf32"
    assert tattn.route_counts[route] == 1 + (not causal)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,warps,residency", [(64, 4, "streamed"), (73, 4, "resident"), (145, 16, "streamed"),
                                                  (577, 8, "resident"), (1, 4, "streamed")])
def test_probe_qtile_and_nosoftmax_kernels_match_plain_at_the_l14_shape(cuda, rows, warps, residency):
    """bf16 at L=577, the tiling free; fp32 at L=577 streamed and at L=360
    resident, where K and V fit."""
    _, q, kv = _gpu_inputs(cuda, 4, 577, 1024, torch.bfloat16)
    probes.reset_launch_counts()
    knobs = {"rows": rows, "warps": warps, "residency": residency}
    _gpu_close(probes.probe_mha_qtile(q, kv, 16, **knobs), _qtile_plain(q, kv, 16), BF16_TOL)
    _gpu_close(probes.nosoftmax_mha(q, kv, 16, **knobs), probes.nosoftmax_reference(q, kv, 16), BF16_TOL)
    _, q, kv = _gpu_inputs(cuda, 4, 360 if residency == "resident" else 577, 1024, torch.float32)
    _gpu_close(probes.probe_mha_qtile(q, kv, 16, **knobs), _qtile_plain(q, kv, 16), FP32_TOL)
    _gpu_close(probes.nosoftmax_mha(q, kv, 16, **knobs), probes.nosoftmax_reference(q, kv, 16), FP32_TOL)
    assert probes.launch_counts == _counts(probe_mha_qtile=2, nosoftmax_mha=2)
    with pytest.raises(probes.ProbeDoesNotFit):
        probes.probe_mha_qtile(*_gpu_inputs(cuda, 1, 577, 1024, torch.float32)[1:], 16, residency="resident")


def _qtile_plain(q, kv, heads):
    d = q.shape[-1]
    return probes.tile_reference(q, kv[..., :d], kv[..., d:], heads)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _GPU_DTYPES)
@pytest.mark.parametrize("warps", [4, 8, 16])
def test_probe_whole_kernel_matches_plain(cuda, dtype, tol, warps):
    _, q, kv = _gpu_inputs(cuda, 4, 360, 1024, dtype)
    k, v = kv[..., :1024], kv[..., 1024:]
    probes.reset_launch_counts()
    for residency in probes.RESIDENCIES:
        for causal in (False, True):
            _gpu_close(probes.probe_mha_whole(q, k, v, 16, causal, warps=warps, residency=residency),
                       probes.tile_reference(q, k, v, 16, causal), tol)
    assert probes.launch_counts == _counts(probe_mha_whole=4)
    # at L=577 K and V resident fit in bf16 only
    _, q, kv = _gpu_inputs(cuda, 1, 577, 1024, dtype)
    k, v = kv[..., :1024], kv[..., 1024:]
    if dtype == torch.bfloat16:
        _gpu_close(probes.probe_mha_whole(q, k, v, 16, warps=warps), probes.tile_reference(q, k, v, 16), tol)
    else:
        with pytest.raises(probes.ProbeDoesNotFit, match="needs 358400 B .* given 232448 B"):
            probes.probe_mha_whole(q, k, v, 16, warps=warps)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _GPU_DTYPES)
@pytest.mark.parametrize("l,parts,rows,warps", [(577, 2, 64, 4), (577, 3, 32, 16), (130, 4, 128, 4), (64, 1, 64, 8)])
def test_twopass_kernel_matches_plain(cuda, dtype, tol, l, parts, rows, warps):
    _, q, kv = _gpu_inputs(cuda, 4, l, 1024, dtype, seed=1)
    probes.reset_launch_counts()
    got = probes.twopass_mha(q, kv, 16, parts=parts, rows=rows, warps=warps)
    assert probes.launch_counts == _counts(twopass_mha=1)
    _gpu_close(got, probes.parts_reference(q, kv, 16, parts), tol)
    part = probes.kv_part_length(l, parts)
    assert probes.parts_blocks_per_sm(dtype, rows, part, warps, 1) >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _GPU_DTYPES)
@pytest.mark.parametrize("l,rows,warps", [(577, 64, 8), (577, 120, 16), (197, 64, 4), (50, 16, 8)])
def test_pair_kernel_matches_plain(cuda, dtype, tol, l, rows, warps):
    _, q, kv = _gpu_inputs(cuda, 4, l, 1024, dtype, seed=2)
    probes.reset_launch_counts()
    got = probes.pair_mha(q, kv, 16, rows=rows, warps=warps)
    assert probes.launch_counts == _counts(pair_mha=1)
    _gpu_close(got, probes.parts_reference(q, kv, 16, probes.pair_parts(q, rows, warps)), tol)


@pytest.mark.gpu
def test_probes_under_the_reference_impl_launch_nothing_on_the_card(cuda):
    _, q, kv = _gpu_inputs(cuda, 2, 100, 128, torch.float32)
    probes.reset_launch_counts()
    with tattn.attention_impl("reference"):
        assert torch.equal(probes.twopass_mha(q, kv, 2), probes.parts_reference(q, kv, 2, 2))
        assert torch.equal(probes.probe_mha_qtile(q, kv, 2), _qtile_plain(q, kv, 2))
    assert probes.launch_counts == _counts()
