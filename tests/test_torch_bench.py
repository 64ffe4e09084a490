"""The port's ``bench`` (anomalyclip_tpu_torch/bench.py) against the JAX
package's root ``bench.py``, on the CPU.

- The per-arch batches, the chain's length and the repeat count equal the JAX
  script's, read from its source with ``ast`` (no JAX import for that); the
  metric names are the literal ones.
- At a tiny tower (``cpu_tower`` of ViT-B/16: its patch size and resolution,
  2 layers of width 64) with the JAX init carried over by ``convert``, one
  chain step equals JAX ``encode_image`` in bf16 within 5e-2, and the int8
  step JAX ``encode_image_int8`` on the same quantized weights within the
  bf16 limit of tests/test_torch_quant.py (5e-2).
- The chain's last output equals one plain encode of the same frames, to the
  bit, fp and int8; bf16 weights make ``transformer_apply``'s per-block cast a
  no-op (the same tensors come back).
- At full width the bf16 towers take the rungs the launch counts assume: K1
  ("mha") at 224 px, K6 ("qtile") at 336 px.
- ``main(["--device", "cpu", ...])`` prints one JSON line with the four keys
  and ``vs_baseline`` null, for every ``--arch`` and for ``--quant int8``;
  the default ``--device cuda`` without a card exits naming ``--device cpu``.
- ``--e2e`` on a small corpus (2 videos of 20 frames, the tiny tower) prints
  the JAX script's keys; with cv2 or PIL hidden it exits before timing
  anything, naming the module.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anomalyclip_tpu.models.clip import model as jclip
from anomalyclip_tpu.models.clip import quant as jquant
from anomalyclip_tpu_torch import bench, convert
from anomalyclip_tpu_torch.models.clip.model import attention_rung, cast_tree

ROOT = Path(__file__).resolve().parents[1]
BF16_TOL = 5e-2  # the repository's bf16 limit (attention.py:22-25, tests/test_torch_quant.py)
ARCH_METRICS = {
    "ViT-B/16": "vit_b16_encode_throughput",
    "ViT-B/32": "vit_b32_encode_throughput",
    "ViT-L/14": "vit_l14_encode_throughput",
    "ViT-L/14@336px": "vit_l14_336px_encode_throughput",
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The bench's CPU chains are many small bf16 operations: beside other busy
    test processes, torch's intra-op threads spinning on shared cores make them
    a hundred times slower, so these tests run torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_bench_constants() -> dict:
    """The batches dict, ``inner_iters`` and the repeat loop's count of the JAX
    ``bench.py``, from its syntax tree."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    found = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if name == "inner_iters":
                found["inner_iters"] = ast.literal_eval(node.value)
            elif name == "batch" and isinstance(node.value, ast.BoolOp):
                found["batches"] = ast.literal_eval(node.value.values[1].value)
        elif (isinstance(node, ast.For) and isinstance(node.iter, ast.Call)
              and getattr(node.iter.func, "id", None) == "range"
              and any(isinstance(n, ast.Call) and getattr(n.func, "id", None) == "float"
                      and "encode_chain" in ast.unparse(n) for n in ast.walk(node))):
            found["repeats"] = ast.literal_eval(node.iter.args[0])
    return found


def test_batches_chain_and_repeats_equal_the_jax_script():
    jax_bench = _jax_bench_constants()
    assert jax_bench == {"batches": bench.BATCHES, "inner_iters": bench.INNER_ITERS, "repeats": bench.REPEATS}
    assert list(bench.ARCHS) == list(bench.BATCHES) == list(ARCH_METRICS)


@pytest.mark.parametrize("arch", list(ARCH_METRICS))
def test_metric_names(arch):
    assert bench.metric_name(arch) == ARCH_METRICS[arch]


@pytest.fixture(scope="module")
def tiny():
    """The ViT-B/16 CPU tower in both packages, the port's weights carried
    from the JAX init, and the bench's frames at batch 2."""
    tcfg = bench.cpu_tower(bench.ARCHS["ViT-B/16"]())
    jcfg = jclip.CLIPConfig(**dataclasses.asdict(tcfg))
    jparams = jax.tree_util.tree_map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(0), jcfg))
    tparams = convert.params_from_jax(jparams, device="cpu")
    frames = bench.bench_frames(tcfg, bench.CPU_BATCH, "cpu")
    return tcfg, jcfg, jparams, tparams, frames


def _jax_frames(frames: torch.Tensor):
    return jnp.asarray(frames.float().numpy(), jnp.bfloat16)  # bf16 -> fp32 -> bf16: exact


def test_a_chain_step_equals_jax_encode_image_in_bf16(tiny):
    tcfg, jcfg, jparams, tparams, frames = tiny
    want = jclip.encode_image(jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), jparams), jcfg,
                              _jax_frames(frames), compute_dtype=jnp.bfloat16)
    encode = bench.encoder({"visual": cast_tree(tparams["visual"], torch.bfloat16)}, tcfg, "none")
    got = bench.chain(encode, frames, 1)
    assert got.dtype == torch.bfloat16 and got.shape == (bench.CPU_BATCH, tcfg.embed_dim)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_an_int8_chain_step_equals_jax_encode_image_int8(tiny):
    from anomalyclip_tpu_torch.models.clip.quant import quantize_clip_visual

    tcfg, jcfg, jparams, tparams, frames = tiny
    want = jquant.encode_image_int8(jquant.quantize_clip_visual(jparams), jcfg, _jax_frames(frames))
    got = bench.chain(bench.encoder(quantize_clip_visual(tparams), tcfg, "int8"), frames, 1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_the_chain_equals_a_plain_encode(quant):
    cfg = bench.cpu_tower(bench.ARCHS["ViT-B/16"]())
    weights = bench.bench_weights(cfg, quant, "cpu")
    frames = bench.bench_frames(cfg, bench.CPU_BATCH, "cpu")
    encode = bench.encoder(weights, cfg, quant)
    with torch.no_grad():
        want = encode(frames)
    assert torch.equal(bench.chain(encode, frames), want)
    assert torch.equal(bench.chain(encode, frames, 3)[0, 0], want[0, 0])


def test_bf16_weights_make_the_per_block_cast_a_no_op():
    cfg = bench.cpu_tower(bench.ARCHS["ViT-B/16"]())
    blocks = bench.bench_weights(cfg, "none", "cpu")["visual"]["blocks"]
    for blk in blocks:
        cast = cast_tree(blk, torch.bfloat16)
        for part in ("attn", "mlp", "ln_1", "ln_2"):
            for key, leaf in blk[part].items():
                assert leaf.dtype == torch.bfloat16 and cast[part][key] is leaf, (part, key)


@pytest.mark.parametrize("arch, rung", [("ViT-B/16", "mha"), ("ViT-B/32", "mha"), ("ViT-L/14", "mha"),
                                        ("ViT-L/14@336px", "qtile")])
def test_full_width_bf16_towers_take_the_counted_rungs(arch, rung):
    cfg = bench.ARCHS[arch]()
    tokens = cfg.grid_size ** 2 + 1
    assert tokens == {"ViT-B/16": 197, "ViT-B/32": 50, "ViT-L/14": 257, "ViT-L/14@336px": 577}[arch]
    assert attention_rung(bench.BATCHES[arch], tokens, cfg.vision_width, cfg.vision_heads, 2, False) == rung
    small = bench.cpu_tower(cfg)  # the CPU tower keeps the sequence
    assert small.grid_size == cfg.grid_size and small.vision_layers == 2 and small.vision_width == 64


def _json_line(out: str) -> dict:
    lines = out.strip().splitlines()
    assert lines[0].startswith("# device: cpu (") and "no time is a measurement" in lines[0]
    return json.loads(lines[-1])


@pytest.mark.parametrize("argv", [["--arch", a] for a in ARCH_METRICS] + [["--quant", "int8"]],
                         ids=[*ARCH_METRICS, "int8"])
def test_main_on_the_cpu_prints_the_json_line(argv, capsys):
    returned = bench.main(["--device", "cpu", *argv])
    out, err = capsys.readouterr()
    line = _json_line(out)
    arch = argv[1] if argv[0] == "--arch" else "ViT-B/16"
    assert line == returned and sorted(line) == ["metric", "unit", "value", "vs_baseline"]
    assert line["metric"] == ARCH_METRICS[arch] and line["unit"] == "frames/sec/chip"
    assert line["vs_baseline"] is None and line["value"] > 0
    assert "frames/s (batch=2, " in err and "ms/iter)" in err


def test_the_default_device_without_a_card_exits_naming_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        bench.main([])


@pytest.fixture
def small_e2e(monkeypatch, tmp_path):
    monkeypatch.setattr(bench, "e2e_ingest", functools.partial(
        bench.e2e_ingest, root=tmp_path / "e2e", n_videos=2, min_frames=20, max_frames=20, dispatch_frames=4))


def test_e2e_on_a_small_corpus_prints_the_jax_keys(small_e2e, capsys):
    line = bench.main(["--device", "cpu", "--e2e"])
    out, err = capsys.readouterr()
    assert _json_line(out) == line
    assert sorted(line) == sorted(["metric", "value", "unit", "vs_baseline", "host_decode_fps", "decode_workers",
                                   "host_decode_scaling", "dispatch_fps_uint8", "dispatch_fps_float32"])
    assert line["metric"] == "vit_b16_e2e_ingest_throughput" and line["vs_baseline"] is None
    assert line["unit"] == "frames/sec (decode+preprocess+transfer+encode)"
    assert min(line["value"], line["host_decode_fps"], line["dispatch_fps_uint8"], line["dispatch_fps_float32"]) > 0
    assert "1" in line["host_decode_scaling"] and all(v > 0 for v in line["host_decode_scaling"].values())
    assert "# e2e ingest: " in err and "over 40 frames" in err


@pytest.mark.parametrize("hidden", ["cv2", "PIL"])
def test_e2e_without_a_decoder_exits_naming_it(hidden, small_e2e, monkeypatch, capsys):
    monkeypatch.setitem(__import__("sys").modules, hidden, None)
    called = []
    monkeypatch.setattr(bench, "e2e_ingest", lambda *a, **k: called.append(1))
    with pytest.raises(SystemExit) as exc:
        bench.main(["--device", "cpu", "--e2e"])
    assert isinstance(exc.value.code, str) and hidden in exc.value.code and "cannot be imported" in exc.value.code
    assert not called and "{" not in capsys.readouterr().out
