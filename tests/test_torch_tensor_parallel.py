"""The port's tensor-parallel CLIP towers (parallel/tp.py) over gloo ranks on
the CPU, against the JAX package's on conftest's 8 virtual CPU devices.

- The image tower at (dp, mp) = (1, 2), (2, 2), (1, 4) against the JAX
  ``tp_encode_images_aligned`` on ``dp_mp_mesh(dp, mp)`` and against the
  single-device ``encode_image``, at 1e-4: a four-head tower, each model group
  encoding its rows of the batch.
- The text tower (causal, four heads) against the JAX ``tp_encode_text``.
- ``mp = 3`` on four heads (runs of 2, 1 and 1 heads) against the single towers.
- Each rank holding only its shard: the sharded leaves' shapes, whole heads.
- The module's routing: ``trainer.model_parallel=2`` on 2 ranks encodes frames
  through the tensor-parallel tower, its visual tower on the host and only the
  shard uploaded, and scores a video from frames as one process does; on one
  rank the same option warns and encodes on the single tower.
- The model groups made again for a process group joined after another.
- ``serve`` on 2 ranks under ``trainer.model_parallel=2``: rank 0's stdin
  scored through the tensor-parallel tower within 1e-4 of one process, an
  input one rank cannot load skipped on both.
- ``graft_entry.dryrun_multichip(2)`` exits 0 and prints its line.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anomalyclip_tpu.models.clip import model as jclip
from anomalyclip_tpu.parallel import tp as jtp
from anomalyclip_tpu_torch import convert
from anomalyclip_tpu_torch.parallel.tp import qkv_columns, split_range

ROOT = Path(__file__).resolve().parents[1]
HELPERS = Path(__file__).resolve().parent / "helpers"
_spec = importlib.util.spec_from_file_location("_test_torch_tp_ranks", HELPERS / "torch_ranks.py")
ranks = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ranks)

TOL = 1e-4
GRIDS = [(1, 2), (2, 2), (1, 4), (1, 3)]

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-device virtual mesh (conftest)")


def _four_head_cfg():
    """Width 256 -> 4 vision heads; the text tower of CLIPConfig.tiny (4 heads, the
    full vocabulary, which the prompt learner tokenizes into)."""
    return jclip.CLIPConfig(embed_dim=64, image_resolution=32, vision_layers=2, vision_width=256,
                            vision_patch_size=16, context_length=77, vocab_size=49408, transformer_width=64,
                            transformer_heads=4, transformer_layers=2)


def _tokens(cfg, n=4):
    rng = np.random.default_rng(1)
    tokens = np.zeros((n, cfg.context_length), dtype=np.int32)
    for i, length in enumerate(rng.integers(3, cfg.context_length, size=n)):
        tokens[i, :length] = rng.integers(1, cfg.vocab_size - 1, size=length)
        tokens[i, length - 1] = cfg.vocab_size - 1  # EOT = argmax position
    return tokens


@pytest.fixture(scope="module")
def towers(tmp_path_factory):
    """The JAX four-head CLIP, its port copy on disk, the inputs."""
    work = tmp_path_factory.mktemp("tp")
    cfg = _four_head_cfg()
    params = jclip.init_clip_params(jax.random.PRNGKey(3), cfg)
    torch.save(convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu"),
               work / "clip.pt")
    (work / "cfg.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    images = np.random.default_rng(0).standard_normal((8, 32, 32, 3)).astype(np.float32)
    tokens = _tokens(cfg)
    np.save(work / "images.npy", images)
    np.save(work / "tokens.npy", tokens)
    single = (np.asarray(jclip.encode_image(params, cfg, jnp.asarray(images))),
              np.asarray(jclip.encode_text(params, cfg, jnp.asarray(tokens))))
    return work, cfg, params, images, tokens, single


_RANK = textwrap.dedent('''
    import json, sys
    from pathlib import Path
    import numpy as np
    import torch
    from anomalyclip_tpu_torch.models.clip.model import CLIPConfig
    from anomalyclip_tpu_torch.parallel import mesh
    from anomalyclip_tpu_torch.parallel.tp import (model_group, shard_tower, tp_encode_image, tp_encode_rows,
                                                   tp_encode_text)

    work, out, mp = Path(sys.argv[1]), Path(sys.argv[2]), int(sys.argv[3])
    assert mesh.init_distributed(backend="gloo")
    r = mesh.rank()
    cfg = CLIPConfig(**json.loads((work / "cfg.json").read_text()))
    clip = torch.load(work / "clip.pt")
    mg = model_group(mp)
    visual = shard_tower(clip, cfg, "visual", mp, mg.member, "cpu")
    text = shard_tower(clip, cfg, "text", mp, mg.member, "cpu")
    with torch.no_grad():
        image = tp_encode_rows(lambda x: tp_encode_image(visual, cfg, x, group=mg.group),
                               torch.from_numpy(np.load(work / "images.npy")), mg, cfg.embed_dim)
        tokens = tp_encode_rows(lambda x: tp_encode_text(text, cfg, x, group=mg.group),
                                torch.from_numpy(np.load(work / "tokens.npy")), mg, cfg.embed_dim)
    shapes = {f"{tower}/{k}": list(v.shape) for tower, shard in (("visual", visual), ("text", text))
              for k, v in {**shard[tower]["blocks"][0]["attn"], **shard[tower]["blocks"][0]["mlp"]}.items()}
    np.savez(out / f"rank{r}.npz", image=image.numpy(), text=tokens.numpy(), member=mg.member,
             group=mg.index, shapes=json.dumps(shapes))
''')


IDS = [f"dp{dp}-mp{mp}" for dp, mp in GRIDS]
ALIGNED = [g for g in GRIDS if 4 % g[1] == 0]  # the JAX aligned variant needs mp | heads


@pytest.fixture(scope="module")
def grids(towers, tmp_path_factory):
    """Every grid's ranks, each grid its own group, one grid after another:
    the 13 ranks of all four at once would share the CPU with the rest of a
    loaded test run, and each join would wait out the others' work too."""
    results = {}
    for dp, mp in GRIDS:
        out = tmp_path_factory.mktemp(f"grid_{dp}x{mp}")
        ranks.run(_RANK, dp * mp, out, args=[towers[0], out, mp])
        results[dp, mp] = [dict(np.load(out / f"rank{r}.npz")) for r in range(dp * mp)]
    return results


@pytest.fixture(scope="module", params=GRIDS, ids=IDS)
def grid(request, grids):
    dp, mp = request.param
    return dp, mp, grids[dp, mp]


def test_tp_image_tower_matches_the_single_tower(towers, grid):
    dp, mp, out = grid
    for o in out:
        np.testing.assert_allclose(o["image"], towers[5][0], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("grid", ALIGNED, ids=[f"dp{dp}-mp{mp}" for dp, mp in ALIGNED], indirect=True)
def test_tp_image_tower_matches_jax_aligned_tp(towers, grid):
    _, cfg, params, images, _, _ = towers
    dp, mp, out = grid
    mesh = jtp.dp_mp_mesh(dp, mp)
    want = np.asarray(jtp.tp_encode_images_aligned(cfg, mesh)(jtp.shard_clip_params_aligned(params, mesh),
                                                               jnp.asarray(images)))
    for o in out:
        np.testing.assert_allclose(o["image"], want, rtol=TOL, atol=TOL)


def test_tp_text_tower_matches_jax(towers, grid):
    _, cfg, params, _, tokens, single = towers
    dp, mp, out = grid
    for o in out:
        np.testing.assert_allclose(o["text"], single[1], rtol=TOL, atol=TOL)
    if cfg.transformer_heads % mp == 0:
        mesh = jtp.dp_mp_mesh(dp, mp)
        want = np.asarray(jtp.tp_encode_text(cfg, mesh)(jtp.shard_clip_params(params, mesh), jnp.asarray(tokens)))
        for o in out:
            np.testing.assert_allclose(o["text"], want, rtol=TOL, atol=TOL)


def test_each_rank_holds_only_its_shard(towers, grid):
    _, cfg, _, _, _, _ = towers
    dp, mp, out = grid
    assert sorted((int(o["group"]), int(o["member"])) for o in out) == [(g, m) for g in range(dp)
                                                                        for m in range(mp)]
    for o in out:
        shapes, m = json.loads(str(o["shapes"])), int(o["member"])
        for tower, width, heads in (("visual", cfg.vision_width, cfg.vision_heads),
                                    ("text", cfg.transformer_width, cfg.transformer_heads)):
            h0, h1 = split_range(heads, mp, m)
            local = (h1 - h0) * (width // heads)
            lo, hi = split_range(4 * width, mp, m)
            assert shapes[f"{tower}/qkv_w"] == [width, 3 * local]
            assert shapes[f"{tower}/out_w"] == [local, width]
            assert shapes[f"{tower}/fc_w"] == [width, hi - lo]
            assert shapes[f"{tower}/proj_w"] == [hi - lo, width]
            assert shapes[f"{tower}/out_b"] == shapes[f"{tower}/proj_b"] == [width]  # added once, after


@pytest.mark.parametrize("mp", [1, 2, 4])
def test_qkv_columns_are_the_jax_head_permutation(mp):
    width = 256
    perm = jtp._qkv_head_perm(width, mp)
    for m in range(mp):
        np.testing.assert_array_equal(qkv_columns(width, 4, mp, m), np.split(perm, mp)[m])


def test_qkv_columns_without_a_dividing_mp_take_whole_heads():
    cols = [qkv_columns(256, 4, 3, m) for m in range(3)]
    assert [len(c) for c in cols] == [3 * 128, 3 * 64, 3 * 64]
    assert sorted(np.concatenate(cols).tolist()) == list(range(3 * 256))
    with pytest.raises(ValueError, match="mp <= heads"):
        qkv_columns(256, 4, 5, 0)


# ---------------------------------------------------------------------------
# the module's routing
# ---------------------------------------------------------------------------

_MODULE = textwrap.dedent('''
    import json, sys
    from pathlib import Path
    import numpy as np
    import torch
    from anomalyclip_tpu_torch.config import compose, default_config_dir, to_dict
    from anomalyclip_tpu_torch.data.dataset import TestItem
    from anomalyclip_tpu_torch.eval.evaluator import GridScorer, score_video
    from anomalyclip_tpu_torch.models.clip.model import CLIPConfig
    from anomalyclip_tpu_torch.parallel import mesh
    from anomalyclip_tpu_torch.train.module import AnomalyCLIPTrainModule

    work, out = Path(sys.argv[1]), Path(sys.argv[2])
    mesh.init_distributed(backend="gloo")
    r = mesh.rank()
    cfg = to_dict(compose(default_config_dir(), "train", [
        "experiment=synthetic", "data.num_workers=0", "data.synthetic_num_normal=2",
        "data.synthetic_num_abnormal=2", "data.synthetic_num_test=1", "data.synthetic_min_frames=60",
        "data.synthetic_max_frames=70", "data.num_segments=4", "data.seg_length=4",
        "model.net.num_segments=4", "model.net.seg_length=4", "model.net.emb_size=32",
        "trainer.model_parallel=2"]))
    module = AnomalyCLIPTrainModule(cfg, device="cpu")
    clip_cfg = CLIPConfig(**json.loads((work / "cfg.json").read_text()))
    clip = torch.load(work / "clip.pt")
    trainable, bn = module.model.init_trainable(torch.Generator().manual_seed(0), {"clip": clip})
    state = module.adopt_converted_state({"clip": clip}, trainable, bn, clip_cfg)
    encode = module._encode_fn()
    frames = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (6, 32, 32, 3), dtype=np.uint8))
    with torch.no_grad():
        got = encode(module.frozen, frames)
        want = module.model.encode_frames(module.frozen, frames)
    module.ncentroid = np.zeros(clip_cfg.embed_dim, np.float32)
    n, l = module.net_cfg.num_segments, module.net_cfg.seg_length
    item = TestItem(np.random.default_rng(3).integers(0, 256, (1, n * l, 32, 32, 3), dtype=np.uint8),
                    np.full(n * l - 3, 3), 3, 1, "video")
    scored = score_video(item, module._scorer(state), module.model)
    alone = GridScorer(module.model, module.frozen, state.trainable, state.bn_state,
                       torch.zeros(clip_cfg.embed_dim), device="cpu")
    plain = score_video(item, alone, module.model)
    placed = module._tp_placed["visual"]["blocks"][0]["attn"]["qkv_w"]
    np.savez(out / f"rank{r}.npz", tp=np.array(getattr(encode, "tp", False)), got=got.numpy(), want=want.numpy(),
             scores=scored.scores, plain_scores=plain.scores, probs=scored.class_probs,
             plain_probs=plain.class_probs, placed=np.array(placed.shape),
             visual_on=str(module.frozen["clip"]["visual"]["patch_embed"].device))
''')


def test_module_encodes_through_the_tp_tower_on_two_ranks(towers, tmp_path):
    ranks.run(_MODULE, 2, tmp_path, args=[towers[0], tmp_path],
              env={"PROJECT_ROOT": str(ROOT), "SYNTHETIC_ROOT": str(tmp_path / "synthetic"),
                   "LOG_DIR": str(tmp_path / "logs"), "ANOMALYCLIP_NO_DOWNLOAD": "1"})
    cfg = towers[1]
    for r in range(2):
        o = np.load(tmp_path / f"rank{r}.npz")
        assert bool(o["tp"]) and str(o["visual_on"]) == "cpu"
        assert o["placed"].tolist() == [cfg.vision_width, 3 * cfg.vision_width // 2]
        np.testing.assert_allclose(o["got"], o["want"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(o["scores"], o["plain_scores"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(o["probs"], o["plain_probs"], rtol=TOL, atol=TOL)


def test_model_parallel_on_one_rank_warns_and_uses_the_single_tower(tmp_path, monkeypatch, caplog):
    from anomalyclip_tpu_torch.config import compose, default_config_dir, to_dict
    from anomalyclip_tpu_torch.train.module import AnomalyCLIPTrainModule

    for k, v in {"PROJECT_ROOT": str(ROOT), "SYNTHETIC_ROOT": str(tmp_path / "synthetic"),
                 "LOG_DIR": str(tmp_path / "logs"), "ANOMALYCLIP_NO_DOWNLOAD": "1"}.items():
        monkeypatch.setenv(k, v)
    cfg = to_dict(compose(default_config_dir(), "train", [
        "experiment=synthetic", "data.num_workers=0", "data.synthetic_num_test=1", "trainer.model_parallel=2"]))
    module = AnomalyCLIPTrainModule(cfg, device="cpu")
    warned = []
    monkeypatch.setattr("anomalyclip_tpu_torch.train.module.log.warning", warned.append)
    assert module._encode_fn() == module.model.encode_frames and module.model_group is None
    assert any("model_parallel=2 requested but only 1 device(s)" in w for w in warned), warned


_MODEL_GROUPS = textwrap.dedent('''
    import sys
    from pathlib import Path
    import torch
    import torch.distributed as dist
    from anomalyclip_tpu_torch.parallel import mesh
    from anomalyclip_tpu_torch.parallel.tp import model_group

    work = Path(sys.argv[1])
    made = []
    for run in range(2):  # two groups, one after the other, in one process
        assert mesh.init_distributed(backend="gloo", world_size=1, rank=0,
                                     init_method=f"file://{work / f'rendezvous{run}'}")
        mg = model_group(1)
        assert model_group(1) is mg
        t = torch.ones(2)
        dist.all_reduce(t, group=mg.group)  # a handle of the live group
        made.append(mg)
        dist.destroy_process_group()
    assert made[0] is not made[1] and made[0].group is not made[1].group
''')


def test_model_groups_are_made_again_for_a_new_process_group(tmp_path):
    ranks.run(_MODEL_GROUPS, 1, tmp_path, args=[tmp_path])


# ---------------------------------------------------------------------------
# serve in a group
# ---------------------------------------------------------------------------

_SERVE = textwrap.dedent('''
    import io, sys
    from pathlib import Path
    from anomalyclip_tpu_torch import serve
    from anomalyclip_tpu_torch.parallel import mesh

    feed, fail_on_one, *argv = sys.argv[1:]
    # rank 0's stdin is the stream; the other rank's is empty and never read
    sys.stdin = io.StringIO(feed if mesh.rank() == 0 else "")
    load = serve._load_input

    def load_or_fail(path, *args):
        if mesh.rank() == 1 and Path(path).name == fail_on_one:
            raise OSError("rank 1 cannot read it")
        return load(path, *args)

    serve._load_input = load_or_fail
    assert serve.main(argv) == 0
''')


@pytest.fixture(scope="module")
def two_head_serving(tmp_path_factory):
    """The serving set-up of tests/helpers/torch_serving.py with a two-head
    vision tower (width 128), so that ``trainer.model_parallel=2`` shards it."""
    spec = importlib.util.spec_from_file_location("_test_torch_tp_serving", HELPERS / "torch_serving.py")
    serving = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(serving)
    mp = pytest.MonkeyPatch()
    try:
        entry = serving.load_by_path("_torch_serving_entry", ROOT / "tests" / "test_torch_entry.py")
        clip_cfg = dataclasses.replace(entry.CKPT_CLIP, vision_width=128)
        s = serving.serving_setup(tmp_path_factory.mktemp("serve_tp"), mp, clip_cfg)
        s.common = s.common + [f"ncentroid_path={s.ncentroid}", "trainer=cpu"]
        yield s
    finally:
        mp.undo()


def test_serve_on_two_ranks_scores_rank_zeros_stream_through_the_tp_tower(two_head_serving, tmp_path,
                                                                            monkeypatch):
    import io

    from anomalyclip_tpu_torch import serve

    s = two_head_serving
    missing = tmp_path / "missing.npy"
    feed = "".join(f"{p}\n" for p in (s.frames, missing, s.video, s.npy))
    outs = ranks.run(_SERVE, 2, tmp_path / "ranks", args=[
        feed, s.video.name, *s.common, "trainer.model_parallel=2", f"output_dir={tmp_path / 'group'}",
        f"paths.log_dir={tmp_path / 'group_logs'}"])
    assert "TP encode: 1 model group(s) of 2 ranks" in outs[0], outs[0]

    monkeypatch.setattr("sys.stdin", io.StringIO(feed))
    assert serve.main(s.common + [f"output_dir={tmp_path / 'one'}", f"paths.log_dir={tmp_path / 'logs'}"]) == 0
    served = {d: {p.name: json.loads(p.read_text()) for p in (tmp_path / d).glob("*.json")}
              for d in ("group", "one")}
    # the missing input is skipped on both ranks, the video that rank 1 alone
    # cannot load on both, and the ranks agree on the other two
    assert sorted(served["group"]) == ["cam.json", "clip_frames.json"]
    assert sorted(served["one"]) == ["cam.json", "clip.json", "clip_frames.json"]
    for name, got in served["group"].items():
        want = served["one"][name]
        assert got["num_frames"] == want["num_frames"] and got["class_probs_shape"] == want["class_probs_shape"]
        np.testing.assert_allclose(got["frame_scores"], want["frame_scores"], rtol=0, atol=TOL)
        np.testing.assert_allclose(got["frame_top_class_prob"], want["frame_top_class_prob"], rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# the graft entry's dry run
# ---------------------------------------------------------------------------


def test_dryrun_multichip_two_ranks():
    proc = subprocess.run([sys.executable, "-m", "anomalyclip_tpu_torch.graft_entry", "2"], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2",
                                   ANOMALYCLIP_DIST_TIMEOUT_S=str(ranks.COLLECTIVE_TIMEOUT_S)),
                          capture_output=True, text=True, timeout=110)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "dryrun_multichip(2): ok, loss=" in proc.stdout, proc.stdout
