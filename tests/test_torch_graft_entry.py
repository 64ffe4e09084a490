"""The port's counterpart of ``__graft_entry__`` (anomalyclip_tpu_torch/graft_entry.py),
on the CPU: the function ``entry()`` returns, built at ``_build_tiny``'s sizes
on the JAX package's tiny weights converted, against the JAX
``model.forward_test`` at the tolerance of tests/test_golden.py, from features
and from frames; the flagship's configuration; ``dryrun_multichip`` raising when
a rank's check fails."""

from __future__ import annotations

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from anomalyclip_tpu.models import anomaly_clip as jac
from anomalyclip_tpu_torch import convert, graft_entry
from anomalyclip_tpu_torch.models.anomaly_clip import AnomalyCLIP
from anomalyclip_tpu_torch.models.clip.model import CLIPConfig

RTOL, ATOL = 1e-4, 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("from_frames", [False, True])
def test_entry_function_matches_jax_forward_test(from_frames):
    jmodel, jfrozen, jtrainable, jbn = ge._build_tiny()
    jmodel = jac.AnomalyCLIP.build(dataclasses.replace(jmodel.cfg, load_from_features=not from_frames),
                                   jfrozen["clip"], jmodel.clip_cfg)[0]
    model, _, _, _ = graft_entry._build_tiny()
    assert dataclasses.asdict(model.cfg).keys() <= dataclasses.asdict(jmodel.cfg).keys()
    for name, value in dataclasses.asdict(model.cfg).items():
        if name != "labels_file":
            assert value == getattr(jmodel.cfg, name) or name == "load_from_features", name
    clip_cfg = CLIPConfig(**{f: getattr(jmodel.clip_cfg, f) for f in jmodel.clip_cfg.__dataclass_fields__})
    frozen = convert.params_from_jax(_np_tree(jfrozen), device="cpu")
    model, frozen = AnomalyCLIP.build(dataclasses.replace(model.cfg, load_from_features=not from_frames),
                                      frozen["clip"], clip_cfg)
    trainable = convert.params_from_jax(_np_tree(jtrainable), device="cpu")
    bn = convert.bn_state_from_jax(jbn, device="cpu")
    fn = graft_entry.scoring_forward(model, bn)

    rng = np.random.default_rng(0)
    t = model.cfg.num_segments * model.cfg.seg_length
    side = clip_cfg.image_resolution
    shape = (1, t, side, side, 3) if from_frames else (1, t, clip_cfg.embed_dim)
    x = rng.standard_normal(shape).astype(np.float32)
    ncentroid = rng.standard_normal(clip_cfg.embed_dim).astype(np.float32)
    sim, scores = fn(frozen, trainable, torch.from_numpy(x), torch.from_numpy(ncentroid))
    jsim, jscores = jmodel.forward_test(jfrozen, jtrainable, jbn, jnp.asarray(x), jnp.asarray(ncentroid),
                                        segment_size=1)
    assert sim.shape == jsim.shape and scores.shape == jscores.shape == (t,)
    np.testing.assert_allclose(sim.numpy(), np.asarray(jsim), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=RTOL, atol=ATOL)


def test_entry_is_the_flagship_on_the_card():
    """``entry`` builds the JAX entry's model (ViT-B/16, 32 x 16 frames, bf16,
    emb 256, depth 1, 8 heads, normal id 3 of 6), on the card unless given
    the CPU."""
    import tempfile
    from pathlib import Path

    assert inspect.signature(graft_entry.entry).parameters["device"].default == "cuda"
    cfg, clip_cfg = graft_entry.flagship_config()
    labels = Path(tempfile.mkdtemp()) / "labels.csv"
    labels.write_text("id,name\n0,Abuse\n1,Arson\n2,Fighting\n3,Normal\n4,Robbery\n5,Shooting\n")
    want = jac.AnomalyCLIPConfig(labels_file=str(labels), emb_size=256, depth=1, heads=8, num_segments=32,
                                 seg_length=16, concat_features=False, normal_id=3, load_from_features=False,
                                 compute_dtype="bfloat16")
    for name, value in dataclasses.asdict(cfg).items():
        if name != "labels_file":
            assert value == getattr(want, name), name
    assert jac.read_classnames(cfg.labels_file) == jac.read_classnames(want.labels_file)
    assert dataclasses.asdict(clip_cfg) == dataclasses.asdict(CLIPConfig.vit_b16())


def test_dryrun_multichip_raises_naming_item_8():
    """``dryrun_multichip`` raised, naming ROADMAP.md section 1, item 8, until
    that item landed; it now runs over spawned ranks
    (tests/test_torch_tensor_parallel.py runs it on two), and raises when a
    rank's check fails: here two ranks told they are three."""
    import torch.multiprocessing as mp

    from anomalyclip_tpu_torch.train_entry import run_ranks

    with pytest.raises(mp.ProcessRaisedException, match="AssertionError"):
        run_ranks("anomalyclip_tpu_torch.graft_entry:_dryrun_rank", ["3", "cpu"], 2, "cpu")


@pytest.mark.parametrize("cards, device, n, route", [
    (0, None, 2, ("cpu", "gloo")),
    (1, None, 2, ("cuda", "gloo")),
    (2, None, 2, ("cuda", "nccl")),
    (4, "cuda", 2, ("cuda", "nccl")),
    (1, "cpu", 2, ("cpu", "gloo")),
])
def test_dryrun_route_takes_the_card_unless_asked_for_the_cpu(monkeypatch, cards, device, n, route):
    """``dryrun_multichip``'s ranks: on the card whenever there is one (shared
    over gloo when there are fewer cards than ranks), the CPU when asked for it
    or when there is no card."""
    import torch

    from anomalyclip_tpu_torch.graft_entry import dryrun_route

    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert dryrun_route(n, device) == route


def test_dryrun_route_on_the_card_raises_without_one(monkeypatch):
    import torch

    from anomalyclip_tpu_torch.graft_entry import dryrun_route

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_route(2, "cuda")
