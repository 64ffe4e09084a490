"""The port's training slice against the JAX package, on the CPU.

Same numpy inputs, same converted weights, both packages:

- ``select_topk`` with the same mask (one that keeps a single segment, so the
  ties at -+1e6 decide), indices exact; ``selector_train`` at dropout 0: logits
  1e-4, indices exact, BN state 1e-6; ``generate_masks``' alias and keep rate;
- ``compute_loss`` on the golden forward's outputs: terms at rtol 2e-4 / atol
  1e-5 (tests/test_golden.py:219-222), and its gradients;
- ``forward_train`` on ``tests/golden/tiny_state.npz`` against the frozen
  ``train/*`` of ``tiny_pipeline.npz`` at rtol 1e-4 / atol 2e-5, indices exact,
  BN 1e-6; the from-frames branch against JAX at the same tolerance;
- every trainable leaf's gradient of the total loss against ``jax.grad``, at
  rtol 1e-4 / atol 1e-4 * max|leaf grad|;
- the optimizer against optax's ``build_optimizer`` at 1e-6, and the schedule;
- three steps of ``fit_steps`` against the frozen ``steps/*`` (losses rtol 5e-4
  / atol 1e-5, weights with test_golden.py's two-tier check, BN 1e-5 / 1e-6);
- ``compute_ncentroid`` over the synthetic corpus against the frozen
  ``ncentroid`` at 1e-5.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from anomalyclip_tpu.data.datamodule import AnomalyCLIPDataModule, DataConfig
from anomalyclip_tpu.data.synthetic import generate_synthetic_dataset
from anomalyclip_tpu.models import anomaly_clip as jac
from anomalyclip_tpu.models import losses as jloss
from anomalyclip_tpu.models import selector as jsel
from anomalyclip_tpu.models.clip import model as jclip
from anomalyclip_tpu.train import optim as joptim
from anomalyclip_tpu.utils.treeio import flatten_tree, unflatten_tree
from anomalyclip_tpu_torch import convert
from anomalyclip_tpu_torch.models import anomaly_clip as tac
from anomalyclip_tpu_torch.models import losses as tloss
from anomalyclip_tpu_torch.models import selector as tsel
from anomalyclip_tpu_torch.train import module as tmod
from anomalyclip_tpu_torch.train import optim as toptim
from tests.helpers.golden_inputs import train_forward_inputs, trajectory_batches
from tests.helpers.synthetic_run import synthetic_cfg

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
RTOL, ATOL = 1e-4, 2e-5  # fp32 features (tests/test_golden.py:204-208)
# the golden fixture's settings (tests/test_golden.py:142-147)
OVERRIDES = (
    "model.net.select_idx_dropout_topk=0.0",
    "model.net.select_idx_dropout_bottomk=0.0",
    "model.net.emb_size=32",
    "data.num_workers=0",
)


def _load(name: str) -> dict:
    with np.load(GOLDEN / name, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def _fields(cls, mapping) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in dict(mapping).items() if k in names}


def _jax_layout(tree, key: str = ""):
    """A port tree -> numpy in the JAX package's layout (conv kernels HWIO)."""
    if isinstance(tree, dict):
        return {k: _jax_layout(v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax_layout(v) for v in tree]
    a = tree.detach().cpu().numpy()
    return a.transpose(2, 3, 1, 0) if key in ("conv1_w", "conv2_w") else a


def _sub(flat: dict, prefix: str):
    return unflatten_tree({k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)})


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The golden tiny state in both packages, with the golden fixture's config."""
    cfg = synthetic_cfg(tmp_path_factory.mktemp("torch_train"), *OVERRIDES)
    flat = _load("tiny_state.npz")
    frozen, trainable, bn, clip_cfg = convert.state_from_flat(flat)
    net = _fields(tac.AnomalyCLIPConfig, cfg.model.net)
    model, frozen = tac.AnomalyCLIP.build(tac.AnomalyCLIPConfig(**net), frozen["clip"], clip_cfg)

    jfrozen = _sub(flat, "frozen/")
    jclip_cfg = jclip.CLIPConfig(**dataclasses.asdict(clip_cfg))
    jnet = _fields(jac.AnomalyCLIPConfig, cfg.model.net)
    jmodel, _ = jac.AnomalyCLIP.build(jac.AnomalyCLIPConfig(**jnet), jfrozen["clip"], jclip_cfg)
    return SimpleNamespace(
        cfg=cfg, model=model, frozen=frozen, trainable=trainable, bn=bn,
        loss_cfg=tloss.LossConfig(**_fields(tloss.LossConfig, cfg.model.loss)),
        jmodel=jmodel, jfrozen=jfrozen, jtrainable=_sub(flat, "trainable/"),
        jbn=jsel.BNState(jnp.asarray(flat["bn/mean"]), jnp.asarray(flat["bn/var"])),
        jloss_cfg=jloss.LossConfig(**_fields(jloss.LossConfig, cfg.model.loss)),
        golden=_load("tiny_pipeline.npz"),
    )


def _forward_inputs(tiny):
    cfg = tiny.cfg
    return train_forward_inputs(
        int(cfg.data.num_classes), int(cfg.data.normal_id),
        int(cfg.model.net.num_segments), int(cfg.model.net.seg_length),
        tiny.model.clip_cfg.embed_dim,
    )


# ---------------------------------------------------------------------------
# selector
# ---------------------------------------------------------------------------

SEL_CFG = dict(normal_id=2, num_segments=8, seg_length=4)
TOL_SEL = 1e-4


@pytest.mark.parametrize("largest", [True, False])
def test_select_topk_matches_jax(largest):
    rng = np.random.default_rng(3)
    b, c = 8, 5
    logits = rng.standard_normal((b, 8 * 4, c)).astype(np.float32)
    labels = np.array([0, 1, 3, 4, 2, 2, 2, 2])
    mask = rng.random((b, 8)) < 0.6
    mask[0] = False
    mask[0, 5] = True  # one survivor: the other picks are ties at -+1e6
    mask[6] = False
    mask[6, 2] = True
    mask[3] = False  # no survivor at all
    jcfg, tcfg = jsel.SelectorConfig(**SEL_CFG), tsel.SelectorConfig(**SEL_CFG)
    want = jsel.select_topk(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask), jcfg, largest)
    got = tsel.select_topk(
        torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(mask), tcfg, largest
    )
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_selector_train_matches_jax_at_dropout_0():
    rng = np.random.default_rng(4)
    b, d = 8, 16
    image = rng.standard_normal((b * 32, d)).astype(np.float32)
    text = rng.standard_normal((6, d)).astype(np.float32)
    ncentroid = 0.1 * rng.standard_normal(d).astype(np.float32)
    labels = np.array([0, 1, 3, 5, 2, 2, 2, 2])
    mean = 0.1 * rng.standard_normal(5).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    kw = dict(SEL_CFG, select_idx_dropout_topk=0.0, select_idx_dropout_bottomk=0.0)
    want, want_bn = jsel.selector_train(
        jnp.asarray(image), jnp.asarray(text), jnp.asarray(labels), jnp.asarray(ncentroid),
        jsel.BNState(jnp.asarray(mean), jnp.asarray(var)), jax.random.PRNGKey(0),
        jsel.SelectorConfig(**kw),
    )
    got, got_bn = tsel.selector_train(
        torch.from_numpy(image), torch.from_numpy(text), torch.from_numpy(labels),
        torch.from_numpy(ncentroid), tsel.BNState(torch.from_numpy(mean), torch.from_numpy(var)),
        torch.Generator().manual_seed(0), tsel.SelectorConfig(**kw),
    )
    for name in ("logits", "logits_topk", "logits_bottomk"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=TOL_SEL, atol=TOL_SEL,
            err_msg=name,
        )
    for name in ("idx_topk_abn", "idx_topk_nor", "idx_bottomk_abn"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    np.testing.assert_allclose(got_bn.mean.numpy(), np.asarray(want_bn.mean), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_bn.var.numpy(), np.asarray(want_bn.var), rtol=0, atol=1e-6)


def test_generate_masks_alias_and_keep_rate():
    cfg = tsel.SelectorConfig(normal_id=7)  # both rates 0.7
    top, bottom = tsel.generate_masks(torch.Generator().manual_seed(0), 4, cfg)
    assert top is bottom and top.shape == (4, 32) and top.dtype == torch.bool

    n = 4096
    cfg = tsel.SelectorConfig(normal_id=7, select_idx_dropout_topk=0.3, select_idx_dropout_bottomk=0.8)
    top, bottom = tsel.generate_masks(torch.Generator().manual_seed(1), n, cfg)
    for mask, keep in ((top, 0.7), (bottom, 0.2)):
        stderr = (keep * (1 - keep) / mask.numel()) ** 0.5
        assert abs(mask.float().mean().item() - keep) < 5 * stderr
    assert not torch.equal(top, bottom)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def test_compute_loss_matches_jax(tiny):
    g = tiny.golden
    _, labels = _forward_inputs(tiny)
    args = [g["train/logits"], g["train/logits_topk"], labels, g["train/scores"],
            g["train/idx_topk_abn"], g["train/idx_topk_nor"], g["train/idx_bottomk_abn"]]

    jlabels, jidx = jnp.asarray(labels), [jnp.asarray(a) for a in args[4:]]

    def jax_total(sim, sim_topk, scores):
        return jloss.compute_loss(sim, sim_topk, jlabels, scores, *jidx, tiny.jloss_cfg).total

    want = jloss.compute_loss(*map(jnp.asarray, args), tiny.jloss_cfg)
    want_grads = jax.grad(jax_total, argnums=(0, 1, 2))(
        jnp.asarray(args[0]), jnp.asarray(args[1]), jnp.asarray(args[3])
    )

    leaves = [torch.tensor(args[i], requires_grad=True) for i in (0, 1, 3)]
    got = tloss.compute_loss(
        leaves[0], leaves[1], torch.from_numpy(labels), leaves[2],
        *(torch.from_numpy(a).long() for a in args[4:]), tiny.loss_cfg,
    )
    np.testing.assert_allclose(
        [float(t.detach()) for t in got], [float(t) for t in want], rtol=2e-4, atol=1e-5
    )
    grads = torch.autograd.grad(got.total, leaves)
    for ours, theirs in zip(grads, want_grads):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-4, atol=1e-4 * np.abs(theirs).max())


# ---------------------------------------------------------------------------
# forward and gradients
# ---------------------------------------------------------------------------


def test_forward_train_matches_golden(tiny):
    g = tiny.golden
    feats, labels = _forward_inputs(tiny)
    out, bn = tiny.model.forward_train(
        tiny.frozen, tiny.trainable, tiny.bn, torch.from_numpy(feats[:, 0]),
        torch.from_numpy(labels), torch.from_numpy(g["ncentroid"]), torch.Generator(),
    )
    for name in ("logits", "logits_topk", "scores"):
        np.testing.assert_allclose(
            getattr(out, name).detach().numpy(), g[f"train/{name}"], rtol=RTOL, atol=ATOL,
            err_msg=name,
        )
    for name in ("idx_topk_abn", "idx_topk_nor", "idx_bottomk_abn"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), g[f"train/{name}"], err_msg=name)
    np.testing.assert_allclose(bn.mean.numpy(), g["train/bn_mean"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), g["train/bn_var"], rtol=0, atol=1e-6)
    terms = tloss.compute_loss(
        out.logits, out.logits_topk, torch.from_numpy(labels), out.scores,
        out.idx_topk_abn, out.idx_topk_nor, out.idx_bottomk_abn, tiny.loss_cfg,
    )
    np.testing.assert_allclose(
        [float(t.detach()) for t in terms], g["train/loss_terms"], rtol=2e-4, atol=1e-5
    )


def test_gradients_match_jax(tiny):
    """d(total loss)/d(every trainable leaf), port autograd (through the
    attention Functions' explicit backwards) against jax.grad."""
    feats, labels = _forward_inputs(tiny)
    ncentroid = tiny.golden["ncentroid"]

    def jax_loss(trainable):
        out, _ = tiny.jmodel.forward_train(
            tiny.jfrozen, trainable, tiny.jbn, jnp.asarray(feats[:, 0]), jnp.asarray(labels),
            jnp.asarray(ncentroid), jax.random.PRNGKey(0),
        )
        return jloss.compute_loss(
            out.logits, out.logits_topk, jnp.asarray(labels), out.scores,
            out.idx_topk_abn, out.idx_topk_nor, out.idx_bottomk_abn, tiny.jloss_cfg,
        ).total

    jtrainable = jax.tree_util.tree_map(jnp.asarray, tiny.jtrainable)
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, jax.grad(jax_loss)(jtrainable)))

    trainable = convert.as_trainable(tiny.trainable)
    out, _ = tiny.model.forward_train(
        tiny.frozen, trainable, tiny.bn, torch.from_numpy(feats[:, 0]), torch.from_numpy(labels),
        torch.from_numpy(ncentroid), torch.Generator(),
    )
    tloss.compute_loss(
        out.logits, out.logits_topk, torch.from_numpy(labels), out.scores,
        out.idx_topk_abn, out.idx_topk_nor, out.idx_bottomk_abn, tiny.loss_cfg,
    ).total.backward()
    got = flatten_tree(_jax_layout(convert.tree_map(lambda t: t.grad, trainable)))
    assert got.keys() == want.keys()
    for key, theirs in want.items():
        np.testing.assert_allclose(
            got[key], theirs, rtol=1e-4, atol=1e-4 * np.abs(theirs).max(), err_msg=key
        )
    assert all(not t.requires_grad for t in convert.tree_leaves(tiny.frozen))


def test_forward_train_from_frames_matches_jax(tmp_path):
    """The from-frames branch: frames encoded by the frozen tower, then the
    same training forward."""
    labels_file = tmp_path / "labels.csv"
    labels_file.write_text("id,name\n0,Abuse\n1,Arson\n2,Normal\n3,Robbery\n")
    net = dict(labels_file=str(labels_file), emb_size=64, heads=2, num_segments=4, seg_length=2,
               normal_id=2, load_from_features=False, select_idx_dropout_topk=0.0,
               select_idx_dropout_bottomk=0.0, num_topk=2, num_bottomk=2)
    clip_cfg = jclip.CLIPConfig.tiny()
    jmodel, jfrozen = jac.AnomalyCLIP.build(
        jac.AnomalyCLIPConfig(**net), jclip.init_clip_params(jax.random.PRNGKey(0), clip_cfg), clip_cfg
    )
    jtrainable, jbn = jmodel.init_trainable(jax.random.PRNGKey(1), jfrozen)
    rng = np.random.default_rng(6)
    frames = rng.standard_normal((4, 8, 32, 32, 3)).astype(np.float32)
    labels = np.array([0, 3, 2, 2])
    ncentroid = (0.1 * rng.standard_normal(clip_cfg.embed_dim)).astype(np.float32)
    want, want_bn = jmodel.forward_train(
        jfrozen, jtrainable, jbn, jnp.asarray(frames), jnp.asarray(labels), jnp.asarray(ncentroid),
        jax.random.PRNGKey(0),
    )

    def np_tree(t):
        return jax.tree_util.tree_map(np.asarray, t)

    frozen = convert.params_from_jax(np_tree(jfrozen))
    tclip_cfg = tac.CLIPConfig(**dataclasses.asdict(clip_cfg))
    model, frozen = tac.AnomalyCLIP.build(tac.AnomalyCLIPConfig(**net), frozen["clip"], tclip_cfg)
    got, got_bn = model.forward_train(
        frozen, convert.as_trainable(convert.params_from_jax(np_tree(jtrainable))),
        tsel.BNState.create(3), torch.from_numpy(frames),
        torch.from_numpy(labels), torch.from_numpy(ncentroid), torch.Generator(),
    )
    for name in ("logits", "logits_topk", "scores"):
        np.testing.assert_allclose(
            getattr(got, name).detach().numpy(), np.asarray(getattr(want, name)),
            rtol=RTOL, atol=ATOL, err_msg=name,
        )
    for name in ("idx_topk_abn", "idx_topk_nor", "idx_bottomk_abn"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    np.testing.assert_allclose(got_bn.var.numpy(), np.asarray(want_bn.var), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

SOLVER = {"lr": 1e-2, "prompt_learner_ratio": 1.0, "text_projection_ratio": 0.5,
          "selector_model_ratio": 3.0, "temporal_model_ratio": 2.0}


def test_schedule_matches_jax():
    sched = {"warmup_epochs": 3, "total_epoch": 9, "final_factor": 0.1, "warmup_powers": 2.0,
             "warmup_lrs": 1e-4}
    ours = toptim.base_lr_schedule(SOLVER, sched, steps_per_epoch=4)
    theirs = joptim.base_lr_schedule(SOLVER, sched, steps_per_epoch=4)
    steps = range(0, 48)
    np.testing.assert_allclose([ours(s) for s in steps], [float(theirs(s)) for s in steps],
                               rtol=1e-6, atol=0)
    assert ours(0) == pytest.approx(1e-4) and ours(4 * 9 + 7) == pytest.approx(1e-3)


def test_optimizer_matches_optax():
    """4 groups at distinct ratios (the selector's owns no parameters), warmup
    over epoch 0 of 2 steps, 6 updates: epoch 0 leaves the parameters as they
    are; every update matches optax at 1e-6."""
    rng = np.random.default_rng(7)
    params = {
        "prompt_ctx": rng.standard_normal((3, 4)).astype(np.float32),
        "text_projection": rng.standard_normal((4, 4)).astype(np.float32),
        "temporal": {"w": rng.standard_normal((5,)).astype(np.float32),
                     "layers": [{"b": rng.standard_normal((2, 3)).astype(np.float32)}]},
    }
    sched = {"warmup_epochs": 1, "total_epoch": 4}
    opt_cfg = {"weight_decay": 0.2}
    tx = joptim.build_optimizer(SOLVER, opt_cfg, sched, steps_per_epoch=2)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jparams)
    tparams = convert.as_trainable(convert.tree_map(torch.from_numpy, params))
    opt = toptim.build_optimizer(tparams, SOLVER, opt_cfg, sched, steps_per_epoch=2)
    for k in range(6):
        grads = convert.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        updates, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tgrads = convert.tree_leaves(convert.tree_map(torch.from_numpy, grads))
        for leaf, g in zip(convert.tree_leaves(tparams), tgrads):
            leaf.grad = g
        opt.step()
        got, want = flatten_tree(_jax_layout(tparams)), flatten_tree(
            jax.tree_util.tree_map(np.asarray, jparams)
        )
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-6, err_msg=f"{k} {key}")
            if k < 2:  # epoch 0 trains at lr 0
                np.testing.assert_array_equal(got[key], flatten_tree(params)[key])
    assert opt.count == 6


# ---------------------------------------------------------------------------
# the step, the loop, the centroid
# ---------------------------------------------------------------------------


def test_three_step_trajectory_matches_golden(tiny):
    """Three steps of fit_steps (forward, loss, backward, AdamW over the groups)
    reproduce the frozen per-step losses, end weights and BN state
    (tests/test_golden.py:252-318)."""
    cfg, g = tiny.cfg, tiny.golden
    solver = dict(cfg.model.solver)
    solver["lr"] = base_lr = 1e-3
    sched = dict(cfg.model.get("scheduler", {}))
    sched["warmup_epochs"] = 0
    state = tmod.init_state(
        tiny.trainable, tiny.bn, solver, dict(cfg.model.get("optimizer", {})), sched,
        steps_per_epoch=1000,
    )
    batches = [
        tmod.TrainBatch(feats[:4], labels[:4], feats[4:], labels[4:])
        for feats, labels in trajectory_batches(
            int(cfg.data.num_classes), int(cfg.data.normal_id),
            int(cfg.model.net.num_segments), int(cfg.model.net.seg_length),
            tiny.model.clip_cfg.embed_dim,
        )
    ]
    losses = []
    state, history = tmod.fit_steps(
        tmod.build_train_step(tiny.model, tiny.loss_cfg), tiny.frozen, state, batches,
        torch.from_numpy(g["ncentroid"]), torch.Generator(), epochs=1, steps_per_epoch=1000,
        on_step=lambda s, terms: losses.append(float(terms.total)),
    )
    assert state.step == 3 and len(history) == 1
    np.testing.assert_allclose(losses, g["steps/losses"], rtol=5e-4, atol=1e-5)
    assert history[0]["train/loss"] == pytest.approx(np.mean(losses), rel=1e-6)

    got = flatten_tree(_jax_layout(state.trainable), "steps/after3")
    for key, want in ((k, v) for k, v in g.items() if k.startswith("steps/after3/")):
        diff = np.abs(got[key] - want)
        np.testing.assert_array_less(diff.max(), 2 * base_lr * 3, err_msg=key)
        tight = diff <= 5e-5 + 1e-3 * np.abs(want)
        assert tight.mean() >= 0.999, (key, float(1 - tight.mean()))
    np.testing.assert_allclose(state.bn_state.mean.numpy(), g["steps/bn_mean"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(state.bn_state.var.numpy(), g["steps/bn_var"], rtol=1e-5, atol=1e-6)
    # the caller's initial tree is never updated
    np.testing.assert_array_equal(
        tiny.trainable["text_projection"].detach().numpy(),
        _load("tiny_state.npz")["trainable/text_projection"],
    )


def test_fit_steps_groups_steps_into_epochs(tiny):
    """steps_per_epoch 1 over three batches: three epochs, epoch 0 at lr 0 (the
    weights stay), epoch 1 at the warmup's full lr (they move)."""
    cfg, g = tiny.cfg, tiny.golden
    feats, labels = _forward_inputs(tiny)
    batch = tmod.TrainBatch(feats[:4], labels[:4], feats[4:], labels[4:])
    state = tmod.init_state(
        tiny.trainable, tiny.bn, {"lr": 1e-3}, {}, {"warmup_epochs": 1, "total_epoch": 3}, 1
    )
    snapshots = []
    state, history = tmod.fit_steps(
        tmod.build_train_step(tiny.model, tiny.loss_cfg), tiny.frozen, state, [batch] * 3,
        torch.from_numpy(g["ncentroid"]), torch.Generator(), epochs=5, steps_per_epoch=1,
        on_step=lambda s, t: snapshots.append(s.trainable["text_projection"].detach().clone()),
    )
    assert state.step == 3 and len(history) == 3
    initial = tiny.trainable["text_projection"].detach()
    assert torch.equal(snapshots[0], initial)
    assert not torch.equal(snapshots[1], initial)
    np.testing.assert_allclose(history[0]["train/loss"], g["train/loss_terms"][0], rtol=2e-4)


def test_compute_ncentroid_matches_golden(tiny):
    """Over the synthetic corpus the golden fixture's module generates."""
    cfg = tiny.cfg
    data = dict(cfg.data)
    generate_synthetic_dataset(
        frames_root=data["frames_root"], annotations_root=data["annotations_root"],
        num_normal=data.get("synthetic_num_normal", 8),
        num_abnormal=data.get("synthetic_num_abnormal", 8),
        num_test=data.get("synthetic_num_test", 4),
        num_classes=data["num_classes"], normal_id=data["normal_id"],
        feature_dim=tiny.model.clip_cfg.embed_dim,
        min_frames=data.get("synthetic_min_frames", 600),
        max_frames=data.get("synthetic_max_frames", 1400),
        seed=int(cfg.seed), make_frames=False,
    )
    datamodule = AnomalyCLIPDataModule(DataConfig.from_dict(data), seed=int(cfg.seed))
    got = tmod.compute_ncentroid(
        datamodule.train_dataloader_test_mode(), tiny.model.clip_cfg.embed_dim
    )
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, tiny.golden["ncentroid"], rtol=1e-5, atol=1e-5)


def test_prepare_batch_squeezes_ncrops():
    feats = np.zeros((2, 1, 6, 3), np.float32)
    batch = tmod.prepare_batch(tmod.TrainBatch(feats, np.array([1, 2]), feats, np.array([0, 0])), "cpu")
    assert batch.abnormal_features.shape == (2, 6, 3)
    assert batch.normal_labels.dtype == torch.long
