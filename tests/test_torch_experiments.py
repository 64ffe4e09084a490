"""The ShanghaiTech and XD-Violence experiments: the port against the JAX
package, on the CPU, at each config's own widths and class count.

``experiment=shanghaitech`` (18 classes, ``normal_id`` 8, ``concat_features``:
the temporal input is the CLIP width plus the 17 similarity logits, emb 256,
depth 2) and ``experiment=xdviolence`` (7 classes, ``normal_id`` 4, emb 128:
head dim 16), each composed by the JAX package, the classes read from the
label CSV the config names, on the 32 x 16 grid, with the small CLIP tower
the other parity tests use and 2 + 2 videos. The same seeded numpy inputs and
the same weights (the JAX package's own init, carried across by ``convert``)
go through both packages (the JAX attention through its CPU formulation):

- ``forward_train`` at dropout 0: logits, top-k logits and scores at rtol /
  atol 1e-4, the selected indices exact, the BN state 1e-6;
- ``forward_test`` on one video of two grids at 1e-4;
- every trainable leaf's gradient of the total loss at 1e-4 of its max;
- three steps of ``fit_steps`` against the same steps through optax, at the
  tolerances of tests/test_torch_train.py.

For the gradients and the steps the port takes the LeakyReLU branches of the
temporal model's conv feed-forward that the JAX run took (recorded as it is
traced). Its derivative jumps from 1 to 0.01 at 0, so where a pre-activation
lies within an fp32 rounding of 0 the two packages may take different
branches, and a conv weight's gradient then jumps by far more than the
rounding (XD-Violence's seed here: one of 1.57M pre-activations, 6.9e-8 from
0, moves ``layers/0/ff1/conv1_w`` by 1.8e-4 of its max; chip_smoke.py's
``LeakyBranches`` does the same between two runs on the card).

Each experiment's state written by the JAX package's Orbax checkpointing
restores in the port to the bit. And the released ShanghaiTech model's
temporal block: a reference-layout
depth-2 state dict at its full width converts to the same tree through both
packages' ``convert_ckpt``, scores as the reference model does, and
round-trips through the port's ``temporal_state_dict``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib.util
import os
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from anomalyclip_tpu import convert_ckpt as jconvert_ckpt
from anomalyclip_tpu.config.compose import compose
from anomalyclip_tpu.models import anomaly_clip as jac
from anomalyclip_tpu.models import losses as jloss
from anomalyclip_tpu.models import selector as jsel
from anomalyclip_tpu.models import temporal as jtemporal
from anomalyclip_tpu.models.clip import model as jclip
from anomalyclip_tpu.train import optim as joptim
from anomalyclip_tpu.utils.treeio import flatten_tree
from anomalyclip_tpu_torch import convert
from anomalyclip_tpu_torch import convert_ckpt as tconvert_ckpt
from anomalyclip_tpu_torch.models import anomaly_clip as tac
from anomalyclip_tpu_torch.models import losses as tloss
from anomalyclip_tpu_torch.models import selector as tsel
from anomalyclip_tpu_torch.models import temporal as ttemporal
from anomalyclip_tpu_torch.train import module as tmod
from anomalyclip_tpu_torch.train.checkpoint import restore_state

ROOT = Path(__file__).resolve().parents[1]
RTOL = ATOL = 1e-4  # fp32 features (tests/test_golden.py)
# what each experiment's config sets, read back from the composed config
SETTINGS = {
    "shanghaitech": dict(num_classes=18, normal_id=8, emb_size=256, depth=2, concat_features=True),
    "xdviolence": dict(num_classes=7, normal_id=4, emb_size=128, depth=1, concat_features=False),
}
NO_DROPOUT = ("model.net.select_idx_dropout_topk=0.0", "model.net.select_idx_dropout_bottomk=0.0")
STEP_LR = 1e-3  # tests/test_torch_train.py's three-step trajectory
STEP_BATCHES = 3


def _load_helper(name: str):
    """tests/helpers/<name>.py by its path: an installed package named
    ``tests`` may shadow this repository's."""
    path = ROOT / "tests" / "helpers" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_test_torch_experiments_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _compose(experiment: str):
    """The experiment composed by the JAX package, rooted at the repository."""
    saved = os.environ.get("PROJECT_ROOT")
    os.environ["PROJECT_ROOT"] = str(ROOT)
    try:
        return compose(ROOT / "configs", "train", [f"experiment={experiment}", *NO_DROPOUT])
    finally:
        if saved is None:
            os.environ.pop("PROJECT_ROOT", None)
        else:
            os.environ["PROJECT_ROOT"] = saved


def _fields(cls, mapping) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in dict(mapping).items() if k in names}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_layout(tree, key: str = ""):
    """A port tree -> numpy in the JAX package's layout (conv kernels HWIO)."""
    if isinstance(tree, dict):
        return {k: _jax_layout(v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax_layout(v) for v in tree]
    a = tree.detach().cpu().numpy()
    return a.transpose(2, 3, 1, 0) if key in ("conv1_w", "conv2_w") else a


@contextlib.contextmanager
def _jax_branches_recorded(masks: list):
    """The JAX temporal model's conv feed-forward (models/temporal.py
    ``_conv_ff``), its LeakyReLU's branches appended to ``masks`` as it is
    traced."""
    real = jtemporal._conv_ff

    def conv(y, w, b):
        return jax.lax.conv_general_dilated(y, w, window_strides=(1, 1), padding="SAME",
                                            dimension_numbers=("NHWC", "HWIO", "NHWC")) + b

    def conv_ff(x, p):
        y = conv(jtemporal._chan_layer_norm(x, p["ln_g"], p["ln_b"]), p["conv1_w"], p["conv1_b"])
        masks.append(y >= 0)
        return conv(jnp.where(y >= 0, y, 0.01 * y), p["conv2_w"], p["conv2_b"])

    jtemporal._conv_ff = conv_ff
    try:
        yield masks
    finally:
        jtemporal._conv_ff = real


@contextlib.contextmanager
def _port_takes(masks: list):
    """The port's LeakyReLU takes the given branches (NHWC, JAX's layout), one
    call after another."""
    real, taken = ttemporal.leaky_relu, iter(masks)

    def leaky_relu(y, positive=None):
        return real(y, torch.from_numpy(np.array(next(taken))).permute(0, 3, 1, 2))

    ttemporal.leaky_relu = leaky_relu
    try:
        yield
    finally:
        ttemporal.leaky_relu = real
    assert next(taken, None) is None, "fewer LeakyReLU calls than the JAX run's"


@functools.lru_cache(maxsize=None)
def _tiny_clip():
    """The small CLIP tower's seeded parameters, made once for both experiments."""
    return jax.jit(lambda key: jclip.init_clip_params(key, jclip.CLIPConfig.tiny()))(jax.random.PRNGKey(0))


def _videos(rng, n: int, frames: int, dim: int, labels) -> tuple:
    return rng.standard_normal((n, frames, dim)).astype(np.float32), np.asarray(labels, np.int64)


@pytest.fixture(scope="module", params=sorted(SETTINGS))
def experiment(request):
    """Both packages' models of one experiment on the same weights and inputs,
    and the JAX package's outputs: the training forward and its gradients, a
    test-mode forward, and three optimizer steps."""
    name = request.param
    cfg = _compose(name)
    net, data = cfg.model.net, cfg.data
    settings = {k: (data if k in ("num_classes", "normal_id") else net)[k] for k in SETTINGS[name]}
    assert settings == SETTINGS[name]
    assert (int(net.num_segments), int(net.seg_length)) == (32, 16)

    clip_cfg = jclip.CLIPConfig.tiny()
    jmodel, jfrozen = jac.AnomalyCLIP.build(
        jac.AnomalyCLIPConfig(**_fields(jac.AnomalyCLIPConfig, net)), _tiny_clip(), clip_cfg)
    jtrainable = jax.jit(lambda key: jmodel.init_trainable(key, jfrozen)[0])(jax.random.PRNGKey(1))
    n_cls, normal = len(jmodel.classnames), int(data.normal_id)
    assert n_cls == int(data.num_classes)

    rng = np.random.default_rng(21)
    bn = jsel.BNState(jnp.asarray(0.1 * rng.standard_normal(n_cls - 1), jnp.float32),
                      jnp.asarray(rng.uniform(0.5, 2.0, n_cls - 1), jnp.float32))
    d, t = clip_cfg.embed_dim, int(net.num_segments) * int(net.seg_length)
    ncentroid = (0.1 * rng.standard_normal(d)).astype(np.float32)
    abnormal = [c for c in range(n_cls) if c != normal]
    batches = [_videos(rng, 4, t, d, [abnormal[2 * k], abnormal[2 * k + 1], normal, normal])
               for k in range(STEP_BATCHES)]
    video = rng.standard_normal((1, 2 * t, d)).astype(np.float32)  # two grids

    jloss_cfg = jloss.LossConfig(**_fields(jloss.LossConfig, cfg.model.loss))

    solver = {**dict(cfg.model.solver), "lr": STEP_LR}
    optimizer, scheduler = dict(cfg.model.optimizer), {**dict(cfg.model.scheduler), "warmup_epochs": 0}
    tx = joptim.build_optimizer(solver, optimizer, scheduler, 1000)

    def loss_fn(trainable, bn_state, feats, labels):
        masks = []
        with _jax_branches_recorded(masks):
            out, new_bn = jmodel.forward_train(jfrozen, trainable, bn_state, feats, labels,
                                               jnp.asarray(ncentroid), jax.random.PRNGKey(0))
        terms = jloss.compute_loss(out.logits, out.logits_topk, labels, out.scores, out.idx_topk_abn,
                                   out.idx_topk_nor, out.idx_bottomk_abn, jloss_cfg)
        return terms.total, (out, new_bn, masks)

    @jax.jit
    def step(trainable, opt_state, bn_state, feats, labels):
        (loss, (out, new_bn, masks)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            trainable, bn_state, feats, labels)
        updates, opt_state = tx.update(grads, opt_state, trainable)
        return loss, out, new_bn, masks, grads, optax.apply_updates(trainable, updates), opt_state

    trainable, bn_state, opt_state, losses, masks = jtrainable, bn, tx.init(jtrainable), [], []
    for k, (feats, labels) in enumerate(batches):
        loss, out, new_bn, step_masks, grads, trainable, opt_state = step(
            trainable, opt_state, bn_state, jnp.asarray(feats), jnp.asarray(labels))
        if k == 0:
            first = SimpleNamespace(out=_np(out), bn=_np(new_bn), grads=flatten_tree(_np(grads)))
        losses.append(float(loss))
        masks += _np(step_masks)
        bn_state = new_bn
    test = jax.jit(lambda tr, x: jmodel.forward_test(jfrozen, tr, bn, x, jnp.asarray(ncentroid), 2))
    similarity, scores = _np(test(jtrainable, jnp.asarray(video)))

    frozen = convert.params_from_jax(_np(jfrozen), device="cpu")
    model, frozen = tac.AnomalyCLIP.build(
        tac.AnomalyCLIPConfig(**_fields(tac.AnomalyCLIPConfig, net)), frozen["clip"],
        tac.CLIPConfig(**dataclasses.asdict(clip_cfg)))
    return SimpleNamespace(
        name=name, cfg=cfg, model=model, frozen=frozen,
        trainable=convert.params_from_jax(_np(jtrainable), device="cpu"),
        bn=convert.bn_state_from_jax(bn, device="cpu"), ncentroid=ncentroid, batches=batches, video=video,
        loss_cfg=tloss.LossConfig(**_fields(tloss.LossConfig, cfg.model.loss)),
        solver=solver, optimizer=optimizer, scheduler=scheduler,
        first=first, losses=losses, after=flatten_tree(_np(trainable)), after_bn=_np(bn_state),
        masks=masks, test=(similarity, scores), jax_state={"trainable": _np(jtrainable), "bn_state": _np(bn)},
    )


def _port_forward_train(e, trainable):
    feats, labels = e.batches[0]
    out, bn = e.model.forward_train(e.frozen, trainable, e.bn, torch.from_numpy(feats), torch.from_numpy(labels),
                                    torch.from_numpy(e.ncentroid), torch.Generator())
    return out, bn, labels


def test_the_port_builds_the_experiments_model(experiment):
    """The classes from the label CSV, the temporal input's width (the CLIP
    width, plus the similarity logits under concat_features) and its depth."""
    e, settings = experiment, SETTINGS[experiment.name]
    assert len(e.model.classnames) == settings["num_classes"]
    assert e.model.classnames[settings["normal_id"]].lower() == "normal"
    logits = (settings["num_classes"] - 1) * settings["concat_features"]
    tcfg = e.model.temporal_cfg
    assert tcfg.input_size == e.model.clip_cfg.embed_dim + logits
    assert (tcfg.emb_size, tcfg.depth, tcfg.head_dim) == (settings["emb_size"], settings["depth"],
                                                         settings["emb_size"] // 8)
    assert len(e.trainable["temporal"]["layers"]) == settings["depth"]


def test_forward_train_matches_jax(experiment):
    e = experiment
    out, bn, _ = _port_forward_train(e, e.trainable)
    for name in ("logits", "logits_topk", "scores"):
        want = getattr(e.first.out, name)
        got = getattr(out, name).detach().numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)
    assert out.logits.shape[-1] == SETTINGS[e.name]["num_classes"] - 1
    for name in ("idx_topk_abn", "idx_topk_nor", "idx_bottomk_abn"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), getattr(e.first.out, name), err_msg=name)
    np.testing.assert_allclose(bn.mean.numpy(), e.first.bn.mean, rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), e.first.bn.var, rtol=0, atol=1e-6)


def test_forward_test_matches_jax(experiment):
    e = experiment
    similarity, scores = e.model.forward_test(e.frozen, e.trainable, e.bn, torch.from_numpy(e.video),
                                              torch.from_numpy(e.ncentroid), 2)
    want_similarity, want_scores = e.test
    assert scores.shape == want_scores.shape == (e.video.shape[1],)
    np.testing.assert_allclose(similarity.numpy(), want_similarity, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(scores.numpy(), want_scores, rtol=RTOL, atol=ATOL)


def test_gradients_match_jax(experiment):
    """d(total loss)/d(every trainable leaf) against jax.grad on the JAX run's
    LeakyReLU branches, through the depth-2 temporal model's two layers
    (ShanghaiTech) or its head dim 16 (XD-Violence)."""
    e = experiment
    trainable = convert.as_trainable(e.trainable)
    with _port_takes(e.masks[:2 * e.model.temporal_cfg.depth]):
        out, _, labels = _port_forward_train(e, trainable)
    tloss.compute_loss(out.logits, out.logits_topk, torch.from_numpy(labels), out.scores, out.idx_topk_abn,
                       out.idx_topk_nor, out.idx_bottomk_abn, e.loss_cfg).total.backward()
    got = flatten_tree(_jax_layout(convert.tree_map(lambda t: t.grad, trainable)))
    assert got.keys() == e.first.grads.keys()
    for key, want in e.first.grads.items():
        np.testing.assert_allclose(got[key], want, rtol=1e-4, atol=1e-4 * np.abs(want).max(), err_msg=key)


def test_three_steps_match_jax(experiment):
    """Three steps of fit_steps (forward, loss, backward, AdamW over the
    groups) on the JAX run's LeakyReLU branches against the same three through
    optax: the losses at rtol 5e-4, the weights with tests/test_golden.py's
    two-tier check, the BN state 1e-5."""
    e = experiment
    state = tmod.init_state(e.trainable, e.bn, e.solver, e.optimizer, e.scheduler, steps_per_epoch=1000)
    batches = [tmod.TrainBatch(f[:2], y[:2], f[2:], y[2:]) for f, y in e.batches]
    losses = []
    with _port_takes(e.masks):
        state, history = tmod.fit_steps(
            tmod.build_train_step(e.model, e.loss_cfg), e.frozen, state, batches, torch.from_numpy(e.ncentroid),
            torch.Generator(), epochs=1, steps_per_epoch=1000,
            on_step=lambda s, terms: losses.append(float(terms.total)))
    assert state.step == STEP_BATCHES and len(history) == 1
    np.testing.assert_allclose(losses, e.losses, rtol=5e-4, atol=1e-5)
    got = flatten_tree(_jax_layout(state.trainable))
    assert got.keys() == e.after.keys()
    for key, want in e.after.items():
        diff = np.abs(got[key] - want)
        np.testing.assert_array_less(diff.max(), 2 * STEP_LR * STEP_BATCHES, err_msg=key)
        tight = diff <= 5e-5 + 1e-3 * np.abs(want)
        assert tight.mean() >= 0.999, (key, float(1 - tight.mean()))
    np.testing.assert_allclose(state.bn_state.mean.numpy(), e.after_bn.mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(state.bn_state.var.numpy(), e.after_bn.var, rtol=1e-5, atol=1e-6)


def test_a_jax_checkpoint_of_the_experiment_restores_in_the_port(experiment, tmp_path):
    """The experiment's state written by the JAX package's CheckpointManager
    (Orbax) reads back through the port's ``restore_state`` to the bit, every
    key of ShanghaiTech's two temporal layers and of XD-Violence's one. Each
    leaf is cut to its first 16 values (a 4-d conv kernel to (1, 1, 1, 16)):
    the port's reader decodes at a few MB/s on a CPU, and the tree's keys are
    what depth 2 changes."""
    from anomalyclip_tpu.train.checkpoint import CheckpointManager

    e = experiment
    cut = jax.tree_util.tree_map(lambda a: np.ascontiguousarray(a.reshape(-1)[:16]).reshape(
        (1,) * (a.ndim - 1) + (-1,)), e.jax_state["trainable"])
    manager = CheckpointManager(tmp_path)
    manager.save_epoch(0, {"trainable": cut, "bn_state": e.jax_state["bn_state"], "step": np.asarray(4),
                           "epoch": np.asarray(0)})
    restored = restore_state(manager.ckpt_dir / "last")
    assert len(restored["trainable"]["temporal"]["layers"]) == SETTINGS[e.name]["depth"]
    got, want = flatten_tree(_jax_layout(restored["trainable"])), flatten_tree(cut)
    assert got.keys() == want.keys() == flatten_tree(e.jax_state["trainable"]).keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for got_bn, want_bn in zip(restored["bn_state"], e.jax_state["bn_state"], strict=True):
        np.testing.assert_array_equal(got_bn.numpy(), want_bn)
    assert (restored["epoch"], restored["step"]) == (0, 4)


# ---------------------------------------------------------------------------
# the released ShanghaiTech model's temporal block: depth 2
# ---------------------------------------------------------------------------


def test_a_depth_2_reference_checkpoint_converts_the_same_in_both_packages():
    """``temporal_model.*`` of a reference-layout checkpoint at ShanghaiTech's
    width (input 512 + 17, emb 256, depth 2: blocks 0-3): the same tree through
    both converters, the reference model's scores through the port's
    ``temporal_scores`` on it, and the keys and values back through
    ``temporal_state_dict``."""
    axial = _load_helper("axial_torch")
    torch.manual_seed(0)
    reference = axial.TemporalModel(input_size=529, emb_size=256, output_size=1, heads=8, dim_heads=None,
                                    depth=2, num_segments=32, seg_length=16).float().eval()
    sd = {f"temporal_model.{k}": v.detach().numpy() for k, v in reference.state_dict().items()}
    assert {k.split(".")[4] for k in sd if ".layers.blocks." in k} == {"0", "1", "2", "3"}

    want = flatten_tree(_np(jconvert_ckpt.temporal_params_from_torch(sd)))
    port = tconvert_ckpt.temporal_params_from_torch(sd)
    assert len(port["layers"]) == 2
    got = flatten_tree(_jax_layout(port))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)

    cfg = ttemporal.TemporalConfig(input_size=529, emb_size=256, depth=2, heads=8, dim_heads=None,
                                   num_segments=32, seg_length=16)
    feats = np.random.default_rng(5).standard_normal((32 * 16, 529)).astype(np.float32)
    with torch.no_grad():
        oracle = reference(torch.from_numpy(feats), segment_size=1, test_mode=False).numpy()
        scores = ttemporal.temporal_scores(torch.from_numpy(feats), port, cfg, test_mode=False).numpy()
    np.testing.assert_allclose(scores.reshape(oracle.shape), oracle, rtol=1e-4, atol=1e-5)

    back = tconvert_ckpt.temporal_state_dict(port)
    assert back.keys() == sd.keys()
    for key, value in sd.items():
        np.testing.assert_array_equal(back[key].numpy(), value, err_msg=key)
