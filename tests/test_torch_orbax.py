"""The port reads the JAX package's Orbax checkpoints without orbax
(``train/orbax_reader.py`` over ``train/ocdbt.py`` and ``utils/zstd.py``), and
evaluates and resumes from them, on the CPU.

- The reader's tree equals ``orbax.checkpoint``'s restore (what the JAX
  ``CheckpointManager.restore`` reads) bit for bit on the committed fixture
  (``tests/fixtures/orbax``, written by ``tests/helpers/make_orbax_fixture.py``)
  and on directories the JAX package writes here: the fit its resume writes, a
  ``convert_ckpt.main`` output, and a tree with a leaf over 128 KB, a bfloat16
  leaf, scalars of both widths and empty nodes.
- ``fixture.json`` holds: every leaf's dtype, shape and sha256 against the
  restore, the JAX test metrics against the JAX eval of the fixture, the JAX
  losses of one resumed epoch against the JAX resume.
- The port's eval of the fit's ``last`` matches the JAX eval at
  tests/test_golden.py's tolerance (1e-4 on the metrics); the port resumed from
  the Orbax directory and from its ``convert_ckpt`` -> ``state.pt`` give the
  same bits, and both stay within 1e-4 of each leaf's max of the JAX resume
  (losses and the trainable tree it saves); predict reads the Orbax run, the
  ncentroid beside it; a converted directory evaluates and refuses to resume.
- The full-width UCF-Crime state's largest leaf, written by JAX, reads back to
  the bit; the whole state (about 125 MB with the optimizer) is the ``slow``
  case.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os
import shutil
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from anomalyclip_tpu_torch import convert
from anomalyclip_tpu_torch.train import orbax_reader
from anomalyclip_tpu_torch.train.checkpoint import restore_state

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "orbax"
METRIC_TOL = 1e-4  # tests/test_golden.py's tolerance on fp32 results
LEAF_TOL = 1e-4  # of each leaf's max, as chip_smoke.py phase 4f bounds steps


def _load_by_path(name: str, path: Path):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


mf = _load_by_path("_test_torch_orbax_fixture", ROOT / "tests" / "helpers" / "make_orbax_fixture.py")
RECORD = json.loads((FIXTURE / "fixture.json").read_text())


@contextmanager
def _env(root: Path):
    wanted = {"PROJECT_ROOT": str(ROOT), "SYNTHETIC_ROOT": str(root / "synthetic"), "LOG_DIR": str(root / "logs")}
    saved = {k: os.environ.get(k) for k in wanted}
    os.environ.update(wanted)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _port_cfg(root: Path, clip: Path, *extra: str) -> dict:
    from anomalyclip_tpu_torch.config import compose, default_config_dir, to_dict

    with _env(root):
        return to_dict(compose(default_config_dir(), "train", mf.config_overrides(clip, *extra)))


def _port_resume(root: Path, clip: Path, ckpt) -> SimpleNamespace:
    from anomalyclip_tpu_torch.train.module import AnomalyCLIPTrainModule

    run = root / "run"
    module = AnomalyCLIPTrainModule(
        _port_cfg(root, clip, "trainer.max_epochs=2", f"ckpt_path={ckpt}", f"paths.output_dir={run}"),
        device="cpu")
    module.fit()
    return SimpleNamespace(losses=mf.epoch_losses(run)[1], trainable=module._final_state.trainable,
                           bn=list(module._final_state.bn_state), run=run)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The fixture copied with a ``last`` beside its epoch, and the seeded CLIP."""
    tmp = tmp_path_factory.mktemp("orbax")
    shutil.copytree(FIXTURE, tmp / "fixture")
    (tmp / "fixture" / "fit" / "checkpoints" / "last").symlink_to("epoch_000")
    return SimpleNamespace(tmp=tmp, clip=mf.write_clip_file(tmp / "clip.pt"),
                           fit=tmp / "fixture" / "fit" / "checkpoints" / "last",
                           converted=tmp / "fixture" / "converted")


@pytest.fixture(scope="module")
def jax_runs(work):
    """The JAX package on the fixture: its test metrics, one epoch resumed (a
    fit it writes, with its optimizer state), and a converted directory."""
    metrics = mf.jax_test_metrics(work.tmp / "jax_test", work.clip, work.fit)
    resumed = mf.jax_fit(work.tmp / "jax_resume", work.clip, epochs=2, ckpt_path=work.fit)
    converted = mf.write_converted(work.tmp / "jax_convert", work.fit, work.tmp / "jax_converted")
    return SimpleNamespace(metrics=metrics, resumed=resumed, converted=converted)


@pytest.fixture(scope="module")
def tree_dir(tmp_path_factory):
    """A tree the JAX ``CheckpointManager`` writes: a leaf over 128 KB, a
    bfloat16 leaf, int64 and int32 scalars, lists, empty optax nodes."""
    import jax.numpy as jnp
    import optax

    from anomalyclip_tpu.models.selector import BNState
    from anomalyclip_tpu.train.checkpoint import CheckpointManager

    rng = np.random.default_rng(5)
    manager = CheckpointManager(tmp_path_factory.mktemp("tree"))
    manager.save_epoch(3, {
        "trainable": {"big": (rng.standard_normal((300, 200)) * 0.02).astype(np.float32),
                      "half": jnp.asarray(rng.standard_normal((33, 7)), jnp.bfloat16),
                      "layers": [{"w": np.arange(10, dtype=np.int64)}, {"w": np.asarray(-3, np.int32)}]},
        "opt_state": (optax.EmptyState(), (optax.ScaleByAdamState(
            count=np.asarray(2, np.int32), mu={"x": np.ones(4, np.float32)}, nu={"x": np.full(4, 0.5, np.float32)}),
            optax.EmptyState())),
        "bn_state": BNState(mean=rng.standard_normal(5).astype(np.float32), var=np.ones(5, np.float32)),
        "step": np.asarray(7, np.int64), "epoch": np.asarray(3, np.int64),
    })
    return manager.ckpt_dir / "last"


def _flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def _assert_reader_equals_restore(path: Path) -> int:
    got, want = _flat(orbax_reader.read_tree(path)), mf.restored_leaves(path)
    assert sorted(got) == sorted(want)
    stored = {"/".join(k for k, _ in keys): v for keys, v in orbax_reader.read_leaves(path).items()}
    for key, w in want.items():
        if w is None:
            assert got[key] is None and stored[key] == (None, "None"), key
            continue
        g = got[key]
        assert g.shape == w.shape, key
        if w.dtype.name == "bfloat16":
            assert stored[key][1] == "bfloat16" and g.dtype == np.float32, key
            assert stored[key][0].tobytes() == np.ascontiguousarray(w).tobytes(), key
            assert g.tobytes() == w.astype(np.float32).tobytes(), key
        else:
            assert g.dtype == w.dtype and g.tobytes() == np.ascontiguousarray(w).tobytes(), key
    return len(want)


@pytest.mark.parametrize("which", ["fixture_fit", "fixture_converted", "jax_resumed_fit", "jax_converted", "tree"])
def test_reader_equals_the_orbax_restore(which, work, request):
    if which.startswith("fixture"):
        path = work.fit if which == "fixture_fit" else work.converted
    elif which == "tree":
        path = request.getfixturevalue("tree_dir")
    else:
        runs = request.getfixturevalue("jax_runs")
        path = runs.resumed / "checkpoints" / "last" if which == "jax_resumed_fit" else runs.converted
    assert _assert_reader_equals_restore(path) > 0


@pytest.mark.parametrize("name", ["fit", "converted"])
def test_fixture_json_holds_every_leaf_of_the_restore(name, work):
    path = work.fit if name == "fit" else work.converted
    want = RECORD["leaves"][name]
    got = {k: mf.leaf_record(v) for k, v in mf.restored_leaves(path).items()}
    assert got == want
    for keys, (array, dtype_name) in orbax_reader.read_leaves(path).items():
        record = want["/".join(k for k, _ in keys)]
        assert dtype_name == ("None" if array is None else record["dtype"])
        if array is not None:
            assert hashlib.sha256(np.ascontiguousarray(array).tobytes()).hexdigest() == record["sha256"]


def test_fixture_json_metrics_are_the_jax_eval(jax_runs):
    for k in mf.METRICS:
        assert jax_runs.metrics[k] == pytest.approx(RECORD["jax_test_metrics"][k], abs=METRIC_TOL), k


def test_fixture_json_losses_are_the_jax_resume(jax_runs):
    got = mf.epoch_losses(jax_runs.resumed)[1]
    for k in mf.LOSSES:
        assert abs(got[k] - RECORD["jax_resumed_losses"][k]) <= LEAF_TOL * abs(RECORD["jax_resumed_losses"][k]), k


def test_port_eval_of_the_orbax_last_matches_the_jax_eval(work, jax_runs):
    from anomalyclip_tpu_torch.train.module import AnomalyCLIPTrainModule

    module = AnomalyCLIPTrainModule(_port_cfg(work.tmp / "port_test", work.clip), device="cpu")
    got = module.test(ckpt_path=str(work.fit))
    for k in mf.METRICS:
        assert got[k] == pytest.approx(jax_runs.metrics[k], abs=METRIC_TOL), k


@pytest.fixture(scope="module")
def port_resumes(work):
    """The port resumed for one epoch from the Orbax ``last`` and from the
    ``state.pt`` the port's ``convert_ckpt`` makes of it."""
    from anomalyclip_tpu_torch.convert_ckpt import main as convert_main

    converted = work.tmp / "port_state"
    convert_main([str(work.fit), str(converted)])
    return SimpleNamespace(state_dir=converted, orbax=_port_resume(work.tmp / "port_orbax", work.clip, work.fit),
                           state_pt=_port_resume(work.tmp / "port_state_pt", work.clip, converted))


def test_convert_ckpt_writes_the_orbax_state(work, port_resumes):
    want = restore_state(work.fit)
    got = torch.load(port_resumes.state_dir / "state.pt", weights_only=True)
    assert (got["step"], got["epoch"], got["count"]) == (want["step"], want["epoch"], want["count"]) == (2, 0, 2)
    assert all(torch.equal(a, b) for a, b in zip(convert.tree_leaves(got["trainable"]),
                                                   convert.tree_leaves(want["trainable"])))
    assert torch.equal(got["bn_mean"], want["bn_state"].mean) and torch.equal(got["bn_var"], want["bn_state"].var)
    for i, s in want["optimizer"]["state"].items():
        assert all(torch.equal(got["optimizer"]["state"][i][k], s[k]) for k in ("step", "exp_avg", "exp_avg_sq"))


def test_the_optax_state_maps_onto_adamw(work):
    tree = orbax_reader.read_tree(work.fit)
    state = restore_state(work.fit)
    groups = state["optimizer"]["param_groups"]
    assert [g["name"] for g in groups] == [{"prompt_ctx": "prompt_learner", "text_projection": "text_projection",
                                            "temporal": "temporal_model"}[k] for k in state["trainable"]]
    inner = tree["opt_state"]["inner_states"]
    index = 0
    for key, group in zip(state["trainable"], groups):
        adam = inner[group["name"]]["inner_state"][0]
        mu = convert.tree_leaves(convert.params_from_jax(adam["mu"][key], device="cpu"))
        nu = convert.tree_leaves(convert.params_from_jax(adam["nu"][key], device="cpu"))
        assert group["params"] == list(range(index, index + len(mu)))
        for m, v, p in zip(mu, nu, convert.tree_leaves(state["trainable"][key])):
            s = state["optimizer"]["state"][index]
            assert torch.equal(s["exp_avg"], m) and torch.equal(s["exp_avg_sq"], v)
            assert s["exp_avg"].shape == p.shape and float(s["step"]) == int(adam["count"].reshape(-1)[0])
            index += 1
    assert index == len(convert.tree_leaves(state["trainable"]))


def test_port_resume_from_orbax_equals_resume_from_state_pt(port_resumes):
    a, b = port_resumes.orbax, port_resumes.state_pt
    assert a.losses == b.losses
    assert all(torch.equal(x, y) for x, y in zip(convert.tree_leaves(a.trainable), convert.tree_leaves(b.trainable)))
    assert all(torch.equal(x, y) for x, y in zip(a.bn, b.bn))


def test_port_resume_matches_the_jax_resume(port_resumes, jax_runs):
    want = mf.epoch_losses(jax_runs.resumed)[1]
    for k in mf.LOSSES:
        assert abs(port_resumes.orbax.losses[k] - want[k]) <= LEAF_TOL * abs(want[k]), k
    saved = {k[len("trainable/"):]: v for k, v in mf.restored_leaves(jax_runs.resumed / "checkpoints" / "last").items()
             if k.startswith("trainable/")}
    got = _flat(convert.tree_to_jax(port_resumes.orbax.trainable))
    assert sorted(got) == sorted(saved)
    for key, w in saved.items():
        assert np.abs(got[key] - w).max() <= LEAF_TOL * np.abs(w).max(), key


def test_predict_reads_the_orbax_run_and_its_ncentroid(work, port_resumes):
    """predict.main on the Orbax ``last`` and on its ``state.pt`` in a run
    laid out the same way (the ncentroid beside both): the same scores."""
    from anomalyclip_tpu_torch import predict

    run = work.tmp / "state_run"
    (run / "checkpoints").mkdir(parents=True)
    shutil.copytree(port_resumes.state_dir, run / "checkpoints" / "epoch_000")
    shutil.copy(work.fit.parent.parent / "ncentroid.npy", run / "ncentroid.npy")
    feats = work.tmp / "feats.npy"
    np.save(feats, np.random.default_rng(1).standard_normal((70, 64)).astype(np.float32))
    args = ["data=synthetic", "model=anomaly_clip_synthetic", "trainer=cpu", *mf.FIT_OVERRIDES,
            f"model.net.clip_ckpt_path={work.clip}", f"input={feats}"]
    with _env(work.tmp / "predict"):
        a = predict.main(args + [f"ckpt_path={work.fit}", f"output={work.tmp / 'a.json'}"])
        b = predict.main(args + [f"ckpt_path={run / 'checkpoints' / 'epoch_000'}", f"output={work.tmp / 'b.json'}"])
    assert np.asarray(a["frame_scores"]).shape == (70,)
    assert np.array_equal(a["frame_scores"], b["frame_scores"])


def test_a_converted_dir_evaluates_and_refuses_to_resume(work):
    from anomalyclip_tpu_torch.train.module import AnomalyCLIPTrainModule

    module = AnomalyCLIPTrainModule(_port_cfg(work.tmp / "converted_eval", work.clip), device="cpu")
    state = module.load_state(work.converted)
    want = convert.params_from_jax(orbax_reader.read_tree(work.converted)["trainable"], device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(convert.tree_leaves(state.trainable), convert.tree_leaves(want)))
    assert state.optimizer is None and state.step == 0
    assert np.isfinite(module.test(state=state)["auc_roc"])
    assert restore_state(work.converted)["epoch"] == -1
    resume = AnomalyCLIPTrainModule(
        _port_cfg(work.tmp / "converted_resume", work.clip, f"ckpt_path={work.converted}"), device="cpu")
    with pytest.raises(ValueError, match="no optimizer state"):
        resume.fit()


# ---------------------------------------------------------------------------
# full width: the UCF-Crime state
# ---------------------------------------------------------------------------


def _ucf_model():
    """The UCF-Crime model of the JAX package over a ViT-B/16 CLIP cut to one
    layer a tower (the trainable shapes are the full model's), its CLIP params
    from ``params_of(shapes)``."""
    import jax

    from anomalyclip_tpu.config import compose
    from anomalyclip_tpu.models.anomaly_clip import AnomalyCLIP
    from anomalyclip_tpu.models.clip.model import CLIPConfig, init_clip_params
    from anomalyclip_tpu.train.module import _net_config

    with _env(Path("/nonexistent")):
        cfg = compose(ROOT / "configs", "train", ["experiment=ucfcrime"])
    clip_cfg = dataclasses.replace(CLIPConfig.vit_b16(), vision_layers=1, transformer_layers=1)
    return cfg, clip_cfg, lambda params: AnomalyCLIP.build(_net_config(dict(cfg.model.net)), params, clip_cfg), \
        lambda key: init_clip_params(key, clip_cfg)


def test_full_width_largest_leaf_reads_to_the_bit(tmp_path):
    import jax

    from anomalyclip_tpu.models.selector import BNState
    from anomalyclip_tpu.train.checkpoint import CheckpointManager

    _, _, build, init_clip = _ucf_model()
    shapes = jax.eval_shape(init_clip, jax.random.PRNGKey(0))
    model, frozen = build(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    trainable, bn = jax.eval_shape(lambda key: model.init_trainable(key, frozen), jax.random.PRNGKey(1))
    path, largest = max(jax.tree_util.tree_flatten_with_path(trainable)[0], key=lambda kv: np.prod(kv[1].shape))
    value = (np.random.default_rng(3).standard_normal(largest.shape) * 0.02).astype(np.float32)
    assert value.nbytes > 8 * 2**20  # a temporal conv kernel, 9.4 MB
    manager = CheckpointManager(tmp_path)
    manager.save_epoch(0, {"trainable": {"leaf": value}, "step": np.asarray(0), "epoch": np.asarray(0),
                           "bn_state": BNState(np.zeros(bn.mean.shape, np.float32), np.ones(bn.var.shape, np.float32))})
    start = time.perf_counter()
    got = orbax_reader.read_tree(manager.ckpt_dir / "last")["trainable"]["leaf"]
    seconds = time.perf_counter() - start
    assert got.dtype == np.float32 and got.tobytes() == value.tobytes()
    print(f"largest leaf {jax.tree_util.keystr(path)} {largest.shape}: {value.nbytes / 1e6:.1f} MB in {seconds:.2f} s")


@pytest.mark.slow
def test_full_width_ucf_state_with_optimizer_reads_to_the_bit(tmp_path):
    from anomalyclip_tpu.train.checkpoint import CheckpointManager

    import jax

    from anomalyclip_tpu.train import optim as joptim

    cfg, _, build, init_clip = _ucf_model()
    model, frozen = build(init_clip(jax.random.PRNGKey(0)))
    trainable, bn = model.init_trainable(jax.random.PRNGKey(1), frozen)
    trainable = jax.tree_util.tree_map(np.asarray, trainable)
    tx = joptim.build_optimizer(dict(cfg.model.solver), dict(cfg.model.optimizer), dict(cfg.model.scheduler), 8)
    rng = np.random.default_rng(2)
    grads = jax.tree_util.tree_map(lambda p: (rng.standard_normal(p.shape) * 1e-3).astype(np.float32), trainable)
    _, opt_state = tx.update(grads, tx.init(trainable), trainable)
    manager = CheckpointManager(tmp_path)
    manager.save_epoch(0, {"trainable": trainable, "opt_state": opt_state, "bn_state": bn,
                           "step": np.asarray(8), "epoch": np.asarray(0)})
    path = manager.ckpt_dir / "last"
    size = sum(p.stat().st_size for p in path.resolve().rglob("*") if p.is_file())
    start = time.perf_counter()
    state = restore_state(path)
    seconds = time.perf_counter() - start
    n = _assert_reader_equals_restore(path)
    assert n > 100 and size > 100 * 2**20 and state["count"] == 1
    print(f"UCF-Crime state: {n} leaves, {size / 1e6:.1f} MB on disk, read and mapped in {seconds:.1f} s")
