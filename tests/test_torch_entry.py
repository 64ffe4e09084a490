"""The port's entry points, sweeps, checkpoint conversion and CLIP loading
against the JAX package's, on the CPU.

- ``_expand_multirun``, ``_best_trial`` (nan and None trials), ``tpe.suggest``
  to the bit, and the trial sequences of the random, grid and TPE searches
  with ``_single_run`` replaced in both packages by one function of the trial;
- ``train_entry.main`` equal to the port's module run directly, a multirun's
  and a random search's run directories, the refusal of a run on the card
  without one (an artifact's eval included), and what more than one device or
  process resolves to (spawned CPU ranks, a joined group whose failed init
  raises);
- a Lightning ``.ckpt`` built here: its conversion equal to the JAX
  converter's to the bit after ``params_from_jax``, ``eval_entry`` on it
  within 1e-4 of the JAX ``eval_entry``'s AUC, AP, mAUC and mAP, and the
  conversion CLI's checkpoint directory;
- ``load_torch_clip_checkpoint`` on a plain, an fp16 and a TorchScript file,
  ``config_from_state_dict`` on every arch's shapes and on the OpenAI layout
  ``chip_smoke.py`` writes, all against the JAX converter;
- the registry's order, ``ANOMALYCLIP_NO_DOWNLOAD`` and ``download_clip``'s
  SHA check with ``urllib`` replaced.
"""

from __future__ import annotations

import csv
import dataclasses
import hashlib
import importlib.util
import io
import json
import math
import shutil
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from anomalyclip_tpu import convert_ckpt as jconvert_ckpt
from anomalyclip_tpu import eval_entry as jeval_entry
from anomalyclip_tpu import train_entry as jtrain_entry
from anomalyclip_tpu.models.clip import convert as jclip_convert
from anomalyclip_tpu.models.clip import registry as jregistry
from anomalyclip_tpu.models.clip.model import CLIPConfig as JaxCLIPConfig
from anomalyclip_tpu.train import tpe as jtpe
from anomalyclip_tpu_torch import convert, convert_ckpt, eval_entry, train_entry
from anomalyclip_tpu_torch.config import compose, default_config_dir, to_dict
from anomalyclip_tpu_torch.models.clip import convert as clip_convert
from anomalyclip_tpu_torch.models.clip import registry
from anomalyclip_tpu_torch.models.clip.model import CLIPConfig, init_clip_params
from anomalyclip_tpu_torch.train import tpe
from anomalyclip_tpu_torch.train.checkpoint import CheckpointManager
from anomalyclip_tpu_torch.train.module import METRIC_NAMES, AnomalyCLIPTrainModule

ROOT = Path(__file__).resolve().parents[1]
CONFIG_DIR = ROOT / "anomalyclip_tpu" / "configs"
METRICS = ("auc_roc", "auc_pr", "mean_mc_auroc", "mean_mc_aupr")
# one epoch of one step, one validation video, two test videos
SMALL = ("trainer.max_epochs=1", "trainer.limit_train_batches=1", "trainer.limit_val_batches=1",
         "trainer.limit_test_batches=2", "extras.print_config=False", "data.num_workers=0")


def _load_by_path(name: str, path: Path):
    """A module loaded by its path: an installed package named ``tests`` may
    shadow this repository's, and chip_smoke.py is no package."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def same(a, b) -> bool:
    """Equal in value and type, nan equal to nan."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def assert_trees_equal(got, want, path: str = "") -> None:
    """The port's tree ``got`` equal, key by key and to the bit, to ``want``."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (x, y) in enumerate(zip(got, want)):
            assert_trees_equal(x, y, f"{path}/{i}")
    else:
        assert got.dtype == want.dtype == torch.float32 and torch.equal(got, want), path


@pytest.fixture
def env(monkeypatch, tmp_path):
    monkeypatch.setenv("PROJECT_ROOT", str(ROOT))
    monkeypatch.setenv("SYNTHETIC_ROOT", str(tmp_path / "synthetic"))
    monkeypatch.setenv("LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setenv("ANOMALYCLIP_NO_DOWNLOAD", "1")
    for var in ("ANOMALYCLIP_CONFIG_DIR", "CLIP_CKPT_PATH", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


# ---------------------------------------------------------------------------
# sweeps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("overrides", [
    ["experiment=synthetic", "model.solver.lr=1e-5,1e-4", "data.batch_size=16,32"],
    ["tags=[a,b]", "x=1,2,3", "y=(1,2)"],
    ["-m", "a=1"],
    [],
])
def test_expand_multirun_matches_jax(overrides):
    got = train_entry._expand_multirun(overrides)
    assert got == jtrain_entry._expand_multirun(overrides)
    assert len(got) == max(1, math.prod(len(o.split("=", 1)[1].split(",")) for o in overrides
                                        if "=" in o and "," in o and "[" not in o and "(" not in o))


@pytest.mark.parametrize("direction", ["max", "min"])
@pytest.mark.parametrize("values", [
    [0.5, float("nan"), 0.7, None],
    [float("nan"), 0.2, 0.2],
    [None, float("nan")],
    [],
    [float("inf"), 0.1, -float("inf"), 0.3],
])
def test_best_trial_matches_jax_and_skips_nan_and_none(values, direction):
    results = [{"trial": i, "params": {"p": i}, "value": v} for i, v in enumerate(values)]
    got = train_entry._best_trial(results, direction)
    assert same(got, jtrain_entry._best_trial(results, direction))
    finite = [r for r in results if r["value"] is not None and math.isfinite(r["value"])]
    assert (got is None) == (not finite)
    if got is not None:
        assert got["value"] == (max if direction == "max" else min)(r["value"] for r in finite)


SPACE = {
    "model.solver.lr": {"type": "loguniform", "low": 1.e-6, "high": 1.e-4},
    "model.net.num_topk": {"type": "choice", "values": [2, 3, 5]},
    "model.loss.lambda_smooth": {"type": "uniform", "low": 0.0, "high": 1.0},
    "model.net.depth": {"type": "int", "low": 1, "high": 4},
}


@pytest.mark.parametrize("seed", [0, 1, 7, 1234])
def test_tpe_suggest_matches_jax_to_the_bit(seed):
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    history, jhistory = [], []
    for i in range(9):
        got = tpe.suggest(SPACE, history, rng, maximize=seed % 2 == 0, n_startup=3)
        want = jtpe.suggest(SPACE, jhistory, jrng, maximize=seed % 2 == 0, n_startup=3)
        assert same(got, want), i
        value = float(np.log(got["model.solver.lr"]) + got["model.net.num_topk"] - got["model.net.depth"])
        history.append((got, value))
        jhistory.append((want, value))
    assert rng.bit_generator.state == jrng.bit_generator.state

    def objective(p):
        return (p["model.loss.lambda_smooth"] - 0.3) ** 2 + p["model.net.depth"]

    assert same(tpe.minimize_demo(objective, SPACE, 8, seed=seed), jtpe.minimize_demo(objective, SPACE, 8, seed=seed))


def _fake_single_run(keys, jobs):
    """One function of a trial's overrides: nan for trial 1, a failure for
    trial 2, else a weighted sum of the values."""

    def single_run(job):
        jobs.append(list(job))
        i = int(job[-1].rsplit("_", 1)[1])
        if i == 2:
            raise RuntimeError("trial failed on purpose")
        params = [a.split("=", 1) for a in job[:-1] if a.split("=", 1)[0] in keys]
        value = float("nan") if i == 1 else sum(float(v) * (n + 1) for n, (_, v) in enumerate(params))
        return {"optimized_metric_value": value}

    return single_run


GRID = """# @package _global_
optimized_metric: auc_roc
hparams_search:
  sampler: grid
  direction: min
  space:
    model.net.num_topk:
      type: choice
      values: [2, 3]
    model.solver.lr:
      values: [1.e-5, 1e-4, 0.5]
"""


@pytest.mark.parametrize("search", ["random", "grid", "tpe"])
def test_search_trial_sequence_matches_jax(env, tmp_path, search):
    if search == "grid":
        tree = tmp_path / "configs"
        shutil.copytree(CONFIG_DIR, tree)
        (tree / "hparams_search" / "grid_test.yaml").write_text(GRID)
        env.setenv("ANOMALYCLIP_CONFIG_DIR", str(tree))
        argv = ["experiment=synthetic", "hparams_search=grid_test"]
    else:
        argv = ["experiment=synthetic", f"hparams_search=synthetic_{search}", "hparams_search.n_trials=6",
                "hparams_search.n_startup_trials=3"]
    cfg = compose(default_config_dir(), "train", argv)
    keys = set(cfg.hparams_search.space)
    jobs, jjobs = [], []
    env.setattr(train_entry, "_single_run", _fake_single_run(keys, jobs))
    env.setattr(jtrain_entry, "_single_run", _fake_single_run(keys, jjobs))
    got, want = train_entry._hparams_search(argv), jtrain_entry._hparams_search(argv)
    assert jobs == jjobs and len(jobs) == 6
    assert same(got, want)
    assert got["trials"][2]["value"] is None and math.isnan(got["trials"][1]["value"])
    assert got["best"]["trial"] not in (1, 2)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


def _losses(run_dir: Path) -> list:
    rows = list(csv.DictReader(open(run_dir / "csv" / "metrics.csv")))
    return [[r[k] for k in METRIC_NAMES] for r in rows if r.get("train/loss")]


def test_train_entry_equals_the_module_run_directly(env, tmp_path):
    argv = ["experiment=synthetic", "trainer=cpu", *SMALL]
    metrics = train_entry.main(argv + [f"paths.log_dir={tmp_path / 'entry'}"])
    cfg = to_dict(compose(default_config_dir(), "train", argv + [f"paths.log_dir={tmp_path / 'direct'}"]))
    module = AnomalyCLIPTrainModule(cfg, device="cpu")
    module.fit()
    direct = module.test(state=module._final_state)
    assert metrics.keys() == direct.keys() and set(METRICS) <= set(metrics)
    for key in metrics:
        np.testing.assert_array_equal(metrics[key], direct[key], err_msg=key)
    run = tmp_path / "entry" / "train" / "runs" / "synthetic"
    assert _losses(run) == _losses(module.save_dir) and len(_losses(run)) == 1
    assert json.loads((run / "metrics_0.json").read_text()) == json.loads(
        (module.save_dir / "metrics_0.json").read_text())
    last = CheckpointManager(run).restore(run / "checkpoints" / "last")
    for x, y in zip(convert.tree_leaves(last["trainable"]), convert.tree_leaves(module._final_state.trainable),
                    strict=True):
        assert torch.equal(x, y.detach())


def test_multirun_makes_one_run_dir_per_job(env, tmp_path):
    """tests/test_sweeps.py's `-m` comma grid: one run dir per job."""
    results = train_entry.main(["-m", "experiment=synthetic", "trainer=cpu", *SMALL, "model.solver.lr=1e-5,1e-4",
                                "test=False"])
    assert sorted(results) == [0, 1] and not any("error" in r for r in results.values())
    base = tmp_path / "logs" / "train" / "runs" / "synthetic"
    assert (base / "0" / "checkpoints" / "last").is_dir() and (base / "1" / "checkpoints" / "last").is_dir()


def test_hparams_search_reports_best(env, tmp_path):
    """tests/test_sweeps.py's random search: each trial in its own run dir, a
    best reported."""
    out = train_entry.main(["experiment=synthetic", "trainer=cpu", *SMALL, "trainer.limit_val_batches=2",
                            "hparams_search=synthetic_random", "hparams_search.n_trials=2", "test=False"])
    assert [t["trial"] for t in out["trials"]] == [0, 1]
    assert out["best"] is not None and math.isfinite(out["best"]["value"])
    base = tmp_path / "logs" / "train" / "runs" / "synthetic"
    assert (base / "trial_0").is_dir() and (base / "trial_1").is_dir()


@pytest.mark.skipif(torch.cuda.is_available(), reason="this host has a card: the run would take it")
@pytest.mark.parametrize("main, argv", [
    (train_entry.main, ["experiment=synthetic"]),
    (train_entry.main, ["experiment=synthetic", "trainer=gpu"]),
    (eval_entry.main, ["data=synthetic", "model=anomaly_clip_synthetic", "ckpt_path=x"]),
])
def test_entries_without_a_card_raise_rather_than_run_on_the_cpu(env, main, argv):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


@pytest.mark.parametrize("main, argv, item", [
    (train_entry.main, ["experiment=synthetic", "trainer=dp_sim"], "item 8"),
    (train_entry.main, ["experiment=synthetic", "trainer=ddp_sim"], "item 8"),
    (train_entry.main, ["experiment=synthetic", "trainer=ddp"], "item 8"),
    (train_entry.main, ["experiment=synthetic", "trainer=cpu", "trainer.devices=2"], "item 8"),
    (eval_entry.main, ["data=synthetic", "model=anomaly_clip_synthetic", "trainer=ddp", "ckpt_path=x"], "item 8"),
    (eval_entry.main, ["artifact=/tmp/art", "data=synthetic", "trainer=ddp"], "item 8"),
])
def test_unported_entry_options_raise(env, main, argv, item):
    """The options that more than one device needs, refused until ROADMAP.md
    section 1, item 8 landed, now resolve to ranks: the CPU ones to two spawned
    CPU ranks (the spawn recorded, not run: tests/test_torch_multiprocess_fit.py
    runs one), ``trainer=ddp`` to every card, which raises here, where torch
    sees none, as any run on the card does."""
    spawned = []
    env.setattr(train_entry, "run_ranks", lambda *a: spawned.append(a) or {})
    if "trainer=ddp" in argv:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
        assert not spawned
        return
    main(argv)
    assert len(spawned) == 1, item
    entry, args, n_ranks, device = spawned[0]
    assert (entry, n_ranks, device) == ("anomalyclip_tpu_torch.train_entry:_rank_run", 2, "cpu")
    assert args == argv


def test_world_size_above_one_raises(env):
    """``WORLD_SIZE`` > 1 joins the group it describes (``env://``): without
    ``MASTER_ADDR`` there is none to join, and the failed init raises rather
    than running alone."""
    env.setenv("WORLD_SIZE", "2")
    env.setenv("RANK", "0")
    env.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        train_entry.main(["experiment=synthetic", "trainer=cpu"])
    assert not torch.distributed.is_initialized()


def test_the_device_choice(env):
    def choose(*argv):
        return train_entry.choose_device(list(argv), compose(default_config_dir(), "train", list(argv)))

    assert choose("experiment=synthetic", "trainer=cpu") == "cpu"
    assert choose("experiment=synthetic", "trainer.accelerator=cpu") == "cpu"
    # a composed accelerator: cpu (the debug bundles)
    assert choose("experiment=synthetic", "debug=default") == "cpu"
    if torch.cuda.is_available():
        assert choose("experiment=ucfcrime") == "cuda"


def test_eval_entry_needs_a_checkpoint(env):
    with pytest.raises(SystemExit, match="ckpt_path"):
        eval_entry.main(["data=synthetic", "model=anomaly_clip_synthetic", "trainer=cpu"])


# ---------------------------------------------------------------------------
# a Lightning .ckpt built here
# ---------------------------------------------------------------------------

# width 64 gives one head, the heads config_from_state_dict infers; embed_dim
# 64 is the synthetic data's feature width (the session's tiny CLIP)
CKPT_CLIP = CLIPConfig(embed_dim=64, image_resolution=32, vision_layers=2, vision_width=64, vision_patch_size=16,
                       vocab_size=49408, transformer_width=64, transformer_heads=1, transformer_layers=2)


def _lightning_state(trainable_shapes: dict, clip_cfg: CLIPConfig = CKPT_CLIP) -> dict:
    """A reference Lightning ``state_dict``: the CLIP (``clip_cfg``) split as
    AnomalyCLIP splits it, the prompt context, the selector's BN state and the
    lucidrains temporal model (tests/helpers/axial_torch.py, the package's key
    layout)."""
    axial = _load_by_path("_test_torch_entry_axial", ROOT / "tests" / "helpers" / "axial_torch.py")
    gen = torch.Generator().manual_seed(3)
    clip_sd = clip_convert.state_dict_from_params(init_clip_params(gen, clip_cfg))
    state = {}
    for k, v in clip_sd.items():
        if k.startswith("visual."):
            state["net.image_encoder." + k[len("visual."):]] = v
        elif k.startswith(("transformer.", "ln_final.")) or k in ("positional_embedding", "text_projection"):
            state["net.text_encoder." + k] = v
        elif k == "token_embedding.weight":
            state["net.token_embedding.weight"] = v
        elif k == "logit_scale":
            state["net.selector_model.logit_scale"] = v
    n_cls = trainable_shapes["prompt_ctx"][0]
    state["net.prompt_learner.ctx"] = 0.02 * torch.randn(trainable_shapes["prompt_ctx"], generator=gen)
    state["net.prompt_learner.token_prefix"] = torch.randn(n_cls, 1, 64, generator=gen)
    state["net.selector_model.bn_layer.running_mean"] = torch.randn(n_cls - 1, generator=gen)
    state["net.selector_model.bn_layer.running_var"] = torch.rand(n_cls - 1, generator=gen) + 0.5
    state["net.selector_model.bn_layer.num_batches_tracked"] = torch.tensor(42)
    torch.manual_seed(4)
    temporal = axial.TemporalModel(input_size=trainable_shapes["input"], emb_size=trainable_shapes["emb"],
                                   output_size=trainable_shapes["output"], heads=8, dim_heads=None, depth=1,
                                   num_segments=32, seg_length=16).float()
    for k, v in temporal.state_dict().items():
        state["net.temporal_model." + k] = v.detach().clone()
    return state


@pytest.fixture(scope="module")
def lightning_ckpt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lightning")
    mp = pytest.MonkeyPatch()
    mp.setenv("PROJECT_ROOT", str(ROOT))
    mp.setenv("SYNTHETIC_ROOT", str(tmp / "shapes"))
    try:
        cfg = to_dict(compose(default_config_dir(), "train", ["experiment=synthetic", "data.num_workers=0",
                                                               f"paths.log_dir={tmp / 'shapes_run'}"]))
        module = AnomalyCLIPTrainModule(cfg, device="cpu")
        trainable, _ = module.model.init_trainable(torch.Generator().manual_seed(0), module.frozen)
    finally:
        mp.undo()
    shapes = {"prompt_ctx": tuple(trainable["prompt_ctx"].shape),
              "input": trainable["temporal"]["projection"]["w"].shape[0],
              "emb": trainable["temporal"]["projection"]["w"].shape[1],
              "output": trainable["temporal"]["head"]["w"].shape[1]}
    state = _lightning_state(shapes)
    path = tmp / "released.ckpt"
    torch.save({"state_dict": state, "epoch": 7, "hyper_parameters": {"lr": 1e-5}}, str(path))
    return path, state


def test_lightning_conversion_equals_jax(lightning_ckpt):
    path, state = lightning_ckpt
    frozen, trainable, bn = convert_ckpt.convert_lightning_checkpoint(path)
    jfrozen, jtrainable, jbn = jconvert_ckpt.convert_lightning_checkpoint(path)
    assert_trees_equal(frozen, convert.params_from_jax(jfrozen, device="cpu"))
    assert_trees_equal(trainable, convert.params_from_jax(jtrainable, device="cpu"))
    assert torch.equal(bn.mean, torch.as_tensor(jbn.mean)) and torch.equal(bn.var, torch.as_tensor(jbn.var))
    assert dataclasses.asdict(convert_ckpt.converted_clip_config(path)) == dataclasses.asdict(
        jconvert_ckpt.converted_clip_config(path))
    assert convert_ckpt.converted_clip_config(path) == CKPT_CLIP
    assert torch.equal(trainable["prompt_ctx"], state["net.prompt_learner.ctx"])
    # fp16-stored checkpoints convert losslessly
    half = {k: v.half() if v.is_floating_point() else v for k, v in state.items()}
    sd = {k[len("net."):]: v.float().numpy() for k, v in half.items()}
    hfrozen, htrainable, _ = convert_ckpt.convert_lightning_checkpoint(sd)
    jhfrozen, jhtrainable, _ = jconvert_ckpt.convert_lightning_checkpoint(sd)
    assert_trees_equal(hfrozen, convert.params_from_jax(jhfrozen, device="cpu"))
    assert_trees_equal(htrainable, convert.params_from_jax(jhtrainable, device="cpu"))


def test_eval_entry_on_a_lightning_ckpt_matches_jax(env, tmp_path, lightning_ckpt):
    path, _ = lightning_ckpt
    argv = ["data=synthetic", "model=anomaly_clip_synthetic", f"ckpt_path={path}", "extras.print_config=False",
            "trainer.limit_test_batches=3", "data.num_workers=0"]
    env.setenv("SYNTHETIC_ROOT", str(tmp_path / "jax_data"))
    want = jeval_entry.main(argv + [f"paths.log_dir={tmp_path / 'jax'}"])
    env.setenv("SYNTHETIC_ROOT", str(tmp_path / "port_data"))
    got = eval_entry.main(argv + ["trainer=cpu", f"paths.log_dir={tmp_path / 'port'}"])
    np.testing.assert_allclose([got[k] for k in METRICS], [want[k] for k in METRICS], rtol=0, atol=1e-4)
    assert np.isfinite([got[k] for k in METRICS]).all()


def test_convert_ckpt_cli_writes_a_port_checkpoint(env, tmp_path, lightning_ckpt):
    path, _ = lightning_ckpt
    out = tmp_path / "converted"
    convert_ckpt.main([str(path), str(out)])
    restored = CheckpointManager(tmp_path).restore(out)
    _, trainable, bn = convert_ckpt.convert_lightning_checkpoint(path)
    assert restored["epoch"] == -1 and restored["step"] == 0
    assert_trees_equal(restored["trainable"], trainable)
    assert torch.equal(restored["bn_state"].mean, bn.mean)
    cfg = to_dict(compose(default_config_dir(), "eval", ["data=synthetic", "model=anomaly_clip_synthetic",
                                                         f"ckpt_path={out}", "data.num_workers=0"]))
    state = AnomalyCLIPTrainModule(cfg, device="cpu").load_state(out)
    assert_trees_equal(state.trainable, trainable)
    with pytest.raises(NotImplementedError, match="item 5"):
        AnomalyCLIPTrainModule(cfg, device="cpu").load_state(tmp_path)  # a directory without state.pt


# ---------------------------------------------------------------------------
# CLIP files
# ---------------------------------------------------------------------------


class _Node(torch.nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def _torchscript(sd: dict, path: Path) -> None:
    """A TorchScript archive whose ``state_dict()`` is ``sd``, as OpenAI's
    released files are."""
    root = _Node()
    for key, value in sd.items():
        *parts, leaf = key.split(".")
        node = root
        for part in parts:
            if not hasattr(node, part):
                node.add_module(part, _Node())
            node = getattr(node, part)
        node.register_parameter(leaf, torch.nn.Parameter(value, requires_grad=False))
    torch.jit.script(root).save(str(path))


@pytest.mark.parametrize("form", ["plain", "fp16", "torchscript"])
def test_clip_file_loads_as_the_jax_converter_does(tmp_path, form):
    params = init_clip_params(torch.Generator().manual_seed(1), CKPT_CLIP)
    sd = clip_convert.state_dict_from_params(params)
    if form == "fp16":
        sd = {k: v.half() for k, v in sd.items()}
    path = tmp_path / "clip.pt"
    if form == "torchscript":
        _torchscript(sd, path)
    else:
        torch.save(sd, path)
    got, cfg = clip_convert.load_torch_clip_checkpoint(path)
    want, jcfg = jclip_convert.load_torch_clip_checkpoint(path)
    assert_trees_equal(got, convert.params_from_jax(want, device="cpu"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg) and cfg == CKPT_CLIP
    if form != "fp16":
        assert_trees_equal(got, params)


def _shapes_of(sd_shapes: dict) -> dict:
    """Zero-size stand-ins of the given shapes (config_from_state_dict reads
    shapes only)."""
    return {k: np.broadcast_to(np.float32(0), shape) for k, shape in sd_shapes.items()}


def _resnet_shapes() -> dict:
    """The keys config_from_state_dict reads of RN50's state dict."""
    shapes = {"visual.attnpool.positional_embedding": (50, 2048), "visual.layer1.0.conv1.weight": (64, 64, 1, 1),
              "text_projection": (512, 1024), "positional_embedding": (77, 512),
              "token_embedding.weight": (49408, 512), "ln_final.weight": (512,)}
    for b, n in zip((1, 2, 3, 4), (3, 4, 6, 3)):
        for i in range(n):
            shapes[f"visual.layer{b}.{i}.conv2.weight"] = (1, 1, 3, 3)
    for i in range(12):
        shapes[f"transformer.resblocks.{i}.ln_1.weight"] = (512,)
    return shapes


@pytest.mark.parametrize("arch", ["vit_b16", "vit_b32", "vit_l14", "vit_l14_336", "rn50"])
def test_config_from_state_dict_on_every_arch(arch):
    chip_smoke = _load_by_path("_test_torch_entry_chip_smoke", ROOT / "chip_smoke.py")
    jcfg = getattr(JaxCLIPConfig, arch)()
    shapes = _resnet_shapes() if arch == "rn50" else chip_smoke.openai_clip_shapes(CLIPConfig(**dataclasses.asdict(jcfg)))
    sd = _shapes_of(shapes)
    got, want = clip_convert.config_from_state_dict(sd), jclip_convert.config_from_state_dict(sd)
    assert dataclasses.asdict(got) == dataclasses.asdict(want) == dataclasses.asdict(jcfg)


def test_chip_smoke_clip_file_is_vit_b16_in_openai_layout():
    """The OpenAI layout chip_smoke.py writes: ViT-B/16's config, and at two
    layers a tower the port converts as the JAX converter does (its values
    drawn the chip_smoke way, fp16)."""
    chip_smoke = _load_by_path("_test_torch_entry_chip_smoke", ROOT / "chip_smoke.py")
    shapes = chip_smoke.openai_clip_shapes(CLIPConfig.vit_b16())
    assert clip_convert.config_from_state_dict(_shapes_of(shapes)) == CLIPConfig.vit_b16()
    assert len(shapes) == 2 * 12 * 12 + 14
    small = dataclasses.replace(CLIPConfig.vit_b16(), vision_layers=1, transformer_layers=1)
    sd = {k: v.float().numpy() for k, v in chip_smoke.seeded_clip_state_dict(small, 0).items()}
    assert {k: v.shape for k, v in sd.items()} == {k: tuple(s) for k, s in chip_smoke.openai_clip_shapes(small).items()}
    got, cfg = clip_convert.torch_state_dict_to_params(sd)
    want, jcfg = jclip_convert.torch_state_dict_to_params(sd)
    assert_trees_equal(got, convert.params_from_jax(want, device="cpu"))
    assert cfg == small and dataclasses.asdict(jcfg) == dataclasses.asdict(small)
    back = clip_convert.state_dict_from_params(got)
    assert back.keys() == sd.keys() and all(np.array_equal(back[k].numpy(), sd[k]) for k in sd)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_registry_tables_equal_the_jax_ones():
    assert registry._MODELS == jregistry._MODELS
    assert registry.available_models() == jregistry.available_models()
    for arch in jregistry._MODELS:
        assert registry._checkpoint_filename(arch) == jregistry._checkpoint_filename(arch)
        assert registry._cache_candidates(arch) == jregistry._cache_candidates(arch)
    params, cfg = registry.resolve_clip("RN50", "random-full")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jregistry._ARCH_CONFIGS["RN50"]())
    assert cfg == CLIPConfig.rn50() and params["visual"]["attnpool"]["c_w"].shape == (2048, 1024)
    params, cfg = registry.resolve_clip("ViT-B/32", "random")
    assert cfg == CLIPConfig.tiny() and params["text"]["token_embedding"].shape == (49408, 64)


def test_resolve_clip_order(env, tmp_path):
    """explicit clip_ckpt_path, then CLIP_CKPT_PATH, then the cache under
    $HOME, each read as the JAX registry reads it."""
    files = {}
    for name, seed in (("explicit", 1), ("env", 2), ("cache", 3)):
        params = init_clip_params(torch.Generator().manual_seed(seed), CKPT_CLIP)
        files[name] = (tmp_path / f"{name}.pt", params)
        torch.save(clip_convert.state_dict_from_params(params), files[name][0])
    home = tmp_path / "home"
    (home / ".cache" / "clip").mkdir(parents=True)
    shutil.copy(files["cache"][0], home / ".cache" / "clip" / "ViT-B-16.pt")
    env.setenv("HOME", str(home))
    env.setenv("CLIP_CKPT_PATH", str(files["env"][0]))
    for explicit, expect in ((str(files["explicit"][0]), "explicit"), (None, "env"), (str(tmp_path / "no.pt"), "env")):
        got, _ = registry.resolve_clip("ViT-B/16", "pretrained", explicit)
        want, _ = jregistry.resolve_clip("ViT-B/16", "pretrained", explicit)
        assert_trees_equal(got, files[expect][1])
        assert_trees_equal(got, convert.params_from_jax(want, device="cpu"))
    env.delenv("CLIP_CKPT_PATH")
    got, _ = registry.resolve_clip("ViT-B/16", "pretrained")
    assert_trees_equal(got, files["cache"][1])


def test_resolve_clip_download_and_its_switch(env, tmp_path):
    calls = []

    def fake_download(arch, root=None, timeout=60):
        calls.append(arch)
        raise OSError("no egress in this test")

    env.setattr(registry, "download_clip", fake_download)
    env.setenv("HOME", str(tmp_path))
    env.delenv("ANOMALYCLIP_NO_DOWNLOAD")
    with pytest.raises(FileNotFoundError, match="no egress"):
        registry.resolve_clip("ViT-B/16", clip_init="pretrained")
    assert calls == ["ViT-B/16"]
    env.setenv("ANOMALYCLIP_NO_DOWNLOAD", "1")
    with pytest.raises(FileNotFoundError) as info:
        registry.resolve_clip("ViT-B/16", clip_init="pretrained")
    assert calls == ["ViT-B/16"] and "download attempt" not in str(info.value)


def test_download_clip_verifies_sha(env, tmp_path):
    payload = b"not actually a checkpoint"
    good = hashlib.sha256(payload).hexdigest()

    class Response(io.BytesIO):
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    env.setattr(urllib.request, "urlopen", lambda url, timeout=0: Response(payload))
    env.setitem(registry._MODELS, "FAKE", f"https://openaipublic.azureedge.net/clip/models/{'0' * 64}/FAKE.pt")
    with pytest.raises(RuntimeError, match="SHA256 mismatch"):
        registry.download_clip("FAKE", root=tmp_path)
    assert not list(tmp_path.glob("*.partial*"))
    env.setitem(registry._MODELS, "FAKE", f"https://openaipublic.azureedge.net/clip/models/{good}/FAKE.pt")
    target = registry.download_clip("FAKE", root=tmp_path)
    assert target.read_bytes() == payload and registry.sha256_file(target) == good
    env.setattr(urllib.request, "urlopen", lambda *a, **k: (_ for _ in ()).throw(AssertionError("re-downloaded")))
    assert registry.download_clip("FAKE", root=tmp_path) == target
    with pytest.raises(KeyError, match="no download URL"):
        registry.download_clip("NOPE", root=tmp_path)
