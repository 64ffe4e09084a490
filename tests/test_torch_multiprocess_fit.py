"""Data-parallel training of the port over gloo ranks on the CPU, against the
JAX package's global-batch semantics and against one process.

- One training run of three steps (``fit_steps`` with ``build_train_step(...,
  dp=)``) on 2 and on 4 ranks from the golden tiny state, each rank holding its
  block of each half of ``trajectory_batches``' global batches, against the
  frozen ``steps/*`` of ``tests/golden/tiny_pipeline.npz`` (the JAX
  ``build_train_step`` on the global batch): each step's global loss (the mean
  of the ranks') at rtol 5e-4, the trainables with test_golden.py's two-tier
  check, the BN state at 1e-5 / 1e-6, the epoch means the global ones, and the
  ranks' trainables and BN state equal to the bit.
- ``train_entry.main`` with ``trainer=ddp_sim`` (two spawned CPU ranks over
  gloo) against ``trainer=cpu`` on the synthetic corpus: per-epoch losses at
  rtol 5e-4, validation and test metrics within 1e-4, the ncentroid of 2 ranks
  against one process's at rtol 1e-6, one writer of the checkpoints; the eval
  entry with ``trainer=ddp_sim`` on the one-process run's ``last`` within 1e-4
  of that run's own test.
- A SIGTERM delivered to one rank only: both ranks stop at the same step,
  raise ``TrainingPreempted`` and keep the last epoch boundary's checkpoint,
  with no hang.
- A one-rank group runs the data-parallel code (sync-BN, the cross-rank
  smoothness term, the gradient all-reduce, the gather) and gives the same bits
  as the run without a group: every step's loss, the trainables and the test
  metrics (chip_smoke.py phase 4k holds the same over NCCL on the card).
"""

from __future__ import annotations

import csv
import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from anomalyclip_tpu.utils.treeio import flatten_tree

ROOT = Path(__file__).resolve().parents[1]
HELPERS = Path(__file__).resolve().parent / "helpers"
_spec = importlib.util.spec_from_file_location("_test_torch_mp_fit_ranks", HELPERS / "torch_ranks.py")
ranks = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ranks)

GOLDEN = ROOT / "tests" / "golden"
# the golden fixture's settings (tests/test_golden.py:142-147)
OVERRIDES = ("model.net.select_idx_dropout_topk=0.0", "model.net.select_idx_dropout_bottomk=0.0",
             "model.net.emb_size=32", "data.num_workers=0")
METRICS = ("auc_roc", "auc_pr", "mean_mc_auroc", "mean_mc_aupr")
LOSS_NAMES = ("train/loss", "train/dir_abn_loss", "train/dir_nor_loss", "train/topk_abn_loss",
              "train/bottomk_abn_loss", "train/topk_nor_loss", "train/smooth_loss", "train/sparse_loss")


def _env(tmp: Path) -> dict:
    return {"PROJECT_ROOT": str(ROOT), "SYNTHETIC_ROOT": str(tmp / "synthetic"), "LOG_DIR": str(tmp / "logs"),
            "ANOMALYCLIP_NO_DOWNLOAD": "1"}


# ---------------------------------------------------------------------------
# three steps on 2 and 4 ranks against the golden trajectory
# ---------------------------------------------------------------------------

_STEPS = textwrap.dedent('''
    import dataclasses, importlib.util, sys
    from pathlib import Path
    import numpy as np
    import torch
    from anomalyclip_tpu_torch import convert
    from anomalyclip_tpu_torch.config import compose, default_config_dir, to_dict
    from anomalyclip_tpu_torch.models.anomaly_clip import AnomalyCLIP, AnomalyCLIPConfig
    from anomalyclip_tpu_torch.models.losses import LossConfig
    from anomalyclip_tpu_torch.parallel import mesh
    from anomalyclip_tpu_torch.train import module as tmod

    work, golden, helpers = map(Path, sys.argv[1:4])
    overrides = sys.argv[4:]
    assert mesh.init_distributed(backend="gloo")
    r, P = mesh.rank(), mesh.world_size()
    spec = importlib.util.spec_from_file_location("golden_inputs", helpers / "golden_inputs.py")
    gi = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gi)

    cfg = to_dict(compose(default_config_dir(), "train", ["experiment=synthetic", *overrides]))

    def fields(cls, mapping):
        names = {f.name for f in dataclasses.fields(cls)}
        return {k: v for k, v in mapping.items() if k in names}

    with np.load(golden / "tiny_state.npz") as f:
        flat = {k: f[k] for k in f.files}
    with np.load(golden / "tiny_pipeline.npz") as f:
        ncentroid = torch.from_numpy(f["ncentroid"])
    frozen, trainable, bn, clip_cfg = convert.state_from_flat(flat, device="cpu")
    model, frozen = AnomalyCLIP.build(AnomalyCLIPConfig(**fields(AnomalyCLIPConfig, cfg["model"]["net"])),
                                      frozen["clip"], clip_cfg)
    loss_cfg = LossConfig(**fields(LossConfig, cfg["model"]["loss"]))
    solver = dict(cfg["model"]["solver"], lr=1e-3)
    sched = dict(cfg["model"].get("scheduler") or {}, warmup_epochs=0)
    state = tmod.init_state(trainable, bn, solver, dict(cfg["model"].get("optimizer") or {}), sched,
                            steps_per_epoch=1000)
    data = cfg["data"]
    half, lh = 4, 4 // P
    rows = slice(r * lh, (r + 1) * lh)
    batches = [
        tmod.TrainBatch(feats[:half][rows], labels[:half][rows], feats[half:][rows], labels[half:][rows])
        for feats, labels in gi.trajectory_batches(int(data["num_classes"]), int(data["normal_id"]),
                                                   int(cfg["model"]["net"]["num_segments"]),
                                                   int(cfg["model"]["net"]["seg_length"]), clip_cfg.embed_dim)
    ]
    losses = []
    state, history = tmod.fit_steps(
        tmod.build_train_step(model, loss_cfg, dp=(r, P)), frozen, state, batches, ncentroid,
        torch.Generator(), epochs=1, steps_per_epoch=1000,
        on_step=lambda s, terms: losses.append(float(terms.total)), dp=(r, P))
    torch.save({"losses": losses, "history": history, "step": state.step,
                "trainable": convert.tree_to(state.trainable, "cpu"),
                "bn": [t.detach().cpu() for t in state.bn_state]}, work / f"rank{r}.pt")
''')


def _jax_layout(tree, key: str = ""):
    """A port tree -> numpy in the JAX package's layout (conv kernels HWIO)."""
    if isinstance(tree, dict):
        return {k: _jax_layout(v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax_layout(v) for v in tree]
    a = tree.detach().cpu().numpy()
    return a.transpose(2, 3, 1, 0) if key in ("conv1_w", "conv2_w") else a


@pytest.fixture(scope="module", params=[2, 4])
def stepped(request, tmp_path_factory):
    n = request.param
    work = tmp_path_factory.mktemp(f"steps{n}")
    ranks.run(_STEPS, n, work, args=[work, GOLDEN, HELPERS, *OVERRIDES], env=_env(work))
    with np.load(GOLDEN / "tiny_pipeline.npz") as f:
        golden = {k: f[k] for k in f.files}
    return n, [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(n)], golden


def test_dp_step_losses_match_the_global_batch(stepped):
    n, out, g = stepped
    assert all(o["step"] == 3 for o in out)
    losses = np.mean([o["losses"] for o in out], axis=0)  # the global loss: the mean of the ranks'
    np.testing.assert_allclose(losses, g["steps/losses"], rtol=5e-4, atol=1e-5)
    for o in out:  # the epoch's means are the global batch's, on every rank
        assert o["history"][0]["train/loss"] == pytest.approx(float(np.mean(losses)), rel=1e-6)


def test_dp_step_trainables_match_the_global_batch(stepped):
    n, out, g = stepped
    got = flatten_tree(_jax_layout(out[0]["trainable"]), "steps/after3")
    keys = [k for k in g if k.startswith("steps/after3/")]
    assert keys and set(keys) <= set(got)
    for key in keys:
        diff = np.abs(got[key] - g[key])
        np.testing.assert_array_less(diff.max(), 2 * 1e-3 * 3, err_msg=key)
        tight = diff <= 5e-5 + 1e-3 * np.abs(g[key])
        assert tight.mean() >= 0.999, (key, float(1 - tight.mean()))


def test_dp_step_bn_state_matches_the_global_batch(stepped):
    n, out, g = stepped
    for o in out:
        np.testing.assert_allclose(o["bn"][0].numpy(), g["steps/bn_mean"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(o["bn"][1].numpy(), g["steps/bn_var"], rtol=1e-5, atol=1e-6)


def test_dp_ranks_hold_the_same_bits(stepped):
    n, out, _ = stepped
    first = flatten_tree(_jax_layout(out[0]["trainable"]))
    for o in out[1:]:
        other = flatten_tree(_jax_layout(o["trainable"]))
        for key, value in first.items():
            np.testing.assert_array_equal(other[key], value, err_msg=key)
        for a, b in zip(o["bn"], out[0]["bn"]):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the entry point: trainer=ddp_sim against trainer=cpu
# ---------------------------------------------------------------------------

ENTRY_ARGS = ("experiment=synthetic", "model.net.select_idx_dropout_topk=0.0",
              "model.net.select_idx_dropout_bottomk=0.0", "data.num_workers=0", "model.net.emb_size=32")


def _without_plots(tmp: Path) -> Path:
    """A directory that shadows ``matplotlib`` and ``seaborn`` with modules
    that fail to import: put first on ``PYTHONPATH``, the entries' test pass
    writes ``metrics.json`` and skips the PNGs, as it does where neither is
    installed (importing both and plotting is about half of a run's time)."""
    shim = tmp / "without_plots"
    for name in ("matplotlib", "seaborn"):
        (shim / name).mkdir(parents=True, exist_ok=True)
        (shim / name / "__init__.py").write_text(f"raise ImportError('{name} is shadowed')\n")
    return shim


def _entry(tmp: Path, trainer: str, module: str = "train_entry", args=ENTRY_ARGS) -> subprocess.Popen:
    """The entry in a process of its own, two intra-op threads in all: one a
    rank under ``ddp_sim`` (its spawned ranks take ``OMP_NUM_THREADS``), two
    in one process. The ranks step in lockstep, so a rank with more threads
    than the CPUs a loaded test run leaves it waits at every parallel region
    for its slowest thread: on a host of 8 CPUs, four threads a rank took the
    ``ddp_sim`` entry from 6 s alone to 115 s beside six busy torch processes,
    one thread to 35 s."""
    path = os.pathsep.join([str(_without_plots(tmp)), str(ROOT)])
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1" if trainer == "ddp_sim" else "2",
               ANOMALYCLIP_DIST_TIMEOUT_S=str(ranks.COLLECTIVE_TIMEOUT_S), **_env(tmp))
    return ranks.started(subprocess.Popen([sys.executable, "-m", f"anomalyclip_tpu_torch.{module}", *args,
                                           f"trainer={trainer}"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True, start_new_session=True))


def _epoch_rows(run_dir: Path) -> dict:
    rows = list(csv.DictReader(open(run_dir / "csv" / "metrics.csv")))
    return {int(r["step"]): [float(r[k]) for k in LOSS_NAMES] for r in rows if r.get("train/loss")}


# each join's limit: a loaded test run has taken these entries past 110 s (with
# four threads a rank; see _entry)
ENTRY_TIMEOUT_S = 150


@pytest.fixture(scope="module")
def entries(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("entries")
    ranks.join([_entry(tmp / "ddp", "ddp_sim"), _entry(tmp / "one", "cpu")], timeout=ENTRY_TIMEOUT_S)
    runs = [tmp / name / "logs" / "train" / "runs" / "synthetic" for name in ("ddp", "one")]
    # the eval entry on the one-process run's last checkpoint, over two spawned ranks
    eval_args = ("data=synthetic", "model=anomaly_clip_synthetic", "data.num_workers=0", "seed=1024",
                 "model.net.emb_size=32", f"ckpt_path={runs[1] / 'checkpoints' / 'last'}")
    ranks.join([_entry(tmp / "eval", "ddp_sim", "eval_entry", eval_args)], timeout=ENTRY_TIMEOUT_S)
    return runs + [tmp / "eval" / "logs"]


def test_ddp_sim_entry_losses_match_one_process(entries):
    ddp, one = (_epoch_rows(d) for d in entries[:2])
    assert sorted(ddp) == sorted(one) == [0, 1]
    for epoch in (0, 1):
        np.testing.assert_allclose(ddp[epoch], one[epoch], rtol=5e-4, atol=1e-7)


def test_ddp_sim_entry_metrics_match_one_process(entries):
    ddp, one, _ = entries
    for name in ("metrics_0.json", "metrics_1.json", "metrics.json"):
        got, want = (json.load(open(d / name)) for d in (ddp, one))
        np.testing.assert_allclose([got[k] for k in METRICS], [want[k] for k in METRICS], rtol=0, atol=1e-4,
                                   err_msg=name)
    assert sorted(p.name for p in (ddp / "checkpoints").iterdir()) == ["epoch_000", "epoch_001", "last"]


def test_ncentroid_over_two_ranks_matches_one_process(entries):
    ddp, one, _ = entries
    np.testing.assert_allclose(np.load(ddp / "ncentroid.npy"), np.load(one / "ncentroid.npy"), rtol=1e-6, atol=0)


def test_ddp_sim_eval_entry_matches_the_runs_own_test(entries):
    _, one, evaluated = entries
    (metrics,) = list(evaluated.glob("eval/runs/*/metrics.json"))
    got, want = json.load(open(metrics)), json.load(open(one / "metrics.json"))
    np.testing.assert_allclose([got[k] for k in METRICS], [want[k] for k in METRICS], rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# SIGTERM on one rank
# ---------------------------------------------------------------------------

_PREEMPT = textwrap.dedent('''
    import os, signal, sys
    from pathlib import Path
    import torch
    from anomalyclip_tpu_torch.config import compose, default_config_dir, to_dict
    from anomalyclip_tpu_torch.parallel import mesh
    from anomalyclip_tpu_torch.train.module import AnomalyCLIPTrainModule, TrainingPreempted

    work = Path(sys.argv[1])
    assert mesh.init_distributed(backend="gloo")
    r = mesh.rank()
    cfg = to_dict(compose(default_config_dir(), "train", [
        "experiment=synthetic", "data.num_workers=0", "data.synthetic_num_normal=16",
        "data.synthetic_num_abnormal=16", "data.synthetic_min_frames=60", "data.synthetic_max_frames=90",
        "data.synthetic_num_test=2", "trainer.max_epochs=3", "+trainer.preempt_poll_every_n_steps=2",
        "model.net.emb_size=32"]))
    module = AnomalyCLIPTrainModule(cfg, device="cpu")
    build, taken = module._build_train_step, [0]

    def hooked_build():
        step = build()

        def counted(*args):
            out = step(*args)
            taken[0] += 1
            if r == 1 and taken[0] == 6:  # epoch 1's second step, on rank 1 alone
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        return counted

    module._build_train_step = hooked_build
    try:
        module.fit()
    except TrainingPreempted as exc:
        print(f"preempted after {taken[0]} steps: {exc}")
    else:
        raise SystemExit("not preempted")
''')


def test_sigterm_on_one_rank_stops_both_at_the_same_step(tmp_path):
    outs = ranks.run(_PREEMPT, 2, tmp_path, args=[tmp_path], env=_env(tmp_path))
    # four steps an epoch; the flag is polled before steps 0 and 2 of an epoch
    # and at its boundaries, so both stop before epoch 1's step 2
    for out in outs:
        assert "preempted after 6 steps" in out and "saved boundary: epoch 0" in out, out
    run_dir = tmp_path / "logs" / "train" / "runs" / "synthetic"
    assert sorted(p.name for p in (run_dir / "checkpoints").iterdir()) == ["epoch_000", "last"]
    assert torch.load(run_dir / "checkpoints" / "last" / "state.pt", weights_only=True)["epoch"] == 0


# ---------------------------------------------------------------------------
# a one-rank group: the same bits as no group
# ---------------------------------------------------------------------------

_ONE_RANK = textwrap.dedent('''
    import sys
    from pathlib import Path
    import torch
    from anomalyclip_tpu_torch.config import compose, default_config_dir, to_dict
    from anomalyclip_tpu_torch.parallel import mesh
    from anomalyclip_tpu_torch.train.module import AnomalyCLIPTrainModule

    work, grouped = Path(sys.argv[1]), sys.argv[2] == "group"
    if grouped:
        assert mesh.init_distributed(backend="gloo", world_size=1, rank=0, init_method=RENDEZVOUS)
    cfg = to_dict(compose(default_config_dir(), "train", [
        "experiment=synthetic", "data.num_workers=0", "model.net.emb_size=32",
        "model.net.select_idx_dropout_topk=0.0", "model.net.select_idx_dropout_bottomk=0.0",
        f"paths.output_dir={work / sys.argv[2]}"]))
    module = AnomalyCLIPTrainModule(cfg, device="cpu")
    assert (module.dp is not None) == grouped
    build, losses = module._build_train_step, []

    def recorded():
        step = build()

        def run(*args):
            out = step(*args)
            losses.append(float(out[2].total))
            return out

        return run

    module._build_train_step = recorded
    module.fit()
    test = module.test(state=module._final_state)
    torch.save({"losses": losses, "trainable": module._final_state.trainable,
                "bn": list(module._final_state.bn_state), "test": test}, work / f"{sys.argv[2]}.pt")
''')


def test_a_one_rank_group_gives_the_bits_of_no_group(tmp_path):
    env = _env(tmp_path)
    ranks.join(ranks.launch(_ONE_RANK, 1, tmp_path / "alone", args=[tmp_path, "alone"], env=env)
               + ranks.launch(_ONE_RANK, 1, tmp_path / "group", args=[tmp_path, "group"], env=env))
    alone, group = (torch.load(tmp_path / f"{name}.pt", weights_only=False) for name in ("alone", "group"))
    assert len(alone["losses"]) == 4 and alone["losses"] == group["losses"]
    for key, value in flatten_tree(_jax_layout(alone["trainable"])).items():
        np.testing.assert_array_equal(flatten_tree(_jax_layout(group["trainable"]))[key], value, err_msg=key)
    assert all(torch.equal(a, b) for a, b in zip(alone["bn"], group["bn"]))
    assert {k: alone["test"][k] for k in METRICS} == {k: group["test"][k] for k in METRICS}


# ---------------------------------------------------------------------------
# the ranks' threads, and what a killed rank leaves in the failure
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("omp, affinity, world, want", [("3", 8, 2, 3), ("", 8, 2, 4), ("", 8, 16, 1),
                                                          ("0", 6, 2, 3), ("x", 1, 2, 1)])
def test_cpu_ranks_take_omp_num_threads_else_their_share_of_the_affinity(monkeypatch, omp, affinity, world, want):
    from anomalyclip_tpu_torch.train_entry import cpu_rank_threads

    monkeypatch.setenv("OMP_NUM_THREADS", omp)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(affinity)), raising=False)
    monkeypatch.setattr(os, "cpu_count", lambda: 192)  # the host's count is not the process's
    assert cpu_rank_threads(world) == want


def test_a_killed_rank_leaves_its_output_and_its_time_in_the_failure(tmp_path):
    import time

    script = textwrap.dedent('''
        import sys, time
        from pathlib import Path
        print("reached the loop", flush=True)
        print("stderr before the kill", file=sys.stderr, flush=True)
        Path(sys.argv[1]).touch()
        time.sleep(600)
    ''')
    procs = ranks.launch(script, 1, tmp_path, args=[tmp_path / "ready"])
    for _ in range(600):  # until the rank has written both lines
        if (tmp_path / "ready").exists():
            break
        time.sleep(0.1)
    with pytest.raises(AssertionError) as exc:
        ranks.join(procs, timeout=1)
    text = str(exc.value)
    assert "rank 0 rc=-9 after" in text and "(timed out: 1 s)" in text
    assert "reached the loop" in text and "stderr before the kill" in text
