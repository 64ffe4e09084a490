#!/usr/bin/env python
"""Training entry point of the port: the counterpart of
anomalyclip_tpu/train_entry.py, with the reference's invocation contract
(reference: src/train.py:115-130, README.md:80-96):

    python -m anomalyclip_tpu_torch.train_entry experiment=ucfcrime \\
        model.net.clip_ckpt_path=/path/to/ViT-B-16.pt
    python -m anomalyclip_tpu_torch.train_entry experiment=xdviolence trainer.max_epochs=10
    python -m anomalyclip_tpu_torch.train_entry -m experiment=synthetic trainer=cpu \\
        model.solver.lr=1e-5,1e-4
    python -m anomalyclip_tpu_torch.train_entry experiment=ucfcrime hparams_search=ucfcrime_tpe

Composes the JAX package's config tree (``anomalyclip_tpu/configs``, read by
path with the port's own YAML reader) with CLI overrides, trains, then tests
the final weights when ``test: True``.

The device: ``trainer=cpu``, ``trainer.accelerator=cpu`` or a composed
``accelerator: cpu`` (``debug/default.yaml``) run on the CPU; ``auto``,
``gpu`` and ``tpu`` (the published ``experiment/ucfcrime.yaml`` selects
``trainer: tpu``) run on the card, and raise when torch sees none.

More than one device (parallel/mesh.py): ``trainer.devices=N`` (or ``auto``,
as ``trainer=ddp`` composes it: every visible card) spawns N ranks of
``torch.distributed`` with ``torch.multiprocessing`` (the counterpart of
Lightning's ddp_spawn), each on its own card over NCCL, or on the CPU over
gloo (``trainer=dp_sim`` / ``ddp_sim``: two CPU ranks). N shrinks to the
largest count that divides the half-batch. The kernels are built once, before
the spawn; the ranks load them. A process already in a group, or started with
``WORLD_SIZE`` (``torchrun``), runs as its rank and spawns nothing.
``trainer.model_parallel=mp`` encodes frames through the tensor-parallel tower
over model groups of ``mp`` ranks.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional


def choose_device(argv: List[str], cfg: Any) -> str:
    """``"cpu"`` when the command line or the composed trainer asks for the
    CPU, else ``"cuda"``, which must be there."""
    trainer = cfg.get("trainer") or {}
    if any(a in ("trainer=cpu", "trainer.accelerator=cpu") for a in argv) or trainer.get("accelerator") == "cpu":
        return "cpu"
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            f"trainer.accelerator={trainer.get('accelerator')!r} runs on the card, and torch sees "
            "no CUDA device; pass trainer=cpu to run on the CPU"
        )
    return "cuda"


def rank_count(cfg: Any, device: str) -> int:
    """How many ranks a run of ``cfg`` spawns: ``trainer.devices`` (``auto``:
    every visible card, one process on the CPU), shrunk to the largest count
    that divides the half-batch (``usable_data_devices``); 1 in a process that
    is a rank already (a group, or ``WORLD_SIZE`` in the environment)."""
    import torch

    from anomalyclip_tpu_torch.parallel.mesh import GLOO_ROUTE, distributed, usable_data_devices

    if distributed() or int(os.environ.get("WORLD_SIZE", "1") or 1) > 1:
        return 1
    trainer = cfg.get("trainer") or {}
    devices = trainer.get("devices")
    cards = torch.cuda.device_count() if device == "cuda" else 0
    if devices in (None, "auto"):
        n = cards if device == "cuda" else 1
    else:
        n = int(devices)
    if device == "cuda" and n > cards:
        raise RuntimeError(f"trainer.devices={n}: torch sees {cards} card(s); {GLOO_ROUTE}")
    half = int((cfg.get("data") or {}).get("batch_size") or 2) // 2
    return len(usable_data_devices(half, list(range(max(n, 1)))))


def cpu_rank_threads(world: int) -> int:
    """The intra-op threads of one of ``world`` ranks spawned on this host's
    CPU: ``OMP_NUM_THREADS`` where the caller set it (each rank takes what a
    process started alone would), else the CPUs this process may run on (its
    affinity, not the host's count) shared among the ranks. Ranks step in
    lockstep through their collectives, so more threads than CPUs stall every
    rank behind the slowest thread of any parallel region."""
    wanted = os.environ.get("OMP_NUM_THREADS", "")
    if wanted.isdigit() and int(wanted) > 0:
        return int(wanted)
    usable = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else (os.cpu_count() or 1)
    return max(1, usable // world)


def _rank_main(local: int, entry: str, argv: List[str], world: int, init_method: str, device: str,
               backend: Optional[str], result: str) -> None:
    """One spawned rank: join the group, run ``entry`` ("module:function") on
    ``argv``, and on rank 0 write its return value to ``result``. On cards,
    ``LOCAL_RANK`` is the rank's card: its own under NCCL, one the ranks share
    (rank modulo the cards) under a named gloo."""
    import importlib
    import pickle

    import torch
    import torch.distributed as dist

    from anomalyclip_tpu_torch.parallel.mesh import init_distributed, log_stage

    card = local % torch.cuda.device_count() if device == "cuda" else local
    os.environ.update(RANK=str(local), WORLD_SIZE=str(world), LOCAL_RANK=str(card),
                      LOCAL_WORLD_SIZE=str(world))
    if device == "cpu":
        torch.set_num_threads(cpu_rank_threads(world))
    log_stage(f"spawned; rendezvous at {init_method}")
    init_distributed(backend, device=device, init_method=init_method)
    log_stage(f"joined the {dist.get_backend()} group")
    try:
        module, name = entry.split(":")
        out = getattr(importlib.import_module(module), name)(argv)
        log_stage(f"{name} returned")
        if local == 0:
            with open(result, "wb") as f:
                pickle.dump(out, f)
            log_stage("result written")
    finally:
        dist.destroy_process_group()


def run_ranks(entry: str, argv: List[str], ranks: int, device: str, backend: Optional[str] = None) -> Any:
    """``entry`` ("module:function") on ``argv`` in ``ranks`` spawned ranks on
    ``device`` -> rank 0's return value. ``backend`` defaults to NCCL on cards
    (a card for each rank) and gloo on the CPU; ``backend="gloo"`` on cards
    lets the ranks share them. The kernels are built here first when the ranks
    run on cards; a rank that raises ends the others and raises here."""
    import pickle
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    if device == "cuda":
        from anomalyclip_tpu_torch.ops.build import build

        build()
    tmp = tempfile.mkdtemp(prefix="anomalyclip_ranks_")
    try:
        result = os.path.join(tmp, "result.pkl")
        mp.start_processes(_rank_main, nprocs=ranks, join=True, start_method="spawn",
                           args=(entry, argv, ranks, f"file://{tmp}/rendezvous", device, backend, result))
        with open(result, "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def as_ranks(entry: str, argv: List[str], cfg: Any, device: str,
             run: Callable[[], Any]) -> Any:
    """``run()`` in this process when it is the only rank or a rank already
    (joining the group ``WORLD_SIZE`` describes, if any); else ``entry`` on
    ``argv`` in the spawned ranks ``rank_count`` gives."""
    from anomalyclip_tpu_torch.parallel.mesh import init_distributed
    from anomalyclip_tpu_torch.utils.logging import get_logger

    ranks = rank_count(cfg, device)
    if ranks > 1:
        get_logger("train").info(f"spawning {ranks} ranks on the {device.upper()}")
        return run_ranks(entry, argv, ranks, device)
    init_distributed(device=device)
    return run()


def _expand_multirun(overrides):
    """Expand comma-valued overrides into the cartesian grid of single runs
    (reference: hydra -m sweeps, src/train.py:125-129; tests/test_sweeps.py).

    `model.solver.lr=1e-5,1e-4 data.batch_size=16,32` -> 4 override lists.
    Values containing [] or () are treated as literals, not sweep lists.
    """
    import itertools

    axes = []
    for ov in overrides:
        if (
            "=" in ov
            and "," in ov.split("=", 1)[1]
            and not any(c in ov.split("=", 1)[1] for c in "[]()")
        ):
            key, vals = ov.split("=", 1)
            axes.append([f"{key}={v}" for v in vals.split(",")])
        else:
            axes.append([ov])
    return [list(combo) for combo in itertools.product(*axes)]


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    os.environ.setdefault("PROJECT_ROOT", str(Path(__file__).resolve().parents[1]))

    if any(a.startswith("hparams_search=") and a != "hparams_search=null" for a in argv):
        # the hydra convention spells sweeps `-m hparams_search=...`; the flag
        # is meaningless to the sweeper itself but must not reach compose()
        return _hparams_search([a for a in argv if a not in ("-m", "--multirun")])

    if "-m" in argv or "--multirun" in argv:
        overrides = [a for a in argv if a not in ("-m", "--multirun")]
        jobs = _expand_multirun(overrides)
        from anomalyclip_tpu_torch.train.module import TrainingPreempted
        from anomalyclip_tpu_torch.utils.logging import get_logger

        log = get_logger("train")
        log.info(f"multirun: {len(jobs)} jobs")
        results = {}
        for i, job in enumerate(jobs):
            job = job + [f"exp_name_suffix=/{i}"]
            log.info(f"multirun job {i}: {job}")
            try:
                results[i] = _single_run(job)
            except TrainingPreempted:
                # the machine is going away: do not burn the SIGTERM grace
                # period launching the next (doomed) job
                log.error(f"multirun preempted during job {i}; stopping the sweep")
                raise
            except Exception as exc:  # one failed combo must not kill the sweep
                log.error(f"multirun job {i} failed: {exc!r}")
                results[i] = {"error": repr(exc)}
        return results

    return _single_run(argv)


def _hparams_search(argv) -> dict:
    """Sequential hyperparameter search driven by a hparams_search config group
    (reference contract: configs/hparams_search/mnist_optuna.yaml + the
    optimized_metric return, src/train.py:125-129 — the reference's own sweep
    config is a rotted template; this one actually optimizes a logged metric).

    Samples trial overrides from `hparams_search.space` (random, full grid, or
    TPE), runs each as a normal single run in its own run dir, and reports the
    best.
    """
    import itertools
    import math

    import numpy as np

    from anomalyclip_tpu_torch.config import compose, default_config_dir
    from anomalyclip_tpu_torch.utils.logging import get_logger

    log = get_logger("train")
    cfg = compose(default_config_dir(), "train", argv)
    hs = cfg.get("hparams_search")
    if not hs:
        raise SystemExit("hparams_search=<name> selected but group composed empty")
    optimized = cfg.get("optimized_metric")
    if not optimized:
        raise SystemExit("hparams_search requires optimized_metric in the config")
    space = dict(hs.get("space") or {})
    if not space:
        raise SystemExit("hparams_search.space is empty")
    direction = str(hs.get("direction", "max"))
    sampler = str(hs.get("sampler", "random"))
    rng = np.random.default_rng(int(hs.get("seed") or 0))

    def sample_random(spec):
        kind = spec.get("type", "choice")
        if kind == "choice":
            return spec["values"][int(rng.integers(len(spec["values"])))]
        if kind == "uniform":
            return float(rng.uniform(float(spec["low"]), float(spec["high"])))
        if kind == "loguniform":
            lo, hi = math.log(float(spec["low"])), math.log(float(spec["high"]))
            return float(math.exp(rng.uniform(lo, hi)))
        if kind == "int":
            return int(rng.integers(int(spec["low"]), int(spec["high"]) + 1))
        raise ValueError(f"unknown space type {kind!r} for hparams_search")

    n_trials = int(hs.get("n_trials", 8))
    if sampler == "grid":
        axes = []
        for key, spec in space.items():
            values = spec.get("values")
            if values is None:
                raise ValueError(f"grid sampler needs explicit values for {key}")
            axes.append([(key, v) for v in values])
        trials = [dict(combo) for combo in itertools.product(*axes)]
        n_trials = len(trials)
    elif sampler == "tpe":
        trials = None  # adaptive: sampled per-trial from the history below
    elif sampler == "random":
        trials = [
            {key: sample_random(spec) for key, spec in space.items()}
            for _ in range(n_trials)
        ]
    else:
        raise ValueError(f"unknown hparams_search.sampler {sampler!r}")

    log.info(f"hparams_search[{sampler}]: {n_trials} trials optimizing {optimized} ({direction})")
    from anomalyclip_tpu_torch.train.module import TrainingPreempted

    results = []
    tpe_history = []  # [(params, value)] of successful trials, for the TPE sampler
    for i in range(n_trials):
        if trials is not None:
            trial = trials[i]
        else:
            from anomalyclip_tpu_torch.train import tpe

            trial = tpe.suggest(
                space,
                tpe_history,
                rng,
                maximize=(direction == "max"),
                n_startup=int(hs.get("n_startup_trials", 4)),
                gamma=float(hs.get("gamma", 0.25)),
                sample_random=sample_random,
            )
        overrides = [f"{k}={v}" for k, v in trial.items()]
        job = argv + overrides + [f"exp_name_suffix=/trial_{i}"]
        log.info(f"trial {i}: {trial}")
        try:
            metrics = _single_run(job)
            value = metrics.get("optimized_metric_value")
        except TrainingPreempted:
            # preemption, not a bad combo: stop instead of starting doomed trials
            log.error(f"hparams search preempted during trial {i}; stopping")
            raise
        except Exception as exc:  # a failed trial must not kill the search
            log.error(f"trial {i} failed: {exc!r}")
            metrics, value = {"error": repr(exc)}, None
        # nan (e.g. a single-class val subset makes auroc undefined) must not
        # enter the TPE history or best-trial selection: max()/min() keep the
        # first element when every comparison with nan is False, so one nan
        # trial would be reported as the sweep best over real finite trials
        finite = value is not None and math.isfinite(float(value))
        if finite:
            tpe_history.append((trial, float(value)))
        results.append({"trial": i, "params": trial, "value": value})
    best = _best_trial(results, direction)
    if best is not None:
        log.info(
            f"hparams_search best: trial {best['trial']} {optimized}={best['value']:.4f} "
            f"params={best['params']}"
        )
    else:
        log.warning("hparams_search: no trial produced the optimized metric")
    return {"trials": results, "best": best}


def _best_trial(results, direction: str):
    """Best trial by finite value, or None. Trials whose value is None (failed
    run) or nan (undefined metric, e.g. a single-class val subset) are
    excluded — max()/min() keep the first element when every comparison with
    nan is False, so one nan trial would otherwise win over finite trials."""
    import math

    valid = [
        r for r in results
        if r["value"] is not None and math.isfinite(float(r["value"]))
    ]
    if not valid:
        return None
    pick = max if direction == "max" else min
    return pick(valid, key=lambda r: float(r["value"]))


def _single_run(argv) -> Dict[str, Any]:
    from anomalyclip_tpu_torch.config import compose, default_config_dir

    suffix = None
    kept = []
    for a in argv:
        if a.startswith("exp_name_suffix="):
            suffix = a.split("=", 1)[1]
        else:
            kept.append(a)
    argv = kept
    cfg = compose(default_config_dir(), "train", argv)
    if suffix:
        # re-compose with a per-job exp_name so each sweep job gets its own
        # run dir (${paths.output_dir} interpolates ${exp_name})
        cfg = compose(
            default_config_dir(),
            "train",
            argv + [f"exp_name={cfg.exp_name}{suffix}"],
        )
    if not cfg.get("data") or not cfg.get("model"):
        raise SystemExit(
            "No data/model configured. Run with an experiment bundle, e.g.\n"
            "  python -m anomalyclip_tpu_torch.train_entry experiment=ucfcrime\n"
            "or pass data=<name> model=<name> explicitly."
        )

    device = choose_device(argv, cfg)
    return as_ranks("anomalyclip_tpu_torch.train_entry:_rank_run", argv + (
        [f"exp_name={cfg.exp_name}"] if suffix else []), cfg, device, lambda: _run(cfg, device))


def _rank_run(argv) -> Dict[str, Any]:
    """A spawned rank's run: the config composed from ``argv`` again."""
    from anomalyclip_tpu_torch.config import compose, default_config_dir

    cfg = compose(default_config_dir(), "train", argv)
    return _run(cfg, choose_device(argv, cfg))


def _run(cfg, device: str) -> Dict[str, Any]:
    """Train and test one composed config on ``device`` (this rank's, in a
    group) -> the metrics, with the sweeper's ``optimized_metric_value``."""
    from anomalyclip_tpu_torch.config import to_dict
    from anomalyclip_tpu_torch.utils.extras import apply_extras
    from anomalyclip_tpu_torch.utils.logging import get_logger

    log = get_logger("train")
    apply_extras(cfg)

    if cfg.get("seed") is not None:
        import random

        import numpy as np

        random.seed(int(cfg.seed))
        np.random.seed(int(cfg.seed))

    from anomalyclip_tpu_torch.parallel.mesh import log_stage
    from anomalyclip_tpu_torch.train.module import AnomalyCLIPTrainModule

    module = AnomalyCLIPTrainModule(to_dict(cfg), device=device)

    metrics: dict = {}
    if cfg.get("train", True):
        log_stage("fit")
        metrics = module.fit()

    if cfg.get("test", True) and not cfg.get("trainer", {}).get("fast_dev_run"):
        log_stage("test")
        state = getattr(module, "_final_state", None)
        if state is not None:
            metrics = module.test(state=state)
        else:
            last = module.ckpt.latest()
            if last is not None:
                metrics = module.test(ckpt_path=last)
            else:
                log.warning("no checkpoint available to test")

    # sweeper return contract (reference: src/train.py:125-129,
    # src/utils/utils.py:95-112 get_metric_value)
    optimized = cfg.get("optimized_metric")
    if optimized:
        if optimized not in metrics:
            raise KeyError(
                f"optimized_metric '{optimized}' not found in result metrics "
                f"{sorted(metrics)}"
            )
        value = metrics[optimized]
        log.info(f"optimized_metric {optimized}={value}")
        metrics = dict(metrics)
        metrics["optimized_metric_value"] = value
    return metrics


def cli() -> int:
    """Console-script entry: main() returns a metrics dict, which setuptools
    wrappers pass to sys.exit() — translate to a clean exit status."""
    main()
    return 0


if __name__ == "__main__":
    main()
