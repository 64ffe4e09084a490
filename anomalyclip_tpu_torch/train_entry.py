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
``trainer: tpu``) run on the card, and raise when torch sees none. More than
one process or device (``trainer=dp_sim``, ``ddp_sim``, ``ddp``, a
``trainer.devices`` count above 1, ``WORLD_SIZE`` > 1) is not ported yet.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Any, Dict, List

_MULTI_DEVICE = ("trainer=dp_sim", "trainer=ddp_sim", "trainer=ddp")


def _not_ported_multi(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: more than one process or device is not ported yet (ROADMAP.md section 1, item 8)"
    )


def _refuse_multi_process(argv: List[str]) -> None:
    """The counterpart of the JAX package's platform pre-pass and multi-host
    bring-up: what would need more than one process or device raises."""
    for a in argv:
        if a in _MULTI_DEVICE:
            raise _not_ported_multi(a)
    if int(os.environ.get("WORLD_SIZE", "1") or 1) > 1:
        raise _not_ported_multi(f"WORLD_SIZE={os.environ['WORLD_SIZE']}")


def choose_device(argv: List[str], cfg: Any) -> str:
    """``"cpu"`` when the command line or the composed trainer asks for the
    CPU, else ``"cuda"``, which must be there."""
    trainer = cfg.get("trainer") or {}
    devices = trainer.get("devices")
    if isinstance(devices, int) and not isinstance(devices, bool) and devices > 1:
        raise _not_ported_multi(f"trainer.devices={devices}")
    if any(a in ("trainer=cpu", "trainer.accelerator=cpu") for a in argv) or trainer.get("accelerator") == "cpu":
        return "cpu"
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            f"trainer.accelerator={trainer.get('accelerator')!r} runs on the card, and torch sees "
            "no CUDA device; pass trainer=cpu to run on the CPU"
        )
    return "cuda"


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
    _refuse_multi_process(argv)

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
    from anomalyclip_tpu_torch.config import compose, default_config_dir, to_dict
    from anomalyclip_tpu_torch.utils.logging import get_logger

    log = get_logger("train")
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

    from anomalyclip_tpu_torch.utils.extras import apply_extras

    apply_extras(cfg)

    if cfg.get("seed") is not None:
        import random

        import numpy as np

        random.seed(int(cfg.seed))
        np.random.seed(int(cfg.seed))

    from anomalyclip_tpu_torch.train.module import AnomalyCLIPTrainModule

    module = AnomalyCLIPTrainModule(to_dict(cfg), device=device)

    metrics: dict = {}
    if cfg.get("train", True):
        metrics = module.fit()

    if cfg.get("test", True) and not cfg.get("trainer", {}).get("fast_dev_run"):
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
