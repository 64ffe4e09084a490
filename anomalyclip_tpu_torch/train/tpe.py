"""Tree-structured Parzen Estimator sampling for hparams_search: a copy of
anomalyclip_tpu/train/tpe.py (numpy only).

The reference ships an Optuna TPE sweeper config
(reference: configs/hparams_search/mnist_optuna.yaml, `sampler:
optuna.samplers.TPESampler` — an unadapted template there). This module is the
working analogue without the optuna dependency: the classic independent-TPE
rule (Bergstra et al., NeurIPS 2011) over the same search-space surface as the
random/grid samplers (choice / uniform / loguniform / int).

Per parameter, observed trials are split at the gamma-quantile of the
objective into "good" and "bad" sets; numeric parameters get a Parzen mixture
(one Gaussian per observation, bandwidth from neighbor spacing) in sampling
space (log for loguniform), categorical parameters get count-smoothed
weights. ``n_candidates`` draws from the good-set density l(x) are scored by
l(x)/g(x) and the argmax wins — exploration comes from the draw, exploitation
from the ratio.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


def _to_unit(value: float, spec: Dict) -> float:
    """Map a numeric value into the sampler's working space."""
    if spec.get("type") == "loguniform":
        return math.log(float(value))
    return float(value)


def _from_unit(x: float, spec: Dict):
    lo, hi = float(spec["low"]), float(spec["high"])
    if spec.get("type") == "loguniform":
        x = math.exp(x)
    x = min(max(x, lo), hi)
    if spec.get("type") == "int":
        return int(round(x))
    return float(x)


def _bounds(spec: Dict) -> Tuple[float, float]:
    lo, hi = float(spec["low"]), float(spec["high"])
    if spec.get("type") == "loguniform":
        return math.log(lo), math.log(hi)
    return lo, hi


def _parzen_logpdf(x: np.ndarray, centers: np.ndarray, spec: Dict) -> np.ndarray:
    """log density of a Parzen mixture with per-center bandwidths (capped to the
    range so a single far-off observation cannot flatten the mixture)."""
    lo, hi = _bounds(spec)
    span = max(hi - lo, 1e-12)
    if len(centers) == 0:
        return np.full(x.shape, -math.log(span))  # uniform prior
    order = np.argsort(centers)
    sorted_c = centers[order]
    # bandwidth: distance to the farther neighbor, bounded to [span/20, span]
    left = np.diff(sorted_c, prepend=lo)
    right = np.diff(sorted_c, append=hi)
    bw_sorted = np.clip(np.maximum(left, right), span / 20.0, span)
    bw = np.empty_like(bw_sorted)
    bw[order] = bw_sorted
    z = (x[:, None] - centers[None, :]) / bw[None, :]
    log_comp = -0.5 * z**2 - np.log(bw[None, :] * math.sqrt(2 * math.pi))
    return np.logaddexp.reduce(log_comp, axis=1) - math.log(len(centers))


def _split(history: Sequence[Tuple[Dict, float]], gamma: float, maximize: bool):
    values = np.asarray([v for _, v in history], dtype=np.float64)
    order = np.argsort(-values if maximize else values)
    n_good = max(1, int(math.ceil(gamma * len(history))))
    good_idx = set(order[:n_good].tolist())
    good = [history[i][0] for i in range(len(history)) if i in good_idx]
    bad = [history[i][0] for i in range(len(history)) if i not in good_idx]
    return good, bad


def suggest(
    space: Dict[str, Dict],
    history: Sequence[Tuple[Dict, float]],
    rng: np.random.Generator,
    *,
    maximize: bool = True,
    n_startup: int = 4,
    gamma: float = 0.25,
    n_candidates: int = 24,
    sample_random=None,
) -> Dict[str, Any]:
    """Next trial's parameters. ``history`` is [(params, objective), ...] of
    completed trials (failed trials excluded by the caller). Falls back to
    ``sample_random`` (or an internal uniform draw) for the startup phase."""

    def _uniform(spec):
        kind = spec.get("type", "choice")
        if kind == "choice":
            return spec["values"][int(rng.integers(len(spec["values"])))]
        lo, hi = _bounds(spec)
        return _from_unit(float(rng.uniform(lo, hi)), spec)

    draw = sample_random or _uniform
    if len(history) < n_startup:
        return {key: draw(spec) for key, spec in space.items()}

    good, bad = _split(history, gamma, maximize)
    params: Dict[str, Any] = {}
    for key, spec in space.items():
        kind = spec.get("type", "choice")
        if kind == "choice":
            values = list(spec["values"])
            good_counts = np.asarray(
                [1.0 + sum(1 for p in good if p.get(key) == v) for v in values]
            )
            bad_counts = np.asarray(
                [1.0 + sum(1 for p in bad if p.get(key) == v) for v in values]
            )
            pl = good_counts / good_counts.sum()
            pg = bad_counts / bad_counts.sum()
            cand = rng.choice(len(values), size=n_candidates, p=pl)
            best = cand[int(np.argmax(np.log(pl[cand]) - np.log(pg[cand])))]
            params[key] = values[int(best)]
        else:
            gc = np.asarray([_to_unit(p[key], spec) for p in good if key in p])
            bc = np.asarray([_to_unit(p[key], spec) for p in bad if key in p])
            lo, hi = _bounds(spec)
            if len(gc):
                centers = gc[rng.integers(len(gc), size=n_candidates)]
                span = max(hi - lo, 1e-12)
                cand = centers + rng.normal(0, span / 10.0, size=n_candidates)
                cand = np.clip(cand, lo, hi)
            else:
                cand = rng.uniform(lo, hi, size=n_candidates)
            score = _parzen_logpdf(cand, gc, spec) - _parzen_logpdf(cand, bc, spec)
            params[key] = _from_unit(float(cand[int(np.argmax(score))]), spec)
    return params


def minimize_demo(
    objective,
    space: Dict[str, Dict],
    n_trials: int,
    seed: int = 0,
    maximize: bool = False,
    **kw,
) -> List[Tuple[Dict, float]]:
    """Self-contained optimization loop for tests/demos: returns the history."""
    rng = np.random.default_rng(seed)
    history: List[Tuple[Dict, float]] = []
    for _ in range(n_trials):
        params = suggest(space, history, rng, maximize=maximize, **kw)
        history.append((params, float(objective(params))))
    return history
