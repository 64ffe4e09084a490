"""The port's perf_sweep and bench_artifact with ``--device cpu``.

- ``perf_sweep``: both implementations of the attention encode the same frames
  at the tiny width, finite, equal on the CPU (where both run the plain
  version), and no times are printed; one combination that raises is printed
  as failed, the others still run, and the script exits 1; an encoding that
  disagrees past ``AGREE_TOL`` exits 1 too.
- ``bench_artifact``: the score graph of the exported artifact and
  ``GridScorer._score`` give the same scores (within ``SCORE_TOL``) at 1 and 2
  videos, held here again on the artifact the script writes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from anomalyclip_tpu_torch.scripts import bench_artifact, perf_sweep


def test_perf_sweep_on_the_cpu_encodes_alike_and_prints_no_times(capsys):
    result = perf_sweep.main(["--device", "cpu"])
    assert result == {"times": {("reference", 2): None, ("kernel", 2): None}, "gaps": {"kernel": 0.0}}
    out = capsys.readouterr().out
    assert "ms/iter" not in out and "fps" not in out
    assert out.count("encoded (2, 64), finite") == 2 and "(agree, limit 0.05)" in out


def test_perf_sweep_exits_one_when_a_combination_raises(monkeypatch, capsys):
    real = perf_sweep.attention_impl

    def failing(impl):
        if impl == "kernel":
            raise RuntimeError("the kernel did not launch")
        return real(impl)

    monkeypatch.setattr(perf_sweep, "attention_impl", failing)
    with pytest.raises(SystemExit) as exc:
        perf_sweep.main(["--device", "cpu", "--impls", "kernel,reference"])
    assert exc.value.code == 1
    out = capsys.readouterr().out
    # the failure is printed, and the sweep goes on past it
    assert "impl=kernel    batch=    2  FAILED: RuntimeError: the kernel did not launch" in out
    assert "impl=reference batch=    2  encoded (2, 64), finite" in out


def test_perf_sweep_exits_one_when_the_encodings_disagree(monkeypatch, capsys):
    real = perf_sweep.encode_image
    calls = []

    def shifted(*args, **kw):
        calls.append(1)
        out = real(*args, **kw)
        return out + 1.0 if len(calls) > 1 else out  # the second impl's encoding moves

    monkeypatch.setattr(perf_sweep, "encode_image", shifted)
    with pytest.raises(SystemExit) as exc:
        perf_sweep.main(["--device", "cpu"])
    assert exc.value.code == 1 and "DISAGREE" in capsys.readouterr().out


def test_bench_artifact_scores_equal_native(capsys, monkeypatch):
    loaded = []
    real_load = bench_artifact.ServingArtifact.load

    def load(path, device="cuda"):
        art = real_load(path, device=device)
        loaded.append(art)
        return art

    monkeypatch.setattr(bench_artifact.ServingArtifact, "load", staticmethod(load))
    results = bench_artifact.main(["--device", "cpu"])
    assert sorted(results) == [1, 2]
    for s, row in results.items():
        assert row["frames"] == s * 512 and row["bucket"] == s
        assert row["max_abs_diff"] <= bench_artifact.SCORE_TOL
        assert "native_ms" not in row
    out = capsys.readouterr().out
    assert out.count("artifact scores equal native's") == 2 and " ms" not in out
    # the loaded artifact scores through ServingArtifact.score as the script's call does
    (art,) = loaded
    grids = np.random.default_rng(1).standard_normal((1, 32, 16, art.meta["grid"]["feature_dim"]))
    _, scores = art.score(grids.astype(np.float32))
    with torch.no_grad(), art._precision():
        _, direct = art._score_graph(art._score_leaves, torch.from_numpy(grids.astype(np.float32)))
    np.testing.assert_array_equal(scores, direct.numpy())
