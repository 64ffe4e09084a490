"""``trainer.profiler`` in the port's ``fit``, on the CPU.

The JAX package traces the whole fit on host zero into ``<run>/profile`` when
``trainer.profiler`` is ``"jax"`` (``configs/debug/profiler.yaml``) and stops
the trace in its ``finally`` (anomalyclip_tpu/train/module.py:615-639); any
other value traces nothing. The port writes a ``torch.profiler`` trace
(Chrome/Perfetto JSON) there instead:

- a profiled fit writes one parsable trace with the host's operators;
- a fit that raises mid-epoch, or that a SIGTERM stops, still writes it, and
  the exception goes on up;
- another value, or a rank other than 0, writes nothing and raises nothing;
- a trace that cannot be written fails the fit;
- ``debug=profiler`` through ``train_entry`` (on the CPU, as
  ``configs/debug/default.yaml`` says) writes the trace under the debug run;
- ``chip_smoke.py``'s reading of a trace (phase 4n) on a trace made here: the
  device's busy share, the idle gaps and the host operators over them, the
  steps, the port kernels' device events against their wrappers' launches.
"""

from __future__ import annotations

import importlib.util
import json
import signal
import sys
from collections import Counter
from pathlib import Path

import pytest
import torch

from anomalyclip_tpu.config.compose import to_dict
from anomalyclip_tpu_torch import train_entry
from anomalyclip_tpu_torch.train import module as tmod

ROOT = Path(__file__).resolve().parents[1]


def _load_by_path(name: str, path: Path):
    """A helper module loaded by its path: an installed package named
    ``tests`` may shadow this repository's."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


synthetic_cfg = _load_by_path("_test_torch_profiler_synthetic_run",
                              ROOT / "tests" / "helpers" / "synthetic_run.py").synthetic_cfg


def _port(root: Path, *overrides: str) -> tmod.AnomalyCLIPTrainModule:
    cfg = synthetic_cfg(root, "data.num_workers=0", "trainer.max_epochs=1", f"paths.output_dir={root / 'run'}",
                        *overrides)
    return tmod.AnomalyCLIPTrainModule(to_dict(cfg), device="cpu")


def _traces(module) -> list:
    return sorted((module.save_dir / tmod.TRACE_DIR).glob("*.pt.trace.json"))


def _events(path: Path) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _after_step(module, n: int, act) -> None:
    """``act()`` after the module's n-th training step."""
    build = module._build_train_step

    def build_hooked():
        step, taken = build(), [0]

        def hooked(*args):
            out = step(*args)
            taken[0] += 1
            if taken[0] == n:
                act()
            return out

        return hooked

    module._build_train_step = build_hooked


def test_a_profiled_fit_writes_a_trace_of_the_fit(tmp_path):
    module = _port(tmp_path, "trainer.profiler=jax")
    metrics = module.fit()
    assert "auc_roc" in metrics and module._final_state.step > 0
    (trace,) = _traces(module)
    ops = [e for e in _events(trace) if e.get("cat") == "cpu_op"]
    names = Counter(e["name"] for e in ops)
    # the whole fit: the text tower once a step and once a validation pass, the
    # temporal model once a step and once a video, both backwards once a step
    steps, videos = module._final_state.step, len(module.datamodule.val_dataloader())
    layers, depth = module.model.clip_cfg.transformer_layers, module.model.temporal_cfg.depth
    assert names["anomalyclip::fused_mha_qkv"] == layers * (steps + 1)
    assert names["anomalyclip::fused_mha_bld"] == 2 * depth * (steps + videos)
    assert names["GeneratedBackwardFor_anomalyclip_fused_mha_qkv_default"] == layers * steps
    assert names["GeneratedBackwardFor_anomalyclip_fused_mha_bld_default"] == 2 * depth * steps
    # the temporal model's convolutions and AdamW's update
    assert names["aten::convolution"] > 0 and names["aten::addcdiv_"] > 0
    assert all(e["dur"] >= 0 for e in ops)


def test_a_fit_that_raises_mid_epoch_writes_its_trace_and_reraises(tmp_path):
    module = _port(tmp_path, "trainer.profiler=jax")

    def fail():
        raise RuntimeError("step failed on purpose")

    _after_step(module, 2, fail)
    with pytest.raises(RuntimeError, match="step failed on purpose"):
        module.fit()
    (trace,) = _traces(module)
    assert any(e.get("cat") == "cpu_op" for e in _events(trace))
    assert "step failed on purpose" in (module.save_dir / "exception.log").read_text()


def test_a_fit_that_sigterm_stops_writes_its_trace(tmp_path):
    old = signal.getsignal(signal.SIGTERM)
    module = _port(tmp_path, "trainer.profiler=jax")
    _after_step(module, 1, lambda: signal.raise_signal(signal.SIGTERM))
    with pytest.raises(tmod.TrainingPreempted, match="before any epoch completed"):
        module.fit()
    assert signal.getsignal(signal.SIGTERM) is old
    (trace,) = _traces(module)
    assert any(e.get("cat") == "cpu_op" for e in _events(trace))


@pytest.mark.parametrize("value", ["null", "simple", "advanced"])
def test_another_value_traces_nothing(tmp_path, monkeypatch, value):
    """null is the default; "simple" and "advanced" are Lightning's profilers,
    which the JAX package ignores too."""
    module = _port(tmp_path, f"trainer.profiler={value}")
    started = []
    monkeypatch.setattr(tmod, "start_fit_trace", lambda device: started.append(device))
    monkeypatch.setattr(module, "_fit_body", lambda: {"auc_roc": 0.5})
    assert module.fit() == {"auc_roc": 0.5}
    assert not started and not (module.save_dir / tmod.TRACE_DIR).exists()


def test_a_rank_other_than_0_traces_nothing(tmp_path, monkeypatch):
    module = _port(tmp_path, "trainer.profiler=jax")
    monkeypatch.setattr(tmod, "is_host_zero", lambda: False)
    monkeypatch.setattr(module, "_fit_body", lambda: {"auc_roc": 0.5})
    assert module.fit() == {"auc_roc": 0.5}
    assert not (module.save_dir / tmod.TRACE_DIR).exists()


def test_a_trace_that_cannot_be_written_fails_the_fit(tmp_path, monkeypatch):
    module = _port(tmp_path, "trainer.profiler=jax")
    (module.save_dir / tmod.TRACE_DIR).write_text("a file where the trace's directory goes")
    monkeypatch.setattr(module, "_fit_body", lambda: {"auc_roc": 0.5})
    with pytest.raises(FileExistsError):
        module.fit()
    # the rest of the fit's clean-up ran all the same
    assert not module._in_fit and not module._sigterm_installed


def test_debug_profiler_through_the_train_entry(tmp_path, monkeypatch):
    """``debug=profiler``: one epoch, ``trainer.profiler: "jax"``, the CPU
    (``trainer.accelerator: cpu``) and anomaly detection from
    ``debug/default.yaml``, whose global switch is put back after."""
    monkeypatch.setenv("PROJECT_ROOT", str(ROOT))
    monkeypatch.setenv("SYNTHETIC_ROOT", str(tmp_path / "synthetic"))
    monkeypatch.setenv("ANOMALYCLIP_NO_DOWNLOAD", "1")
    try:
        metrics = train_entry.main(["experiment=synthetic", "debug=profiler", "trainer.limit_train_batches=1",
                                    "trainer.limit_val_batches=1", f"paths.log_dir={tmp_path / 'logs'}"])
    finally:
        torch.autograd.set_detect_anomaly(False)
    assert "auc_roc" in metrics
    run = tmp_path / "logs" / "debug" / "runs" / "synthetic"
    (trace,) = sorted((run / tmod.TRACE_DIR).glob("*.pt.trace.json"))
    assert sum(e.get("cat") == "cpu_op" for e in _events(trace)) > 0


def test_chip_smokes_trace_reading(tmp_path):
    chip_smoke = _load_by_path("_test_torch_profiler_chip_smoke", ROOT / "chip_smoke.py")
    events = []

    def span(cat, name, ts, dur, tid=1):
        events.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid})

    span("cpu_op", "aten::copy_", 0, 50)  # the trace's window: 0 to 600 us
    span("user_annotation", "Optimizer.zero_grad#AdamW.zero_grad", 60, 2)
    span("kernel", "void mha_tf32_kernel<64>(Heads, Heads, Heads, Heads, float*, int, int, int, int, float)", 70, 10)
    span("kernel", "void mha_bld_tf32_fwd_kernel<16>(Operand, Operand, Operand, float*, int, int, int, int, float)",
         80, 10)
    span("kernel", "void mha_bld_tf32_bwd_kernel<16>(Operand)", 95, 5)
    span("kernel", "void mha_whole_tf32_bwd_kernel(Operand)", 100, 10)
    span("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 110, 10)
    span("user_annotation", "Optimizer.step#AdamW.step", 110, 10)
    span("cuda_runtime", "cudaStreamSynchronize", 130, 100, tid=2)
    span("cpu_op", "aten::item", 140, 40)
    span("cpu_op", "aten::_local_scalar_dense", 140, 40)  # the same span as the one it is inside
    span("kernel", "ampere_sgemm_128x64_nn", 300, 100)
    span("cpu_op", "aten::mm", 590, 10)
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": [{"ph": "M", "name": "process_name"}, *events]}))

    got = chip_smoke.trace_summary(tmp_path / "t.json", "made here", "no card")
    assert got["busy_share"] == pytest.approx(145 / 600)  # 70-90, 95-120, 300-400
    assert [(round(ms * 1e3), name) for ms, _, name in got["gaps"]] == [
        (200, "aten::mm"), (180, "cudaStreamSynchronize"), (70, "aten::copy_"), (5, None)]
    assert got["gaps"][1][1] == pytest.approx(100 / 180) and got["gaps"][0][1] == pytest.approx(10 / 200)
    assert got["steps"] == [pytest.approx((0.06, 0.06, 45 / 60))]
    assert got["kernels"] == {"mha_tf32_kernel": 1, "mha_bld_tf32_fwd_kernel": 1, "mha_bld_tf32_bwd_kernel": 1,
                              "mha_whole_tf32_bwd_kernel": 1}
    chip_smoke.held_trace("made here", got["kernels"], {"fused_mha_qkv": 1, "mha_qkv_bwd": 1, "fused_mha_bld": 1,
                                                        "mha_bld_bwd": 1})
    with pytest.raises(AssertionError, match="device events"):
        chip_smoke.held_trace("made here", got["kernels"], {"fused_mha_qkv": 2, "mha_qkv_bwd": 1,
                                                            "fused_mha_bld": 1, "mha_bld_bwd": 1})
