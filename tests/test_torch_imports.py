"""Importing every module of the port, or ``chip_smoke``, loads none of jax, yaml,
regex, cv2, PIL, optax, matplotlib, tensorflow, orbax, zstandard or
tensorstore, and nothing of the JAX package ``anomalyclip_tpu``: the machine
with the card has none of them (or, for jax and optax, the port must not rely
on them; matplotlib and tensorflow are imported where a plot or a TensorBoard
logger is made), and the port keeps its own copy of what it needs from the JAX
package, even from its modules that import no JAX. Reading an Orbax checkpoint
directory of the JAX package (tests/fixtures/orbax) loads none of them either:
the port decodes its OCDBT store and zstd chunks itself. Checked in a fresh
interpreter, since this test process has jax loaded already
(tests/conftest.py)."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# by exact module name: "anomalyclip_tpu" is a prefix of the port's own name
FORBIDDEN = ("jax", "yaml", "regex", "cv2", "PIL", "optax", "matplotlib", "tensorflow", "orbax",
             "zstandard", "tensorstore", "anomalyclip_tpu")

_REPORT = """
print(json.dumps({"modules": names, "loaded": sorted(
    m for m in %r if m in sys.modules)}))
""" % (FORBIDDEN,)

_PROBE = """
import importlib, json, pkgutil, sys
import anomalyclip_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
""" + _REPORT

_SMOKE_PROBE = """
import json, sys
import chip_smoke
names = ["chip_smoke"]
""" + _REPORT


_READ_PROBE = """
import json, sys
from anomalyclip_tpu_torch.train import orbax_reader
from anomalyclip_tpu_torch.train.checkpoint import restore_state
names = []
for path in ("tests/fixtures/orbax/fit/checkpoints/epoch_000", "tests/fixtures/orbax/converted"):
    orbax_reader.read_tree(path)
    names.append(sorted(restore_state(path)))
""" + _REPORT


def _run(probe: str) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_yaml_regex_cv2_pil():
    report = _run(_PROBE)
    expected = {
        "anomalyclip_tpu_torch.config",
        "anomalyclip_tpu_torch.config.compose",
        "anomalyclip_tpu_torch.config.yaml_subset",
        "anomalyclip_tpu_torch.convert",
        "anomalyclip_tpu_torch.convert_ckpt",
        "anomalyclip_tpu_torch.eval_entry",
        "anomalyclip_tpu_torch.bench",
        "anomalyclip_tpu_torch.export",
        "anomalyclip_tpu_torch.extract_features",
        "anomalyclip_tpu_torch.graft_entry",
        "anomalyclip_tpu_torch.serve",
        "anomalyclip_tpu_torch.numerics",
        "anomalyclip_tpu_torch.train_entry",
        "anomalyclip_tpu_torch.predict",
        "anomalyclip_tpu_torch.data",
        "anomalyclip_tpu_torch.data.datamodule",
        "anomalyclip_tpu_torch.data.dataset",
        "anomalyclip_tpu_torch.data.loader",
        "anomalyclip_tpu_torch.data.records",
        "anomalyclip_tpu_torch.data.sampling",
        "anomalyclip_tpu_torch.data.sources",
        "anomalyclip_tpu_torch.data.synthetic",
        "anomalyclip_tpu_torch.data.transforms",
        "anomalyclip_tpu_torch.eval.artifacts",
        "anomalyclip_tpu_torch.eval.evaluator",
        "anomalyclip_tpu_torch.eval.grids",
        "anomalyclip_tpu_torch.eval.visualizer",
        "anomalyclip_tpu_torch.eval.metrics",
        "anomalyclip_tpu_torch.models.anomaly_clip",
        "anomalyclip_tpu_torch.models.clip.convert",
        "anomalyclip_tpu_torch.models.clip.model",
        "anomalyclip_tpu_torch.models.clip.quant",
        "anomalyclip_tpu_torch.models.clip.registry",
        "anomalyclip_tpu_torch.models.clip.resnet",
        "anomalyclip_tpu_torch.models.clip.tokenizer",
        "anomalyclip_tpu_torch.models.losses",
        "anomalyclip_tpu_torch.models.prompt_learner",
        "anomalyclip_tpu_torch.models.selector",
        "anomalyclip_tpu_torch.models.temporal",
        "anomalyclip_tpu_torch.ops.attention",
        "anomalyclip_tpu_torch.ops.attention_probes",
        "anomalyclip_tpu_torch.ops.build",
        "anomalyclip_tpu_torch.parallel",
        "anomalyclip_tpu_torch.parallel.mesh",
        "anomalyclip_tpu_torch.parallel.tp",
        "anomalyclip_tpu_torch.scripts._bench_models",
        "anomalyclip_tpu_torch.scripts._bench_util",
        "anomalyclip_tpu_torch.scripts.bench_artifact",
        "anomalyclip_tpu_torch.scripts.bench_attn_bwd",
        "anomalyclip_tpu_torch.scripts.bench_attn_l14",
        "anomalyclip_tpu_torch.scripts.bench_eval",
        "anomalyclip_tpu_torch.scripts.bench_latency",
        "anomalyclip_tpu_torch.scripts.bench_mha_tc",
        "anomalyclip_tpu_torch.scripts.bench_train_step",
        "anomalyclip_tpu_torch.scripts.gen_golden",
        "anomalyclip_tpu_torch.scripts.perf_sweep",
        "anomalyclip_tpu_torch.scripts.probe_bf16_drift",
        "anomalyclip_tpu_torch.scripts.probe_int8_drift",
        "anomalyclip_tpu_torch.scripts.probe_qkv_gb",
        "anomalyclip_tpu_torch.scripts.probe_qtile_vmem",
        "anomalyclip_tpu_torch.scripts.validate_pickgb",
        "anomalyclip_tpu_torch.scripts.validate_qtile_config",
        "anomalyclip_tpu_torch.scripts.verify_released_ckpts",
        "anomalyclip_tpu_torch.train.checkpoint",
        "anomalyclip_tpu_torch.train.module",
        "anomalyclip_tpu_torch.train.ocdbt",
        "anomalyclip_tpu_torch.train.optim",
        "anomalyclip_tpu_torch.train.orbax_reader",
        "anomalyclip_tpu_torch.train.tpe",
        "anomalyclip_tpu_torch.utils.extras",
        "anomalyclip_tpu_torch.utils.logging",
        "anomalyclip_tpu_torch.utils.trace",
        "anomalyclip_tpu_torch.utils.treeio",
        "anomalyclip_tpu_torch.utils.zstd",
    }
    assert expected <= set(report["modules"])
    assert report["loaded"] == [], report["loaded"]


def test_chip_smoke_imports_no_jax_and_nothing_of_the_jax_package():
    report = _run(_SMOKE_PROBE)
    assert report["loaded"] == [], report["loaded"]


def test_reading_an_orbax_checkpoint_loads_no_jax_orbax_or_zstd_package():
    report = _run(_READ_PROBE)
    assert report["modules"] == [["bn_state", "count", "epoch", "optimizer", "step", "trainable"]] * 2
    assert report["loaded"] == [], report["loaded"]


def test_the_ports_data_copies_equal_the_jax_packages():
    """The copies under anomalyclip_tpu_torch/data hold what the JAX package's
    modules hold: fields, constants and results."""
    import numpy as np

    from anomalyclip_tpu.data import dataset, loader, sampling, transforms
    from anomalyclip_tpu_torch.data import dataset as tdataset
    from anomalyclip_tpu_torch.data import loader as tloader
    from anomalyclip_tpu_torch.data import sampling as tsampling
    from anomalyclip_tpu_torch.data import transforms as ttransforms

    assert tdataset.TestItem._fields == dataset.TestItem._fields
    assert tdataset.TestItem._field_defaults == dataset.TestItem._field_defaults
    assert tloader.TrainBatch._fields == loader.TrainBatch._fields
    np.testing.assert_array_equal(ttransforms.CLIP_MEAN, transforms.CLIP_MEAN)
    np.testing.assert_array_equal(ttransforms.CLIP_STD, transforms.CLIP_STD)
    for t_raw in (10, 45, 300, 700):
        ours = tsampling.test_start_indices(t_raw, 4, 4, 2)
        theirs = sampling.test_start_indices(t_raw, 4, 4, 2)
        np.testing.assert_array_equal(ours[0], theirs[0])
        assert ours[1] == theirs[1]
        np.testing.assert_array_equal(
            tsampling.gather_frame_indices(ours[0], 4, 2, t_raw),
            sampling.gather_frame_indices(theirs[0], 4, 2, t_raw),
        )
