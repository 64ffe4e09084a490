"""Nothing a run loads has the top-level name of JAX, its libraries or the JAX
package (compared whole: the port's name begins with the JAX package's), and
the reference loads nothing of the port."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

from benchmark import run

REPO = Path(__file__).resolve().parents[2]
REFERENCE = REPO / "benchmark" / "reference"

DRIVE = """
import sys, time, torch
from pathlib import Path
from benchmark.tests.tiny import tiny_cell
from benchmark import control, run
from benchmark.cells import load_driver, load_metric, load_tower, ROOT
start = time.perf_counter()
for kind in ("clips", "train"):
    cell = tiny_cell(kind)
    run.execute(cell, 5, 0.2, False, torch.device("cpu"), lambda: time.perf_counter() - start)
    driver = load_driver(kind)
    for mode in driver.controls(cell):
        driver.reading(cell, 5, torch.device("cpu"), mode)
for folder, load in (("drivers", load_driver), ("towers", load_tower), ("metrics", load_metric)):
    for path in sorted((ROOT / folder).glob("*.py")):
        load(path.name[:-3])
print("loaded", ",".join(sorted({m.split(".")[0] for m in sys.modules})))
print("forbidden", ",".join(run.forbidden_modules()))
"""


def _python(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=600,
                         check=True).stdout
    return {line.split(" ", 1)[0]: line.split(" ", 1)[1] if " " in line else "" for line in out.splitlines()}


def test_a_run_loads_nothing_of_jax():
    seen = _python(DRIVE)
    loaded = set(seen["loaded"].split(","))
    assert "anomalyclip_tpu_torch" in loaded, "the run drove the port"
    assert not loaded & run.FORBIDDEN
    assert seen["forbidden"] == ""


def test_the_check_follows_the_metric_readers():
    """The check for forbidden modules runs once every metric reader has loaded."""
    source = (REPO / "benchmark" / "run.py").read_text()
    main = source[source.index("def main("):]
    assert main.index("result(cell, outcome") < main.index("forbidden_modules()") < main.index("json.dumps(line)")


def test_the_reference_loads_nothing_of_the_program():
    seen = _python("import sys\nimport benchmark.reference.clip, benchmark.reference.anomaly, "
                   "benchmark.reference.train, benchmark.reference.precision\n"
                   "print('loaded', ','.join(sorted({m.split('.')[0] for m in sys.modules})))")
    loaded = set(seen["loaded"].split(","))
    assert not {"anomalyclip_tpu_torch", "anomalyclip_tpu", "jax"} & loaded
    for path in REFERENCE.glob("*.py"):
        assert "anomalyclip" not in path.read_text().replace("AnomalyCLIP", ""), path


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "anomalyclip_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "anomalyclip_tpu.models", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["anomalyclip_tpu", "jax"]
