"""Importing every module of the port loads none of jax, yaml, regex, cv2 or PIL:
the machine with the card has none of them. Checked in a fresh interpreter,
since this test process has jax loaded already (tests/conftest.py)."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "yaml", "regex", "cv2", "PIL")

_PROBE = """
import importlib, json, pkgutil, sys
import anomalyclip_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"modules": names, "loaded": sorted(
    m for m in %r if m in sys.modules)}))
""" % (FORBIDDEN,)


def test_port_imports_no_jax_yaml_regex_cv2_pil():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    expected = {
        "anomalyclip_tpu_torch.convert",
        "anomalyclip_tpu_torch.numerics",
        "anomalyclip_tpu_torch.predict",
        "anomalyclip_tpu_torch.eval.evaluator",
        "anomalyclip_tpu_torch.models.anomaly_clip",
        "anomalyclip_tpu_torch.models.clip.model",
        "anomalyclip_tpu_torch.models.clip.tokenizer",
        "anomalyclip_tpu_torch.models.prompt_learner",
        "anomalyclip_tpu_torch.models.selector",
        "anomalyclip_tpu_torch.models.temporal",
        "anomalyclip_tpu_torch.ops.attention",
        "anomalyclip_tpu_torch.ops.build",
        "anomalyclip_tpu_torch.utils.treeio",
    }
    assert expected <= set(report["modules"])
    assert report["loaded"] == [], report["loaded"]
