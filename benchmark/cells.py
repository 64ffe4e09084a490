"""A cell, found by name: its entry in ``BENCHMARK.json``, its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``), the
driver of the mix's kind (``drivers/<kind>.py``), the image tower its
configuration names (``towers/<tower>.py``), the per-layer metrics it reports
(``metrics/<metric>.py``) and the limits of its correctness check
(``limits/<workload>.json``). Nothing here names a cell, a kind or a tower:
a new one is new files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: List[str]
    per_layer: List[str]
    limits: Dict[str, float]

    @property
    def dtype(self) -> str:
        return self.config["compute_dtype"]


def _file(folder: str, name: str, suffix: str, what: str) -> Path:
    path = ROOT / folder / f"{name}{suffix}"
    if not path.is_file():
        raise KeyError(f"no {what} {name!r}: {path} is missing")
    return path


def load_module(folder: str, name: str, what: str):
    """``<folder>/<name>.py`` loaded once as a module of its own (a name may hold dots and dashes)."""
    path = _file(folder, name, ".py", what)
    key = f"benchmark.{folder}." + "".join(c if c.isalnum() else "_" for c in name)
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def load_benchmark(path: Path = BENCHMARK) -> dict:
    return json.loads(path.read_text())


def load_config(name: str) -> dict:
    return prepare_config(json.loads(_file("configs", name, ".json", "configuration").read_text()))


def prepare_config(cfg: dict) -> dict:
    """Derived entries: the prompts' token ids padded to the context length,
    and a labels file of the class names (the program reads its class names
    from one) at a fixed path under the temporary directory."""
    width = cfg["clip"]["context_length"]
    cfg["prompt_token_ids_padded"] = [ids + [0] * (width - len(ids)) for ids in cfg["prompt_token_ids"]]
    labels = Path(tempfile.gettempdir()) / "anomalyclip-benchmark" / f"{cfg['name']}-labels.csv"
    labels.parent.mkdir(parents=True, exist_ok=True)
    labels.write_text("id,name\n" + "".join(f"{i},{n}\n" for i, n in enumerate(cfg["classnames"])))
    cfg["labels_file"] = str(labels)
    return cfg


def load_mix(name: str) -> dict:
    """A mix's parameters; its ``kind`` names the driver that reads them."""
    mix = json.loads(_file("traffic", name, ".json", "traffic mix").read_text())
    _file("drivers", str(mix.get("kind")), ".py", f"driver for mix {name!r} of kind")
    return mix


def load_driver(kind: str):
    """The driver of a mix's kind: ``drivers/<kind>.py`` with ``run``, ``controls`` and ``reading``."""
    return load_module("drivers", kind, "driver of kind")


def load_tower(name: str):
    """An image tower: ``towers/<name>.py`` with its seeded weights, its plain
    reference encoder and its work from shapes."""
    return load_module("towers", name, "image tower")


def load_metric(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``'s ``read``."""
    return load_module("metrics", name, "per-layer metric").read


def load_limits(workload: str) -> Dict[str, float]:
    path = _file("limits", workload, ".json", "limits for workload")
    return {k: float(v["limit"]) for k, v in json.loads(path.read_text())["numbers"].items()}


def _covers(metric: dict, workload: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return True if metric.get("moves") is None else metric["moves"] in reported


def find_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = load_benchmark() if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have: {', '.join(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if entry["config"] not in configs:
        raise KeyError(f"workload {name!r} names configuration {entry['config']!r}, which has no entry")
    end_to_end = [m["name"] for m in bench["end_to_end"] if _covers(m, name, [])]
    per_layer = [m["name"] for m in bench["per_layer"] if _covers(m, name, end_to_end)]
    return Cell(name=name, config=load_config(entry["config"]), mix=load_mix(entry["traffic"]),
                chips=int(entry["chips"]), end_to_end=end_to_end, per_layer=per_layer,
                limits=load_limits(name))
