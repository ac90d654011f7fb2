"""Find a cell's files by the names in `BENCHMARK.json`: the configuration
(`configs/<config>.json`), the traffic mix (`traffic/<traffic>.json`, whose
`driver` names the general generator in `drivers/<driver>.py`), the limits
of its comparison (`limits/<cell>.json`) and a reader for each per-layer
metric (`metrics/<metric>.py`)."""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(path: Path, name: Optional[str] = None) -> ModuleType:
    """The Python file `path` as a module (its name may hold dots)."""
    name = name or "benchmark._by_path." + re.sub(r"\W", "_", str(path.resolve()))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str) -> bool:
    """A metric without `workloads` is every cell's."""
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One workload of the spec and everything it names."""

    def __init__(self, spec: dict, name: str, bench: Path = BENCH):
        found = [w for w in spec["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"({', '.join(w['name'] for w in spec['workloads'])})")
        self.workload = found[0]
        self.name = name
        self.chips = int(self.workload["chips"])
        entry = [c for c in spec["configs"] if c["name"] == self.workload["config"]][0]
        self.config_name = entry["name"]
        self.conf = json.loads((bench.parent / entry["file"]).read_text())
        self.traffic_name = self.workload["traffic"]
        self.traffic = json.loads((bench / "traffic" / f"{self.traffic_name}.json").read_text())
        self.driver_path = bench / "drivers" / f"{self.traffic['driver']}.py"
        limits = bench / "limits" / f"{name}.json"
        self.limits: Dict[str, float] = (
            {k: float(v["limit"]) for k, v in json.loads(limits.read_text()).items()}
            if limits.exists() else {})
        self.end_to_end: List[dict] = [m for m in spec["end_to_end"] if applies(m, name)]
        self.per_layer: List[dict] = [m for m in spec["per_layer"] if applies(m, name)]
        self.bench = bench

    def driver(self) -> ModuleType:
        return load_module(self.driver_path)

    def metric_reader(self, metric: str) -> ModuleType:
        return load_module(self.bench / "metrics" / f"{metric}.py")
