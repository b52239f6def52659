"""Find a cell and everything it reads, by the names in ``BENCHMARK.json``.

A configuration is ``configs/<name>.json`` (its sizes); its ``builder`` names the ``configs/<builder>.py``
that makes its inputs, collection and reference (``<name>.py`` when it names none), and its ``driver`` names
``drivers/<driver>.py``. A traffic mix is ``mixes/<traffic>.json``; an end-to-end metric is ``e2e/<name>.py``
and a per-layer metric ``layer_metrics/<name>.py``. A cell runs one rank a chip. Adding any of them is adding
files and entries: nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """Import a file by path under a name made from its path (the names may hold dots)."""
    name = "bench_" + re.sub(r"[^0-9A-Za-z_]", "_", str(path.resolve().relative_to(path.resolve().parents[2])))
    mod = sys.modules.get(name)
    if mod is not None and getattr(mod, "__file__", None) == str(path):
        return mod
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: Dict[str, Any], cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


class Cell:
    """One entry of ``workloads`` with its configuration, mix, metrics and code, read from ``root``."""

    def __init__(self, name: str, root: Path = ROOT, spec: Optional[Dict[str, Any]] = None) -> None:
        self.root = Path(root)
        spec = spec if spec is not None else load_benchmark(self.root)
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload named {name!r} in BENCHMARK.json (have {sorted(cells)})")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        config_entry = {c["name"]: c for c in spec["configs"]}[self.entry["config"]]
        config_file = self.root / config_entry["file"]
        with open(config_file) as f:
            self.config: Dict[str, Any] = json.load(f)
        self.config_file = config_file
        self.bench_dir = config_file.parent.parent
        with open(self.bench_dir / "mixes" / f"{self.entry['traffic']}.json") as f:
            self.mix: Dict[str, Any] = json.load(f)
        self.end_to_end: List[Dict[str, Any]] = [m for m in spec["end_to_end"] if _applies(m, name)]
        self.per_layer: List[Dict[str, Any]] = [m for m in spec["per_layer"] if _applies(m, name)]

    @property
    def ranks(self) -> int:
        """One rank a chip: the world size is the cell's ``chips``."""
        return self.chips

    def builder(self) -> ModuleType:
        name = self.config.get("builder", self.config_file.stem)
        return load_module(self.config_file.parent / f"{name}.py")

    def driver(self) -> ModuleType:
        return load_module(self.bench_dir / "drivers" / f"{self.config['driver']}.py")

    def e2e_reader(self, metric: str) -> ModuleType:
        return load_module(self.bench_dir / "e2e" / f"{metric}.py")

    def layer_reader(self, metric: str) -> ModuleType:
        return load_module(self.bench_dir / "layer_metrics" / f"{metric}.py")

    def layer_needs(self) -> set:
        """What the cell's per-layer readers ask the traced run for (``profile``, ``observe``, ``sync_debug``)."""
        needs: set = set()
        for m in self.per_layer:
            needs |= set(getattr(self.layer_reader(m["name"]), "NEEDS", ()))
        return needs


def inventory(root: Path = ROOT) -> Dict[str, List[str]]:
    """Every configuration, mix, driver and metric file the benchmark holds, by kind."""
    bench = Path(root) / "benchmark"
    return {
        "configs": sorted(p.stem for p in (bench / "configs").glob("*.json")),
        "mixes": sorted(p.stem for p in (bench / "mixes").glob("*.json")),
        "drivers": sorted(p.stem for p in (bench / "drivers").glob("*.py")),
        "e2e": sorted(p.stem for p in (bench / "e2e").glob("*.py")),
        "layer_metrics": sorted(p.stem for p in (bench / "layer_metrics").glob("*.py")),
    }
