"""Data as files: a new configuration, mix, cell and per-layer metric are found by name, with no edit to any
file the benchmark already holds."""

import hashlib
import json
import shutil
from pathlib import Path

from conftest import TINY, run_tiny

from benchlib.cells import Cell, inventory, load_benchmark

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_without_editing_existing_ones(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    bench = tmp_path / "benchmark"
    before = _digests(bench)

    # a configuration of a kind the benchmark has: its sizes, naming the Criteo builder and reference
    cfg = json.loads((bench / "configs" / "criteo_ctr_eval.json").read_text())
    cfg["name"] = "criteo_ctr_small"
    cfg.update(TINY["criteo_ctr_eval"][0])
    (bench / "configs" / "criteo_ctr_small.json").write_text(json.dumps(cfg))
    # a traffic mix
    (bench / "mixes" / "chunks_1k_binned.json").write_text(json.dumps(
        {"why": "small chunks", "units_per_update": 1000, "metric_options": {"thresholds": 50},
         "trace_passes": 1}))
    # a per-layer metric reading a new quantity
    (bench / "layer_metrics" / "runtime.passes_seen.small.py").write_text(
        "def measure(view):\n    return float(view.record['passes'])\n")
    # the cell and the entries in BENCHMARK.json
    spec = load_benchmark(tmp_path)
    spec["configs"].append({"name": "criteo_ctr_small", "source": "https://example.org", "reduced": [],
                            "file": "benchmark/configs/criteo_ctr_small.json", "why": "a smaller pass"})
    spec["workloads"].append({"name": "criteo_ctr.small", "config": "criteo_ctr_small",
                              "traffic": "chunks_1k_binned", "chips": 1, "why": "small"})
    spec["per_layer"].append({"name": "runtime.passes_seen.small", "unit": "passes", "better": "higher",
                              "source": "host_clock", "layer": "runtime", "moves": "rows_per_s",
                              "workloads": ["criteo_ctr.small"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and "criteo_ctr.binned_16m" in m["workloads"]:
            m["workloads"].append("criteo_ctr.small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    found = inventory(tmp_path)
    assert "criteo_ctr_small" in found["configs"] and "chunks_1k_binned" in found["mixes"]
    assert "runtime.passes_seen.small" in found["layer_metrics"]
    cell = Cell("criteo_ctr.small", tmp_path)
    assert cell.builder().__file__ == str(bench / "configs" / "criteo_ctr_eval.py")
    assert cell.config["units_per_pass"] == TINY["criteo_ctr_eval"][0]["units_per_pass"]
    assert [m["name"] for m in cell.per_layer][-1] == "runtime.passes_seen.small"
    traced, _ = run_tiny(cell, trace=True)
    assert traced["correct"] and traced["metrics"]["runtime.passes_seen.small"]["value"] >= 1
    timed, _ = run_tiny(cell)
    assert set(timed["metrics"]) == {"rows_per_s", "compute_ms_p95", "setup_s"}

    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_cell_runs_one_rank_a_chip():
    spec = load_benchmark(ROOT)
    for w in spec["workloads"]:
        cell = Cell(w["name"])
        assert cell.ranks == cell.chips == w["chips"]
        assert "ranks" not in cell.mix
