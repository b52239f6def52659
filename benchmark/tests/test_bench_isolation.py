"""Nothing the benchmark runs loads JAX or the JAX package; a run without a card fails and prints no result."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ["jax", "jaxlib", "flax", "metrics_tpu"]

_LOAD_ALL = r"""
import json, sys
from pathlib import Path
sys.path[:0] = [{root!r}, {bench!r}]
import run
from benchlib import cells, devtime, isolation, launch, readers, roofline, stats, trace, traffic
bench = Path({bench!r})
for group in ("configs", "drivers", "e2e", "layer_metrics"):
    for p in sorted((bench / group).glob("*.py")):
        cells.load_module(p)
for p in sorted((bench / "mixes").glob("*.json")):
    json.load(open(p))
for w in cells.load_benchmark()["workloads"]:
    c = cells.Cell(w["name"])
    c.builder(); c.driver()
import readings
sys.path.insert(0, str(bench / "tests"))
from conftest import run_tiny, tiny_cell
for name in ("criteo_ctr.binned_16m", "criteo_ctr.exact_16m", "div2k_sr.hr_b4"):
    assert run_tiny(tiny_cell(name), seconds=0.1)[0]["correct"]
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""

_LOAD_REFERENCES = r"""
import json, sys
from pathlib import Path
for p in sorted(Path({bench!r}, "configs").glob("*_reference.py")):
    import importlib.util
    spec = importlib.util.spec_from_file_location(p.stem, p)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _top_level_names(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT), bench=str(BENCH))],
                         capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_every_file_it_finds_and_a_run_load_no_jax():
    names = _top_level_names(_LOAD_ALL)
    assert "metrics_tpu_torch" in names  # the program, which the builders import, is allowed
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)


def test_the_references_load_nothing_of_the_program():
    names = _top_level_names(_LOAD_REFERENCES)
    assert "torch" in names
    assert not names & set(FORBIDDEN + ["metrics_tpu_torch"])


def test_forbidden_names_are_compared_whole():
    from benchlib.isolation import forbidden_modules

    saved = dict(sys.modules)
    try:
        sys.modules["metrics_tpu_torch_extra"] = sys
        sys.modules.pop("metrics_tpu", None)
        assert "metrics_tpu" not in forbidden_modules()
        sys.modules["metrics_tpu.fake"] = sys
        assert "metrics_tpu" in forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_that_builds_a_library_says_so(monkeypatch):
    import types

    from benchlib.isolation import built_libraries

    native = types.ModuleType("metrics_tpu_torch.ops._native")
    native.build_outcomes = {"binned_hist": "built", "ssim_window": "hit", "rle_codec": "refreshed"}
    monkeypatch.setitem(sys.modules, "metrics_tpu_torch.ops._native", native)
    assert built_libraries() == ["binned_hist", "rle_codec"]
    monkeypatch.delitem(sys.modules, "metrics_tpu_torch.ops._native")
    assert built_libraries() == []


def test_a_forbidden_module_on_another_rank_refuses_the_result():
    """Two gloo ranks stand in for the four NCCL ranks; JAX loaded on rank 1 alone is found all the same."""
    import bench_faults
    from conftest import run_tiny, tiny_cell

    import run

    sound, records = run_tiny(tiny_cell("criteo_ctr.exact_ddp4", ranks=2), seconds=0.2)
    assert sound["correct"] and run.forbidden_loaded(records) == {}
    _, records = run_tiny(tiny_cell("criteo_ctr.exact_ddp4", ranks=2), seconds=0.2,
                          prepare=bench_faults.jax_on_rank_1)
    assert [r["forbidden"] for r in records] == [[], ["jax"]]
    assert run.forbidden_loaded(records) == {1: ["jax"]}


def _cuda_here() -> bool:
    out = subprocess.run([sys.executable, "-c", "import torch; print(torch.cuda.is_available())"],
                         capture_output=True, text=True, timeout=120)
    return out.stdout.strip() == "True"


def test_a_run_without_a_card_fails_and_prints_no_result(tmp_path):
    if _cuda_here():
        import pytest

        pytest.skip("a card is present")
    env = dict(os.environ, TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "criteo_ctr.binned_16m", "--seed",
                          "3000000000", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT), env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_a_checkout_without_the_program_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "div2k_sr.hr_b4", "--seed", "1",
                          "--seconds", "1", "--trace", "1"], capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path), env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert out.returncode != 0 and out.stdout.strip() == ""
