"""Tests of the benchmark itself, on the CPU at tiny sizes; those marked ``cuda`` need a card.

    python -m pytest benchmark/tests -q -p no:cacheprovider            # here
    python -m pytest benchmark/tests -q -p no:cacheprovider -m cuda    # on the card
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# tiny sizes at which the CPU runs a cell in seconds; the card runs the committed ones
TINY = {
    "criteo_ctr_eval": ({"units_per_pass": 6000}, {"units_per_update": 2500}),
    "div2k_sr_eval": ({"units_per_pass": 3, "height": 180, "width": 184}, {"units_per_update": 2}),
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; run on the card")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card only")
    return torch.device("cuda", 0)


def tiny_cell(name: str, ranks=None, root=None):
    """The cell ``name`` read from the repository (or ``root``), cut to TINY sizes."""
    from benchlib.cells import Cell

    cell = Cell(name) if root is None else Cell(name, root)
    config, mix = TINY[cell.config["name"]]
    cell.config.update(config)
    if cell.mix.get("units_per_update"):
        cell.mix.update(mix)
    if ranks is not None:
        cell.chips = ranks  # the world size follows the cell's chips; gloo ranks stand in for the cards
    return cell


def run_tiny(cell, seed=7, seconds=0.3, trace=False, prepare=None):
    """One run of ``cell`` on the CPU: (result line, records)."""
    import time

    import torch

    import run as run_mod
    from benchlib.launch import run_cell

    t0 = time.perf_counter()
    records = run_cell(cell, seed, seconds, trace, "cpu", t0, prepare=prepare)
    compared = cell.driver().judge(cell, seed, torch.device("cpu"), records)
    return run_mod.result_line(cell, trace, records, compared), records
