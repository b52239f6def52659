"""The plain references agree with the port on the CPU at tiny sizes, and their control does not."""

import torch
from conftest import run_tiny, tiny_cell

from benchlib import traffic


def _program_pass(cell, seed):
    b = cell.builder()
    data = b.make_data(cell.config, seed, torch.device("cpu"))
    batches = [b.take(data, s, e) for s, e in traffic.schedule(cell.config["units_per_pass"], cell.mix)]
    one = cell.driver()._Pass(b, b.make_collection(cell.config, cell.mix, torch.device("cpu")), batches, cell.mix)
    values, state, _ = one.run(False)
    return b, data, values, state


def test_criteo_binned_reference_matches_port():
    cell = tiny_cell("criteo_ctr.binned_16m")
    b, data, values, state = _program_pass(cell, 3)
    ref = b.reference(cell.config, cell.mix, data)
    assert torch.equal(state.cpu(), ref["counts"].cpu())
    for k in ("auroc", "ap", "ece"):
        assert abs(values[k] - ref["values"][k]) < 1e-6, k


def test_criteo_exact_reference_matches_port():
    cell = tiny_cell("criteo_ctr.exact_16m")
    b, data, values, state = _program_pass(cell, 4)
    assert state is None
    ref = b.reference(cell.config, cell.mix, data)
    for k in ("auroc", "ap", "ece"):
        assert abs(values[k] - ref["values"][k]) < 1e-6, k


def test_div2k_reference_matches_port():
    cell = tiny_cell("div2k_sr.hr_b4")
    b, data, values, _ = _program_pass(cell, 5)
    ref = b.reference(cell.config, cell.mix, data)
    assert abs(values["psnr"] - ref["values"]["psnr"]) < 1e-4
    assert abs(values["ssim"] - ref["values"]["ssim"]) < 1e-5
    assert abs(values["ms_ssim"] - ref["values"]["ms_ssim"]) < 1e-5


def test_reference_thresholds_are_the_float32_linspace_grid():
    from benchlib.cells import load_module

    ref = load_module(tiny_cell("criteo_ctr.binned_16m").config_file.with_name("criteo_ctr_eval_reference.py"))
    grid = ref.linspace_grid(200)
    assert grid.dtype.name == "float32" and grid[-1] == 1.0 and grid[0] == 0.0
    assert grid[7] == 7 * (1 / torch.tensor(199.0, dtype=torch.float32)).item()


def test_control_in_bfloat16_is_not_correct():
    """The reference computed in bfloat16, put in the program's place, fails some number of every cell."""
    for name in ("criteo_ctr.binned_16m", "criteo_ctr.exact_16m", "div2k_sr.hr_b4"):
        cell = tiny_cell(name)
        out, records = run_tiny(cell, seed=11)
        assert out["correct"], name
        b = cell.builder()
        ctl = b.reference(cell.config, cell.mix, b.make_data(cell.config, 11, torch.device("cpu")), torch.bfloat16)
        for rec in records:
            rec["values"] = [dict(ctl["values"]) for _ in rec["values"]]
            rec["states"] = [None if ctl["counts"] is None else ctl["counts"].tolist() for _ in rec["states"]]
        compared = cell.driver().judge(cell, 11, torch.device("cpu"), records)
        assert any(v is None or v > lim for _, v, lim in compared), (name, compared)
