"""On the card: the control (the reference in the program's place, its products in TF32,
the precision below the configurations' float32) comes out not correct, and the
program correct, at the published widths. Training also plants the fault of a step
on half of each batch. Run on the card with ``python3 -m pytest perfbench/tests -m cuda``."""

import math

import pytest

from perfbench import harness
from perfbench.tests.conftest import ROOT


def _fails(numbers: dict, limits: dict) -> bool:
    return any(not math.isfinite(numbers[k]) or numbers[k] > v for k, v in limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 34 + 5, 77])
def test_training_control_and_fault_fail(cuda_device, seed):
    cell = harness.load_cell(ROOT, "raite-train-f32")
    driver = harness.driver_of(cell)
    state = driver.setup(cell, seed, cuda_device)
    out = driver.check(state, ("program", "control", "half_batch"))
    assert not _fails(out["program"], cell.limits), out
    assert _fails(out["control"], cell.limits), out
    assert _fails(out["half_batch"], cell.limits), out


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 34 + 5, 77])
def test_fleet_control_fails(cuda_device, seed):
    cell = harness.load_cell(ROOT, "flagship-fleet16-f32")
    cell.traffic = dict(cell.traffic, frames_per_stream=8, warm_ticks=4)
    driver = harness.driver_of(cell)
    state = driver.setup(cell, seed, cuda_device)
    driver.window(state, 1.0)
    out = driver.check(state, ("program", "control"))
    assert not _fails(out["program"], cell.limits), out
    assert _fails(out["control"], cell.limits), out


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(cuda_device):
    cell = harness.load_cell(ROOT, "flagship-fleet16-f32")
    out = harness.run_cell(cell, 5, 1.0, True, cuda_device, 0.0)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    assert 0 < out["metrics"]["score_roofline_pct.tick"]["value"] <= 100
