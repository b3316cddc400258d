"""BENCHMARK.json against the benchmark's contract, and a cell, configuration, traffic
mix and per-layer metric added from files alone."""

import json
import re

import pytest

from perfbench import harness
from perfbench.tests.conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert {m["name"] for m in SPEC["end_to_end"]} == {
        "train_frames_per_s", "camera_frames_per_s", "peak_mem_gib", "setup_s"}
    assert CELLS == ["flagship-train-f32", "flagship-fleet16-f32", "raite-train-f32"]


def test_entries_have_exactly_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_names_units_and_bounds():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for e in SPEC["workloads"] + SPEC["configs"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    assert all(w["chips"] == 1 for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_its_files_and_metrics(cell):
    c = harness.load_cell(ROOT, cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "a cell reports at least one per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in e2e, (m["name"], "moves a metric its cell does not report")
        assert callable(harness.load_reader(ROOT, m["name"]))
    assert c.limits and all(v > 0 for v in c.limits.values())
    assert c.traffic["driver"] in ("train_steps", "camera_ticks")


def test_layers_are_named_alike():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert layers == {"optimizer", "model", "device", "engine", "scorer kernel"}


def test_a_cell_added_from_files_alone(tiny_root):
    """A new configuration, traffic mix, metric and cell are found by their names; the
    files that were there are untouched."""
    before = {p: p.read_bytes() for p in (tiny_root / "perfbench").rglob("*") if p.is_file()}
    metrics = tiny_root / "perfbench" / "metrics"
    (metrics / "steps_traced.tiny.py").write_text(
        "def read(ctx):\n    return float(ctx.trace.steps)\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "steps_traced.tiny", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "device",
                              "moves": "train_frames_per_s", "workloads": ["tiny-train"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell(tiny_root, "tiny-train")
    assert cell.config["model"]["latent_dimensions"] == 8
    assert cell.traffic["batches_in_epoch"] == 3
    assert "steps_traced.tiny" in [m["name"] for m in cell.per_layer]
    out = harness.run_cell(cell, 12345, 0.2, True, "cpu", 0.0)
    assert out["correct"], out["checks"]
    assert out["metrics"]["steps_traced.tiny"] == {"value": 2.0, "unit": "steps"}
    assert list(out)[-1] == "checks"
    for p, data in before.items():
        assert p.read_bytes() == data


def test_a_metric_family_shares_one_reader(tiny_root):
    """``conv_ms.train`` and ``conv_ms.tick`` are read by ``conv_ms.py``; a file named for
    the whole metric, added later, serves that metric alone."""
    def file_of(metric):
        return harness.load_reader(tiny_root, metric).__code__.co_filename

    metrics = tiny_root / "perfbench" / "metrics"
    assert file_of("conv_ms.train") == file_of("conv_ms.tick") == str(metrics / "conv_ms.py")
    (metrics / "conv_ms.tiny.py").write_text("def read(ctx):\n    return 7.0\n")
    assert harness.load_reader(tiny_root, "conv_ms.tiny")(None) == 7.0
    assert file_of("conv_ms.tick") == str(metrics / "conv_ms.py")
