"""Fixtures of the benchmark's tests: a checkout root with tiny cells beside the real
ones, so that the harness runs end to end on the CPU in seconds."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CONFIG = """\
loss: {w_mse: 1.0, kurtosis: 1.8, w_kurtosis: 1.0e-2, w_skew: 0.0, w_z_l1_reg: 0.0,
       w_kl_divergence: 0.0}
data: {dataset: synthetic, image_size: [32, 48, 3]}
training: {beta: 0.98, learning_rate: 1.0e-3, batch_size: 6, max_epochs: 1}
model: {type: KurtosisGlobal, latent_dimensions: 8, layers: [4, 8], decoder_dense_filters: 4}
"""
TINY_TRAIN = {"driver": "train_steps", "batches_in_epoch": 3, "fetch_every": 2,
              "checked_steps": 3, "traced_steps": 2, "frames": {"grid": [3, 4], "noise": 0.04}}
TINY_FLEET = {"driver": "camera_ticks", "streams": 3, "frames_per_stream": 4,
              "frame_size": [40, 60, 3], "motion": [1, 2],
              "frames": {"grid": [3, 4], "noise": 0.04}, "warm_ticks": 2, "traced_ticks": 3,
              "sample_share": 0.5}


def make_root(tmp_path: Path) -> Path:
    """A root holding the real BENCHMARK.json and perfbench/ files, plus the cells
    ``tiny-train`` and ``tiny-fleet`` (config ``tiny``, mixes ``tiny_train`` and
    ``tiny_fleet``) held to the real cells' limits, added as files and entries only."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "perfbench" / "configs" / "tiny.yml").write_text(TINY_CONFIG)
    spec["configs"].append({"name": "tiny", "source": "perfbench/tests/conftest.py",
                            "file": "perfbench/configs/tiny.yml", "reduced": []})
    for cell, mix, body, real in (("tiny-train", "tiny_train", TINY_TRAIN, "flagship-train-f32"),
                                  ("tiny-fleet", "tiny_fleet", TINY_FLEET,
                                   "flagship-fleet16-f32")):
        (root / "perfbench" / "traffic" / f"{mix}.json").write_text(json.dumps(body))
        shutil.copy(root / "perfbench" / "cells" / f"{real}.json",
                    root / "perfbench" / "cells" / f"{cell}.json")
        spec["workloads"].append({"name": cell, "config": "tiny", "traffic": mix, "chips": 1,
                                  "why": "a tiny cell of the tests"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture
def cuda_device():
    """Skips the test where there is no card (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
