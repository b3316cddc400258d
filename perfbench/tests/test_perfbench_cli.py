"""``perfbench/run.py`` without a card, and in a directory of the benchmark's files alone."""

import json
import shutil
import subprocess
import sys

import pytest

from perfbench.tests.conftest import ROOT


def _run(cwd, *extra, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "flagship-train-f32", "--seed", str(2 ** 40 + 3), "--seconds", "1",
                           "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def _no_result(out):
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_no_card_exits_nonzero_without_a_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    _no_result(out)


def test_the_benchmarks_files_alone_do_not_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    _no_result(out)
