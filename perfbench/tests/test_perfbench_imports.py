"""What a run may load: no JAX and nothing of the JAX package, by whole top-level names;
and the reference loads nothing of the program."""

import ast
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.tests.conftest import ROOT

PROGRAM = "trustedai_cl_vae_ad_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("loaded, found", [
    (["jax.numpy"], ["jax"]), (["jaxlib"], ["jaxlib"]), (["src.models"], ["src"]),
    (["trustedai_cl_vae_ad_tpu.ops"], ["trustedai_cl_vae_ad_tpu"]),
    (["trustedai_cl_vae_ad_tpu_torch.ops", "jaxtyping", "benchmarks_x"], []),
])
def test_forbidden_names_compare_whole_top_level_names(monkeypatch, loaded, found):
    for name in loaded:
        monkeypatch.setitem(sys.modules, name, object())
    assert [m for m in harness.forbidden_modules() if m in found or m in loaded] == found


def test_no_file_of_the_benchmark_imports_a_forbidden_name():
    for path in (ROOT / "perfbench").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), (path, tops & set(harness.FORBIDDEN))


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "perfbench" / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert PROGRAM not in tops, path
    code = ("import sys; import perfbench.reference.cvae, perfbench.reference.scorer; "
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"({PROGRAM!r},) + {tuple(harness.FORBIDDEN)!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_loads_no_forbidden_module(tiny_root):
    """The program's whole path on the CPU, in a fresh process."""
    code = ("import sys; from pathlib import Path; from perfbench import harness; "
            f"c = harness.load_cell(Path({str(tiny_root)!r}), 'tiny-fleet'); "
            "harness.run_cell(c, 7, 0.1, False, 'cpu', 0.0); "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
