"""The yardstick's arithmetic against the figures PERF.md keeps: the CVAE's operations
a frame (1.881 GMAC flagship, 0.672 GMAC RAITE) and kernel 1's bytes and bound."""

import pytest
import yaml

from perfbench.tests.conftest import ROOT
from perfbench.yardstick import bounds


def _config(name):
    return yaml.safe_load((ROOT / "perfbench" / "configs" / f"{name}.yml").read_text())


@pytest.mark.parametrize("name, total, parts", [
    ("flagship", 1.881, {"conv": 0.092, "encoder_dense": 1.075, "decoder_dense": 0.269,
                         "conv_transpose": 0.445}),
    ("raite", 0.672, {"conv": 0.092, "encoder_dense": 0.108, "decoder_dense": 0.027,
                      "conv_transpose": 0.445}),
])
def test_forward_macs_a_frame(name, total, parts):
    macs = bounds.forward_macs(_config(name))
    assert macs["total"] / 1e9 == pytest.approx(total, rel=1e-3)
    for kind, gmac in parts.items():
        assert macs[kind] / 1e9 == pytest.approx(gmac, rel=2e-2)
    assert macs["total"] == sum(v for k, v in macs.items() if k != "total")


def test_step_and_tick_flops():
    flagship = _config("flagship")
    # a training step counts three forwards of 256 frames; a tick one forward of 16
    assert 3 * bounds.forward_flops(flagship) * 256 / 1e12 == pytest.approx(2.890, abs=1e-3)
    assert 16 * bounds.forward_flops(flagship) / 1e9 == pytest.approx(60.2, abs=0.05)
    assert 16 * bounds.forward_flops(_config("raite")) / 1e9 == pytest.approx(21.5, abs=0.05)
    assert bounds.peak_flops(flagship) == 67e12


@pytest.mark.parametrize("k, mb, bound_ms", [(1, 2.96, 0.00088), (16, 47.3, 0.0141)])
def test_stream_score_bytes_and_bound(k, mb, bound_ms):
    # PERF.md's kernel table, row 1: 2.96 MB (K = 1) and 47.3 MB (K = 16) at 224x300x3
    nbytes, _ = bounds.stream_score(k, 224, 300, 3)
    assert nbytes / 1e6 == pytest.approx(mb, abs=0.01)
    assert nbytes / bounds.HBM_BYTES_PER_S * 1e3 == pytest.approx(bound_ms, rel=0.01)


def test_frozen_peaks():
    assert bounds.HBM_BYTES_PER_S == 3.35e12
    assert bounds.PEAK == {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
