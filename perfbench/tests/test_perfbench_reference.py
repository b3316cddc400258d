"""The plain reference against the program on the CPU at a tiny size, and whole tiny
cells through the harness."""

import numpy as np
import pytest
import torch
import yaml

from perfbench import harness, inputs
from perfbench.reference import cvae as ref
from perfbench.reference import scorer
from perfbench.tests.conftest import TINY_CONFIG


@pytest.fixture
def tiny():
    from trustedai_cl_vae_ad_tpu_torch.registry import build_core_from_config

    config = yaml.safe_load(TINY_CONFIG)
    core = build_core_from_config(config).to_empty(device="cpu")
    inputs.fill_program_params(core.named_parameters(), config, 99)
    return config, core, inputs.reference_params(config, 99, "cpu")


def test_weights_are_the_same_on_both_sides(tiny):
    _config, core, params = tiny
    for name, p in core.named_parameters():
        assert torch.equal(p, params[name]), name


def test_forward_and_loss_match_the_program(tiny):
    config, core, params = tiny
    x = inputs.train_epoch(5, 1, 6, config["data"]["image_size"], [3, 4], 0.04, "cpu")[0]
    eps = inputs.latent_noise(5, 1, 6, 8, "cpu")[0]
    with torch.no_grad():
        x_hat, z, mean, logvar = ref.forward(params, config, x, eps)
        p_hat, p_z, p_mean, p_logvar = core.call_detailed(x, training=True, eps=eps)
        for a, b in ((x_hat, p_hat), (z, p_z), (mean, p_mean), (logvar, p_logvar)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        loss = ref.kurtosis_global_loss(params, config, x, eps)
        torch.testing.assert_close(loss, core.compute_loss(x, training=True, eps=eps)["loss"],
                                   rtol=1e-5, atol=0)


def test_scorer_matches_the_program():
    from trustedai_cl_vae_ad_tpu_torch.ops import stream_score

    g = torch.Generator().manual_seed(3)
    k, h, w = 3, 12, 20
    maps, scalars = scorer.init_state(k, h, w, "cpu")
    p_maps, p_scalars = maps.clone(), scalars.clone()
    for _ in range(5):
        img, rec = torch.rand((2, k, h, w, 3), generator=g)
        maps, scalars, norm, score, count = scorer.score_step(maps, scalars, img, rec, 0.9)
        p_maps, p_scalars, p_norm, sc = stream_score.stream_score_step_batched(
            p_maps, p_scalars, img, rec, 0.9, torch.ones(k, dtype=torch.bool))
        torch.testing.assert_close(maps, p_maps, rtol=1e-6, atol=0)
        torch.testing.assert_close(scalars, p_scalars, rtol=1e-6, atol=0)
        torch.testing.assert_close(norm, p_norm, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(torch.stack([score, count], 1), sc, rtol=1e-5, atol=0,
                                   equal_nan=True)


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-fleet"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_cell_runs_correct(tiny_root, cell, trace):
    out = harness.run_cell(harness.load_cell(tiny_root, cell), 2 ** 33 + 1, 0.2, trace,
                           "cpu", 0.0)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device"] + (
        ["breakdown"] if trace else []) + ["checks"]
    if not trace:
        assert "setup_s" in out["metrics"]
    elif cell == "tiny-fleet":  # read from the window, beside the traced stretch's
        assert out["metrics"]["tick_ms_p95"]["value"] > 0


def test_same_seed_same_inputs():
    a = inputs.camera_frames(2 ** 40, 2, 3, (10, 12, 3), (2, 3), 0.05, (1, 1), "cpu")
    b = inputs.camera_frames(2 ** 40, 2, 3, (10, 12, 3), (2, 3), 0.05, (1, 1), "cpu")
    c = inputs.camera_frames(2 ** 40 + 1, 2, 3, (10, 12, 3), (2, 3), 0.05, (1, 1), "cpu")
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_the_reference_refuses_a_model_type_it_does_not_write_out(tiny):
    config, _core, params = tiny
    other = dict(config, model=dict(config["model"], type="KLGaussian"))
    x = torch.zeros((1, 32, 48, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="KLGaussian"):
        ref.forward(params, other, x, torch.zeros((1, 8)))
