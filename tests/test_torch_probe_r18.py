"""The r18 probe (``probes/r18.py`` and ``probe_r18_torch.py``) on the CPU at
tiny sizes: its three modes, the probe's encoder against the model's own, and
the CLI's arguments and JSON rows."""

import json

import numpy as np
import pytest
import torch

from torch_port_helpers import load_r18_probe, tiny_config
from trustedai_cl_vae_ad_tpu_torch.models.cvae import Encoder
from trustedai_cl_vae_ad_tpu_torch.ops import conv_dw as cdw
from trustedai_cl_vae_ad_tpu_torch.probes import r18
from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config


def test_check_mode_passes_on_the_cpu_at_the_archived_shapes(monkeypatch, tmp_path):
    archived = load_r18_probe(monkeypatch, tmp_path)
    rows = r18.check(device="cpu", seed=0)
    assert [tuple(r["shape"]) for r in rows] == r18.CHECK_SHAPES == [(2, 8, 12, 3, 8),
                                                                     (3, 16, 16, 5, 4)]
    assert all(r["max_abs_err"] < r18.CHECK_TOL and r["launches"] == 0 and r["device"] == "cpu"
               for r in rows)
    archived.check()  # the JAX harness's own check, in interpret mode


def test_check_operands_are_the_archived_harness_draws():
    """One RandomState walks the shapes, as in the JAX harness: x, the weight
    scaled by 0.1, then dy."""
    rng, ref = np.random.RandomState(0), np.random.RandomState(0)
    for shape in r18.CHECK_SHAPES:
        b, h, w, ci, co = shape
        x, k, dy = r18.check_operands(shape, rng=rng)
        assert np.array_equal(x, ref.standard_normal((b, h, w, ci)).astype(np.float32))
        assert np.array_equal(k, (ref.standard_normal((3, 3, ci, co)) * 0.1).astype(np.float32))
        assert np.array_equal(dy, ref.standard_normal((b, h // 2, w // 2, co)).astype(np.float32))


def test_check_mode_catches_a_wrong_gradient(monkeypatch):
    good = cdw.conv_dw
    monkeypatch.setattr(cdw, "conv_dw", lambda x, dy: good(x, dy).flip(0))
    with pytest.raises(AssertionError):
        r18.check(device="cpu")


def test_kernel_only_rows_and_bounds():
    calls = []

    def library(x, dy):
        def call():
            calls.append(1)
            return cdw.conv_dw_reference(x, dy)
        return call

    rows = r18.kernel_only(batch=2, steps=2, device="cpu", shapes=r18.TINY_SHAPES,
                           library=library)
    assert [r["variant"] for r in rows] == ["kernel_only_conv1", "kernel_only_conv2"]
    assert len(calls) == 2 * (r18.WARMUP + 2)
    for r, (h, w, ci, co) in zip(rows, r18.TINY_SHAPES.values()):
        assert r["probe"] == "r18_conv_dw" and r["shape"] == [2, h, w, ci, co]
        assert r["dtype"] == "bfloat16" and r["launches"] == 0 and r["device"] == "cpu"
        assert r["ms"] > 0 and r["library_ms"] > 0 and r["event_ms"] is None
        nbytes = 2 * 2 * (h * w * ci + (h // 2) * (w // 2) * co) + 4 * 9 * ci * co
        assert r["bound_by"] == "bytes" and r["bound_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert r18.kernel_only(batch=1, steps=1, device="cpu",
                           shapes=r18.TINY_SHAPES)[0]["library_ms"] is None


def test_bounds_at_the_flagship_shapes_equal_kernel_bounds_torch():
    import kernel_bounds_torch as kb

    table = [r for r in kb.bounds() if r["row"] == 11]
    assert len(table) == 2 and all(r["ported"] for r in kb.bounds())
    for row, (h, w, ci, co) in zip(table, r18.FLAGSHIP_SHAPES.values()):
        bound_ms, bound_by = r18.kernel_bound(768, h, w, ci, co, 2)
        assert bound_ms == pytest.approx(row["bound_ms"]) and bound_by == row["bound_by"]
    assert table[0]["bound_ms"] == pytest.approx(0.33893, abs=1e-5)
    assert table[1]["bound_ms"] == pytest.approx(0.36976, abs=1e-5)
    # float32 operands: the CUDA cores' rate bounds the second layer
    assert r18.kernel_bound(768, 112, 150, 32, 64, 4)[1] == "operations"


def test_patched_encoder_shares_parameters_names_and_values():
    cfg = tiny_config()
    model = load_model_from_config(cfg, seed=0, device="cpu")
    base = model.core.encoder
    keys = list(model.core.state_dict())
    x = torch.rand(3, 32, 48, 3)
    want = base(x)
    for n in (0, 1, 2):
        enc = r18.patched_encoder(base, n)
        assert isinstance(enc, Encoder)
        assert all(a is b for a, b in zip(enc.parameters(), base.parameters()))
        model.core.encoder = enc
        assert list(model.core.state_dict()) == keys  # one state dict fits every variant
        assert torch.allclose(enc(x), want, rtol=1e-5, atol=1e-6)
        assert enc.routed == list(range(n))
    with pytest.raises(ValueError):
        r18.patched_encoder(base, 3)


def test_patched_encoder_gradients_equal_the_models_own():
    cfg = tiny_config()
    model = load_model_from_config(cfg, seed=0, device="cpu")
    base = model.core.encoder
    x = torch.rand(3, 32, 48, 3)
    names = [k for k, _ in base.named_parameters()]
    want = torch.autograd.grad(base(x).square().sum(), list(base.parameters()))
    got = torch.autograd.grad(r18.patched_encoder(base, 2)(x).square().sum(),
                              list(base.parameters()))
    for name, a, b in zip(names, got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=name)


def test_a_layer_with_an_odd_input_is_left_unpatched():
    """32x44 halves to 16x22, then 8x11: the third convolution's input is odd
    and keeps the ordinary convolution, by the archived harness's rule."""
    cfg = tiny_config(image=(32, 44, 3), layers=(4, 8, 8))
    model = load_model_from_config(cfg, seed=0, device="cpu")
    base = model.core.encoder
    enc = r18.patched_encoder(base, 3)
    x = torch.rand(2, 32, 44, 3)
    out = enc(x)
    assert enc.routed == [0, 1]
    assert torch.allclose(out, base(x), rtol=1e-5, atol=1e-6)
    out.sum().backward()  # and its gradient flows through both kinds of layer
    assert all(p.grad is not None for p in base.parameters())


def test_bench_variants_agree_after_one_step_and_share_state_keys():
    cfg = r18.tiny_bench_config()
    rows = r18.bench(batch=4, steps=2, warmup=1, device="cpu", seed=0, config=cfg,
                     keep_state=True)
    assert [r["variant"] for r in rows] == ["baseline", "conv1_kernel_dw", "conv12_kernel_dw"]
    assert [r["routed"] for r in rows] == [[], [0], [0, 1]]
    losses = [r["loss_after_one_step"] for r in rows]
    # float32 on one device: two weight gradients differ by the order of their sums
    assert max(losses) - min(losses) <= 1e-5 * abs(losses[0]), losses
    keys = [list(r["state"]) for r in rows]
    assert keys[0] == keys[1] == keys[2]
    lr = cfg["training"]["learning_rate"]
    for k in keys[0]:  # after two Adam steps no weight is further than 2 lr from the baseline's
        for r in rows[1:]:
            assert float((r["state"][k] - rows[0]["state"][k]).abs().max()) <= 2.01 * lr, k
    for r in rows:
        assert r["steps"] == 2 and r["warmup"] == 1 and r["launches"] == 0
        assert r["fps"] > 0 and r["ms_per_step"] > 0 and np.isfinite(r["last_loss"])
        assert r["batch"] == 4 and r["device"] == "cpu" and r["event_ms"] is None


def test_bench_refuses_variants_whose_losses_disagree(monkeypatch):
    good = cdw.conv_dw
    monkeypatch.setattr(cdw, "conv_dw", lambda x, dy: -good(x, dy))
    with pytest.raises(AssertionError, match="disagree"):
        r18.bench(batch=4, steps=1, warmup=0, device="cpu", config=r18.tiny_bench_config(),
                  loss_rtol=1e-7)


def test_bench_config_is_the_flagship_in_bfloat16():
    cfg = r18.bench_config()
    assert cfg["data"]["image_size"] == [224, 300, 3] and cfg["model"]["layers"] == [32, 64]
    assert cfg["model"]["latent_dimensions"] == 2000 and cfg["model"]["type"] == "KurtosisGlobal"
    assert cfg["training"]["precision"] == "bfloat16"
    h, w, c = cfg["data"]["image_size"]
    assert r18.FLAGSHIP_SHAPES == {"conv1": (h, w, c, 32), "conv2": (h // 2, w // 2, 32, 64)}


def test_cli_modes_rows_and_arguments(tmp_path, capsys):
    import probe_r18_torch

    out = tmp_path / "rows.jsonl"
    rc = probe_r18_torch.main(["--check", "--kernel", "--bench", "--tiny", "--batch", "4",
                               "--steps", "2", "--device", "cpu", "--out", str(out)])
    assert rc == 0
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == "device: cpu" and "check ok" in printed
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["variant"] for r in rows] == [
        "check", "check", "kernel_only_conv1", "kernel_only_conv2", "baseline",
        "conv1_kernel_dw", "conv12_kernel_dw"]
    assert all(r["probe"] == "r18_conv_dw" and r["card"] == "cpu" for r in rows)
    assert [json.loads(line) for line in printed if line.startswith("{")] == rows
    assert all(r["library_ms"] > 0 for r in rows[2:4])  # the CLI's own yardstick ran
    assert all(r["batch"] == 4 for r in rows[2:])
    for argv in ([], ["--check", "--batch", "0"], ["--bench", "--steps", "0"],
                 ["--check", "--device", "tpu"]):
        with pytest.raises(SystemExit):
            probe_r18_torch.main(argv)
    if not torch.cuda.is_available():
        assert probe_r18_torch.main(["--check"]) == 1  # the default device is the card
        assert "no CUDA device" in capsys.readouterr().err


def test_cli_yardstick_equals_the_plain_version():
    """``cudnn_weight_gradient`` (timed beside the kernel, never used by the
    port) computes the same function, in OIHW."""
    import probe_r18_torch

    x, _w, dy = (torch.from_numpy(a) for a in r18.check_operands(r18.CHECK_SHAPES[0]))
    got = probe_r18_torch.cudnn_weight_gradient(x, dy)()
    torch.testing.assert_close(got, cdw.dw_to_oihw(cdw.conv_dw_reference(x, dy)),
                               rtol=1e-4, atol=1e-4)
