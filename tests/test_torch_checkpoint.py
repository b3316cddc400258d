"""Save and load of the port's log directory: parameters, Adam moments and
step count come back equal, a restored run continues exactly as an
uninterrupted one, ``restore_optimizer`` None / True / False, and
``camera_streamer_torch.py -m`` reads the directory."""

import json
import os

import numpy as np
import pytest
import torch

from torch_port_helpers import tiny_config
from trustedai_cl_vae_ad_tpu_torch.config import load_config, save_config
from trustedai_cl_vae_ad_tpu_torch.registry import (
    load_model_from_config,
    load_model_from_directory,
)
from trustedai_cl_vae_ad_tpu_torch.testing import run_train_steps, train_inputs
from trustedai_cl_vae_ad_tpu_torch.train import checkpoint


def _trained(cfg, inputs):
    model = load_model_from_config(cfg, seed=4, device="cpu")
    model.compile()
    run_train_steps(model, inputs)
    return model


@pytest.mark.parametrize("precision", [None, "bfloat16"], ids=["float32-adam", "bfloat16-lean"])
def test_restored_run_continues_exactly(tmp_path, precision):
    cfg = tiny_config(precision=precision)
    inputs = train_inputs(cfg, n_steps=4, batch=4, seed=2)
    whole = _trained(cfg, inputs[:2])
    whole.save_model(str(tmp_path))
    expected = run_train_steps(whole, inputs[2:])

    resumed = load_model_from_config(cfg, seed=99, device="cpu")
    resumed.load_model(str(tmp_path), restore_optimizer=True)
    assert resumed.optimizer.count == 2 and resumed.optimizer.name == whole.optimizer.name
    saved = checkpoint.restore_optimizer_state(str(tmp_path))
    for kind in ("mu", "nu"):
        for name, t in zip(resumed.optimizer.names, getattr(resumed.optimizer, kind)):
            assert torch.equal(t, saved[kind][name]) and t.dtype == saved[kind][name].dtype
    got = run_train_steps(resumed, inputs[2:])
    for g, e in zip(got, expected):
        assert g["loss"] == e["loss"]
        assert np.array_equal(g["x_hat"], e["x_hat"])
    for k, v in whole.params.items():
        assert torch.equal(resumed.params[k], v)


def test_restore_optimizer_modes(tmp_path):
    cfg = tiny_config()
    inputs = train_inputs(cfg, n_steps=2, batch=4)
    trained = _trained(cfg, inputs)
    trained.save_model(str(tmp_path / "full"))
    trained.save_model(str(tmp_path / "weights"), include_optimizer=False)
    assert checkpoint.has_optimizer(str(tmp_path / "full"))
    assert not checkpoint.has_optimizer(str(tmp_path / "weights"))

    fresh = lambda: load_model_from_config(cfg, seed=7, device="cpu")
    a = fresh()                                   # None, not compiled: weights only
    a.load_model(str(tmp_path / "full"))
    assert a.optimizer is None
    assert all(torch.equal(a.params[k], v) for k, v in trained.params.items())
    b = fresh()                                   # None, compiled: moments too
    b.compile()
    b.load_model(str(tmp_path / "full"))
    assert b.optimizer.count == 2
    c = fresh()                                   # False: the moments stay fresh
    c.compile()
    c.load_model(str(tmp_path / "full"), restore_optimizer=False)
    assert c.optimizer.count == 0 and float(c.optimizer.nu[0].abs().sum()) == 0.0
    d = fresh()                                   # True without an optimizer/ directory
    d.load_model(str(tmp_path / "weights"), restore_optimizer=True)
    assert d.optimizer is None
    with pytest.raises(FileNotFoundError, match="not a log directory"):
        fresh().load_model(str(tmp_path / "nothing"))


def test_files_are_plain_tensor_dicts_written_atomically(tmp_path):
    cfg = tiny_config()
    model = _trained(cfg, train_inputs(cfg, n_steps=1, batch=4))
    model.save_model(str(tmp_path))
    for sub, name in (("encoder", "params.pt"), ("decoder", "params.pt"),
                      ("optimizer", "state.pt")):
        assert os.path.islink(tmp_path / sub)  # a stable name into the committed round
        assert os.listdir(tmp_path / sub) == [name]  # no temporary file left behind
        blob = torch.load(tmp_path / sub / name, weights_only=True)
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in blob.values())
    enc = torch.load(tmp_path / "encoder" / "params.pt", weights_only=True)
    assert set(enc) == {k for k in model.params if k.startswith("encoder.")}
    assert os.listdir(tmp_path / "rounds") == ["00000001"]  # no staging directory left behind
    assert os.readlink(tmp_path / "current") == os.path.join("rounds", "00000001")
    with pytest.raises(KeyError):
        checkpoint.save_checkpoint(str(tmp_path / "x"), {"decoder.layers.a.weight": torch.zeros(1)})
    assert not os.path.exists(tmp_path / "x")  # refused before anything was staged


def test_config_round_trip_and_model_from_directory(tmp_path):
    cfg = tiny_config()
    cfg["training"]["learning_rate"] = np.float32(1e-3)  # numpy scalars become builtins
    model = _trained(tiny_config(), train_inputs(cfg, n_steps=1, batch=4))
    model.save_model(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="config.yml"):
        load_model_from_directory(str(tmp_path))
    save_config(cfg, str(tmp_path / "config.yml"))
    assert load_config(str(tmp_path / "config.yml"))["training"]["learning_rate"] == \
        pytest.approx(1e-3)
    loaded, config = load_model_from_directory(str(tmp_path), device="cpu")
    assert config["model"] == cfg["model"] and loaded.optimizer is None
    x = train_inputs(cfg, n_steps=1, batch=2)[0][0]
    assert torch.equal(loaded.call(x), model.call(x))


def test_camera_streamer_reads_a_trained_logdir(tmp_path):
    import camera_streamer_torch

    cfg = tiny_config()
    model = _trained(cfg, train_inputs(cfg, n_steps=2, batch=4))
    model.save_model(str(tmp_path / "run"))
    save_config(cfg, str(tmp_path / "run" / "config.yml"))
    stats = tmp_path / "stats.jsonl"
    camera_streamer_torch.main(["-m", str(tmp_path / "run"), "--device", "cpu", "--source",
                                "synthetic", "--max-frames", "5", "--stats-jsonl", str(stats)])
    rows = [json.loads(line) for line in stats.read_text().splitlines()]
    assert [r["frame"] for r in rows] == [0, 1, 2, 3, 4]
    with pytest.raises(SystemExit):
        camera_streamer_torch.get_args(["--device", "cpu"])            # neither given
    with pytest.raises(SystemExit):
        camera_streamer_torch.get_args(["-m", "a", "--config", "b", "--device", "cpu"])
