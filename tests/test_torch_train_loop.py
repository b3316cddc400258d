"""The port's training loop on the CPU: ``dataset: synthetic``, two epochs,
the metric records, beta annealing, the progress sidecar, the learning rate
schedules against the JAX package's, a stop request at a batch boundary, and
``train_torch.py --resume``."""

import json
import os
import signal

import numpy as np
import pytest
import torch

from torch_port_helpers import LOSS_KEYS, LOSS_KEYS_BY_TYPE, tiny_config
from trustedai_cl_vae_ad_tpu.train.loop import lr_schedule_fn as jax_lr_schedule_fn
from trustedai_cl_vae_ad_tpu_torch.data.loader import load_data
from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config
from trustedai_cl_vae_ad_tpu_torch.train import checkpoint
from trustedai_cl_vae_ad_tpu_torch.train.checkpoint import AsyncSaver
from trustedai_cl_vae_ad_tpu_torch.train.loop import (
    BetaAnnealing,
    load_train_state,
    lr_schedule_fn,
    train_model,
)

BETA0 = 0.5


def _config(tmp_path, epochs=2, **training):
    cfg = tiny_config()
    cfg["data"].update(dataset="synthetic", n_train=24, n_val=8, synthetic_frame_size=[40, 64])
    cfg["training"].update(max_epochs=epochs, beta=BETA0, **training)
    cfg["logdir"] = str(tmp_path / "run")
    return cfg


def _records(cfg):
    with open(os.path.join(cfg["logdir"], "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_two_epochs_write_metrics_anneal_beta_and_save_state(tmp_path):
    cfg = _config(tmp_path, lr_schedule={"type": "cosine", "decay_epochs": 4})
    model = load_model_from_config(cfg, seed=0, device="cpu")
    data = load_data(cfg, device="cpu")
    assert len(data["train"]) == 3 and len(data["val"]) == 1
    out = train_model(cfg, model, data, log_every=2)
    assert out is model and model.optimizer.count == 6
    assert model.beta == pytest.approx(BETA0 * 0.98 ** 2, rel=1e-12)
    recs = _records(cfg)
    train = [r for r in recs if "train/loss" in r]
    val = [r for r in recs if "val/loss" in r]
    epochs = [r for r in recs if "train/epoch" in r]
    assert [r["step"] for r in train] == [0, 2, 4]
    assert [r["step"] for r in val] == [3, 6] and [r["step"] for r in epochs] == [3, 6]
    for r in train:
        assert {f"train/{k}" for k in LOSS_KEYS} <= set(r)
    for r in val:
        assert {f"val/{k}" for k in LOSS_KEYS} <= set(r)
        assert all(np.isfinite(r[f"val/{k}"]) for k in LOSS_KEYS)
    assert [r["train/epoch"] for r in epochs] == [0.0, 1.0]
    assert epochs[1]["train/beta"] == pytest.approx(BETA0 * 0.98 ** 2)
    assert epochs[1]["train/learning_rate"] == pytest.approx(lr_schedule_fn(cfg)(1))
    state = load_train_state(cfg["logdir"])
    assert state == {"epochs_completed": 2, "step": 6, "beta": pytest.approx(BETA0 * 0.98 ** 2)}
    for part in ("encoder", "decoder", "optimizer"):
        assert os.path.isdir(os.path.join(cfg["logdir"], part))
    assert load_train_state(str(tmp_path)) is None


SCHEDULES = [
    None,
    "reference",
    {"type": "exponential", "hold_epochs": 2, "decay": 0.3},
    {"type": "cosine"},
    {"type": "cosine", "decay_epochs": 5, "min_fraction": 0.1},
]


@pytest.mark.parametrize("spec", SCHEDULES, ids=["none", "reference", "exponential", "cosine",
                                                 "cosine-floor"])
def test_lr_schedules_equal_the_jax_package(spec):
    cfg = {"training": {"learning_rate": 3e-4, "max_epochs": 12}}
    if spec is not None:
        cfg["training"]["lr_schedule"] = spec
    ours, theirs = lr_schedule_fn(cfg), jax_lr_schedule_fn(cfg)
    if spec is None:
        assert ours is None and theirs is None
        return
    for epoch in (0, 1, 2, 5, 9, 10, 11, 30):
        assert ours(epoch) == theirs(epoch)


def test_bad_lr_schedules_raise():
    for spec in (["cosine"], {"decay": 1}, "linear"):
        with pytest.raises(ValueError):
            lr_schedule_fn({"training": {"learning_rate": 1e-3, "max_epochs": 2,
                                         "lr_schedule": spec}})


class _StopDuringSecondEpoch:
    """A training split that asks the process to stop (SIGTERM) while the
    second epoch's second batch is being made."""

    def __init__(self, inner):
        self.inner = inner
        self.epoch = 0

    def __iter__(self):
        self.epoch += 1
        for i, batch in enumerate(self.inner):
            if self.epoch == 2 and i == 1:
                handler = signal.getsignal(signal.SIGTERM)
                assert callable(handler), "train_model installed no SIGTERM handler"
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch


def test_stop_request_saves_a_consistent_epoch_and_beta(tmp_path, capsys):
    cfg = _config(tmp_path, epochs=3)
    model = load_model_from_config(cfg, seed=0, device="cpu")
    data = load_data(cfg, device="cpu")
    data["train"] = _StopDuringSecondEpoch(data["train"])
    before = signal.getsignal(signal.SIGTERM)
    train_model(cfg, model, data)
    assert signal.getsignal(signal.SIGTERM) is before  # handlers restored
    assert "Keyboard Interrupt" in capsys.readouterr().out
    state = load_train_state(cfg["logdir"])
    # the stop landed in epoch 2: it counts as not completed, and the saved
    # beta is the one of the last epoch boundary (annealed once)
    assert state["epochs_completed"] == 1
    assert state["beta"] == pytest.approx(BETA0 * 0.98)
    assert 4 <= state["step"] <= 6 and state["step"] == model.optimizer.count
    restored = load_model_from_config(cfg, seed=9, device="cpu")
    restored.load_model(cfg["logdir"], restore_optimizer=True)
    assert restored.optimizer.count == state["step"]
    for k, v in model.params.items():
        assert torch.equal(restored.params[k], v)


def test_periodic_checkpoints_and_ignored_keys(tmp_path, capsys):
    cfg = _config(tmp_path, epochs=2, checkpoint_every_epochs=1, async_checkpoint=True,
                  loss_chunks=4, zero1=True, compiler_options="a=b")
    model = load_model_from_config(cfg, seed=0, device="cpu")
    saves, savers = [], []
    save_model = model.save_model

    def recording_save(logdir, saver=None):
        saves.append(load_train_state(logdir))
        savers.append(saver)
        save_model(logdir, saver=saver)

    model.save_model = recording_save
    train_model(cfg, model, load_data(cfg, device="cpu"), beta_annealing=BetaAnnealing(0.5))
    assert "async_checkpoint" not in capsys.readouterr().out  # honoured, no warning
    # one periodic save after epoch 1 (no sidecar yet), through the background
    # saver; then the final one, synchronous, after the periodic round committed
    # and its callback wrote the sidecar
    assert saves == [None, {"epochs_completed": 1, "step": 3, "beta": BETA0 * 0.5}]
    assert isinstance(savers[0], AsyncSaver) and savers[1] is None
    assert model.beta == BETA0 * 0.25
    rounds = sorted(os.listdir(os.path.join(cfg["logdir"], "rounds")))
    assert rounds == ["00000001", "00000002"]


def _train(tmp_path, name, **training):
    cfg = _config(tmp_path / name, epochs=3, checkpoint_every_epochs=1, **training)
    model = load_model_from_config(cfg, seed=0, device="cpu")
    train_model(cfg, model, load_data(cfg, device="cpu"))
    return cfg, model


def test_async_checkpoint_gives_the_synchronous_runs_weights_and_sidecar(tmp_path):
    """``async_checkpoint: true`` with ``checkpoint_every_epochs: 1``: the same
    final weights, moments and sidecar as the synchronous run, on disk too."""
    sync_cfg, sync_model = _train(tmp_path, "sync")
    async_cfg, async_model = _train(tmp_path, "async", async_checkpoint=True)
    assert load_train_state(async_cfg["logdir"]) == load_train_state(sync_cfg["logdir"]) == {
        "epochs_completed": 3, "step": 9, "beta": pytest.approx(BETA0 * 0.98 ** 3)}
    for k, v in sync_model.params.items():
        assert torch.equal(async_model.params[k], v), k
    on_disk = {name: checkpoint.restore_params(cfg["logdir"])
               for name, cfg in (("sync", sync_cfg), ("async", async_cfg))}
    for k, v in sync_model.params.items():
        assert torch.equal(on_disk["sync"][k], v) and torch.equal(on_disk["async"][k], v), k
    a, b = (checkpoint.restore_optimizer_state(c["logdir"]) for c in (sync_cfg, async_cfg))
    assert a["count"] == b["count"] == 9
    assert all(torch.equal(a["nu"][k], b["nu"][k]) for k in a["nu"])
    # two periodic rounds and the final one; the last two are kept
    for cfg in (sync_cfg, async_cfg):
        assert sorted(os.listdir(os.path.join(cfg["logdir"], "rounds"))) == ["00000002",
                                                                             "00000003"]


def test_a_failed_background_write_warns_and_does_not_skip_the_final_save(tmp_path, monkeypatch,
                                                                          capsys):
    cfg = _config(tmp_path, epochs=2, checkpoint_every_epochs=1, async_checkpoint=True)
    model = load_model_from_config(cfg, seed=0, device="cpu")
    write = checkpoint._write_payload
    calls = []

    def failing_once(obj, staging, sub):
        calls.append(sub)
        if len(calls) == 2:  # the periodic round's decoder
            raise OSError("disk full")
        write(obj, staging, sub)

    monkeypatch.setattr(checkpoint, "_write_payload", failing_once)
    train_model(cfg, model, load_data(cfg, device="cpu"))
    assert "async periodic checkpoint failed (disk full)" in capsys.readouterr().out
    # the failed round never committed and its sidecar was dropped; the final
    # synchronous save wrote round 1 and the final sidecar
    assert os.listdir(os.path.join(cfg["logdir"], "rounds")) == ["00000001"]
    assert load_train_state(cfg["logdir"])["epochs_completed"] == 2
    restored = checkpoint.restore_params(cfg["logdir"])
    assert all(torch.equal(restored[k], v) for k, v in model.params.items())


def test_resume_from_a_logdir_whose_last_periodic_round_never_committed(tmp_path, monkeypatch,
                                                                       capsys):
    """A run killed while its second periodic round was being written leaves
    that round in staging: ``--resume`` continues from the first round and
    its sidecar, and the next save sweeps the staging directory."""
    import yaml

    import train_torch

    cfg = _config(tmp_path, epochs=1)
    cfg.pop("logdir")
    cfg["data"]["shuffle"] = False
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    train_torch.main([str(path), "--device", "cpu", "--seed", "3"])
    (first,) = os.listdir(tmp_path / "logs")
    os.rename(tmp_path / "logs" / first, tmp_path / "first")
    first = str(tmp_path / "first")
    committed = checkpoint.restore_params(first)
    # what the kill left: a half-written round 2 that was never renamed
    staging = os.path.join(first, "rounds", ".tmp-00000002", "encoder")
    os.makedirs(staging)
    with open(os.path.join(staging, "params.pt"), "wb") as f:
        f.write(b"half a file")
    assert checkpoint.resolve_round_dir(first).endswith("00000001")
    assert all(torch.equal(checkpoint.restore_params(first)[k], v) for k, v in committed.items())

    cfg["training"].update(max_epochs=2, checkpoint_every_epochs=1, async_checkpoint=True)
    path.write_text(yaml.safe_dump(cfg))
    train_torch.main([str(path), "--device", "cpu", "--resume", first])
    assert "1 epochs done, step 3" in capsys.readouterr().out
    (second,) = os.listdir(tmp_path / "logs")
    second = str(tmp_path / "logs" / second)
    assert load_train_state(second) == {"epochs_completed": 2, "step": 6,
                                        "beta": pytest.approx(BETA0 * 0.98 ** 2)}
    assert checkpoint.restore_optimizer_state(second)["count"] == 6


def test_train_torch_cli_dry_run_and_resume(tmp_path, monkeypatch, capsys):
    import yaml

    import train_torch

    cfg = _config(tmp_path, epochs=1)
    cfg.pop("logdir")
    cfg["data"]["shuffle"] = False
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):  # the default device is cuda: no silent CPU run
            train_torch.main([str(path)])
        assert "no CUDA device" in capsys.readouterr().err
    train_torch.main([str(path), "--device", "cpu", "--dry-run"])
    (dry,) = os.listdir(tmp_path / "logs")
    assert os.listdir(tmp_path / "logs" / dry) == ["config.yml"]
    os.rename(tmp_path / "logs" / dry, tmp_path / "dry")

    train_torch.main([str(path), "--device", "cpu", "--seed", "3"])
    (first,) = os.listdir(tmp_path / "logs")
    first = str(tmp_path / "logs" / first)
    assert load_train_state(first) == {"epochs_completed": 1, "step": 3,
                                       "beta": pytest.approx(BETA0 * 0.98)}
    os.rename(first, tmp_path / "first")
    first = str(tmp_path / "first")

    # three epochs in total: the resumed run trains only the remaining two
    cfg["training"]["max_epochs"] = 3
    path.write_text(yaml.safe_dump(cfg))
    train_torch.main([str(path), "--device", "cpu", "--resume", first])
    out = capsys.readouterr().out
    assert "1 epochs done, step 3" in out and "training 2 more" in out
    (second,) = os.listdir(tmp_path / "logs")
    second = str(tmp_path / "logs" / second)
    assert load_train_state(second) == {"epochs_completed": 3, "step": 9,
                                        "beta": pytest.approx(BETA0 * 0.98 ** 3)}
    with open(os.path.join(second, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["train/epoch"] for r in recs if "train/epoch" in r] == [1.0, 2.0]
    # steps are numbered on from the first run's three
    assert [r["step"] for r in recs if "train/epoch" in r] == [6, 9]


@pytest.mark.parametrize("model_type", ["KurtosisSingle", "KLGaussian"])
def test_train_torch_cli_runs_and_resumes_the_smoke_config(model_type, tmp_path, monkeypatch,
                                                           capsys):
    """``configs/synthetic_small.yml`` (the repo's smoke config, type
    KurtosisSingle), cut to 48 training frames and one epoch, trains on the
    CPU, writes its type's metric keys and resumes for a second epoch."""
    import yaml

    import train_torch

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "configs", "synthetic_small.yml")) as f:
        cfg = yaml.safe_load(f)
    assert cfg["model"]["type"] == "KurtosisSingle"
    cfg["model"]["type"] = model_type
    cfg["data"].update(n_train=48, n_val=16)
    cfg["training"]["max_epochs"] = 1
    path = tmp_path / "small.yml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    train_torch.main([str(path), "--device", "cpu"])
    (first,) = os.listdir(tmp_path / "logs")
    first = str(tmp_path / "logs" / first)
    assert load_train_state(first)["step"] == 3
    with open(os.path.join(first, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    keys = LOSS_KEYS_BY_TYPE[model_type]
    (train,) = [r for r in recs if "train/loss" in r]
    (val,) = [r for r in recs if "val/loss" in r]
    assert {k for k in train if k.startswith("train/")} == {f"train/{k}" for k in keys}
    assert {k for k in val if k.startswith("val/")} == {f"val/{k}" for k in keys}
    assert all(np.isfinite(val[f"val/{k}"]) for k in keys)
    os.rename(first, tmp_path / "first")

    cfg["training"]["max_epochs"] = 2
    path.write_text(yaml.safe_dump(cfg))
    train_torch.main([str(path), "--device", "cpu", "--resume", str(tmp_path / "first")])
    assert "1 epochs done, step 3" in capsys.readouterr().out
    (second,) = os.listdir(tmp_path / "logs")
    assert load_train_state(str(tmp_path / "logs" / second))["epochs_completed"] == 2
    restored = load_model_from_config(cfg, seed=0, device="cpu")
    restored.load_model(str(tmp_path / "logs" / second), restore_optimizer=True)
    assert restored.optimizer.count == 6
    assert type(restored.core).__name__ == f"{model_type}CVAE"
