"""train_torch.py over several gloo processes on the CPU, against one process.

The counterpart of tests/test_multiprocess.py for the port: the real CLI with
``--coordinator`` (here a file store in tmp_path, so no port can be taken by
another test) or ``--distributed`` (the MASTER_ADDR / RANK / WORLD_SIZE
environment), ``--num-processes 2``. Process 0 stamps the one log directory
that the other receives, writes the one metrics.jsonl and the sidecar, and
the checkpoint gathered to it equals a 1-process run's of the same global
batches (rtol 1e-5 / atol 1e-6 on the weights after Adam steps; the order of
the sums differs). Each run has its own time limit and its processes are
killed when it passes.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = (
    "loss: {w_mse: 1., kurtosis: 1.8, w_kurtosis: 1.0e-4, w_skew: 0.0, "
    "w_kl_divergence: 0.0, w_z_l1_reg: 1.0e-3}\n"
    "data: {dataset: synthetic, n_train: 16, n_val: 8, image_size: [%d, %d, 3]}\n"
    "training: {beta: 1.0e-6, learning_rate: 1.0e-4, batch_size: 8, max_epochs: 2%s}\n"
    "model: {type: KurtosisGlobal, latent_dimensions: %d, layers: [4], "
    "decoder_dense_filters: 4}\n")


def _run(cwd, args_of_rank, n, timeout=180, env_of_rank=None):
    """Start ``n`` train_torch.py processes (rank r with ``args_of_rank(r)``)
    in ``cwd``; return their outputs; kill them all if any outlives ``timeout``."""
    os.makedirs(cwd, exist_ok=True)
    base = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "train_torch.py"),
                               *args_of_rank(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=str(cwd),
                              env=dict(base, **(env_of_rank(r) if env_of_rank else {})))
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            assert p.returncode == 0, out[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _logdirs(outs):
    return {line.split("Log dir: ")[1].strip() for out in outs for line in out.splitlines()
            if line.startswith("Log dir: ")}


def _checkpoint(logdir):
    from trustedai_cl_vae_ad_tpu_torch.train.checkpoint import (
        restore_optimizer_state,
        restore_params,
    )

    return restore_params(logdir), restore_optimizer_state(logdir)


def _assert_same_checkpoint(got, want):
    (p_got, o_got), (p_want, o_want) = got, want
    assert set(p_got) == set(p_want)
    for k, v in p_want.items():
        np.testing.assert_allclose(p_got[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
    assert o_got["count"] == o_want["count"] and o_got["learning_rate"] == o_want["learning_rate"]
    for kind in ("mu", "nu"):
        for k, v in o_want[kind].items():
            assert o_got[kind][k].shape == v.shape
            np.testing.assert_allclose(o_got[kind][k].numpy(), v.numpy(), rtol=1e-3,
                                       atol=1e-3 * float(v.abs().max()), err_msg=k)


def test_train_cli_two_process_matches_one_process(tmp_path):
    """--coordinator file://... --num-processes 2: one stamped log directory,
    one metrics.jsonl (rank 0's), the sidecar, and the checkpoint of the
    1-process run of the same global batches."""
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(CONFIG % (16, 16, "", 8))
    store = f"file://{tmp_path / 'store'}"
    outs = _run(tmp_path / "two", lambda r: [str(cfg), "--device", "cpu", "--coordinator", store,
                                             "--num-processes", "2", "--process-id", str(r)], 2)
    (one_out,) = _run(tmp_path / "one", lambda r: [str(cfg), "--device", "cpu"], 1)
    logdirs = _logdirs(outs)
    assert len(logdirs) == 1, logdirs
    logdir = logdirs.pop()
    assert os.listdir(tmp_path / "two" / "logs") == [os.path.basename(logdir)]
    assert "(process 1/2)" in outs[1] and "Saved:" not in outs[1]
    assert "skipping in-process eval artifacts" in outs[0]
    for sub in ("encoder", "decoder", "optimizer", "config.yml", "train_state.json"):
        assert os.path.exists(os.path.join(logdir, sub)), sub
    (one,) = _logdirs([one_out])
    lines = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
    want = [json.loads(line) for line in open(os.path.join(one, "metrics.jsonl"))]
    assert [sorted(r) for r in lines] == [sorted(r) for r in want]  # written once, not twice
    for got, ref in zip(lines, want):
        for k, v in ref.items():
            if k.startswith(("train/", "val/")):
                np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    state = json.load(open(os.path.join(logdir, "train_state.json")))
    assert state == json.load(open(os.path.join(one, "train_state.json")))
    assert state["epochs_completed"] == 2 and state["step"] == 4
    _assert_same_checkpoint(_checkpoint(logdir), _checkpoint(one))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_cli_two_process_zero1(tmp_path):
    """--distributed (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE) with
    training.zero1: the encoder Dense's moments (1024 x 128, past ZeRO-1's
    2**16 elements) are sharded during training and gathered whole into the
    checkpoint, which restores in one process and equals the 1-process run's."""
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory

    cfg = tmp_path / "cfg.yml"
    cfg.write_text(CONFIG % (32, 32, ", zero1: true", 64))
    port = str(_free_port())
    outs = _run(tmp_path / "two", lambda r: [str(cfg), "--device", "cpu", "--distributed"], 2,
                env_of_rank=lambda r: {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
                                       "RANK": str(r), "WORLD_SIZE": "2"})
    (one_out,) = _run(tmp_path / "one", lambda r: [str(cfg), "--device", "cpu"], 1)
    (logdir,) = _logdirs(outs)
    (one,) = _logdirs([one_out])
    got = _checkpoint(logdir)
    assert got[1]["mu"]["encoder.layers.Dense_0.weight"].shape == (128, 1024)
    assert float(got[1]["mu"]["encoder.layers.Dense_0.weight"].abs().sum()) > 0
    _assert_same_checkpoint(got, _checkpoint(one))
    model, _ = load_model_from_directory(logdir, device="cpu", restore_optimizer=True)
    assert model.optimizer.count == 4
    loss = model.test_step(torch.rand(4, 32, 32, 3))
    assert np.isfinite(float(loss["loss"]))


def test_train_cli_starts_one_worker_per_card(monkeypatch):
    """With several local cards and none of the process flags, train_torch.py
    starts one worker a card, joined through one coordinator on this host."""
    import train_torch

    calls = []

    class Worker:
        def __init__(self, args):
            calls.append(args)

        def wait(self):
            return 0

    monkeypatch.setattr(train_torch.subprocess, "Popen", Worker)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert train_torch.main(["cfg.yml", "--seed", "2"]) == 0
    assert len(calls) == 3
    coordinators = set()
    for i, args in enumerate(calls):
        assert args[1].endswith("train_torch.py") and args[2:5] == ["cfg.yml", "--seed", "2"]
        flags = dict(zip(args[5::2], args[6::2]))
        assert (flags["--num-processes"], flags["--process-id"], flags["--device"]) == (
            "3", str(i), f"cuda:{i}")
        coordinators.add(flags["--coordinator"])
    assert len(coordinators) == 1 and coordinators.pop().startswith("127.0.0.1:")
