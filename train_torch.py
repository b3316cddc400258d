#!/usr/bin/env python3
"""Offline training CLI of the PyTorch port:
``python train_torch.py config.yml [--dry-run] [--resume LOGDIR]``.

The counterpart of ``train.py`` on ``trustedai_cl_vae_ad_tpu_torch``: the
same 4-section YAML config, a stamped ``logs/fit_<timestamp>`` log directory
with a copy of the config, epoch training with per-epoch beta annealing
(x0.98), and a checkpoint of the weights and the Adam moments under
``<logdir>/encoder``, ``decoder`` and ``optimizer`` (stable symlinks into
crash-atomic rounds under ``<logdir>/rounds``; ``train/checkpoint.py``).
``training.checkpoint_every_epochs`` saves during the run, and with
``training.async_checkpoint`` those saves are written by a background thread.
It trains on one CUDA device unless ``--device cpu`` is given. After
training it writes the figures of ``train.py`` into the log directory
(``train/loop.py::evaluate``: ``original.png``, ``reconstruction.png``,
``output_histogram.png``, ``latent_histogram.png``).

Several processes train one model data-parallel (``parallel/``), each on its
rows of every global batch of ``training.batch_size``:

  python train_torch.py cfg.yml --coordinator HOST:PORT --num-processes N --process-id I

(``--coordinator`` may also be an init URL such as ``file:///shared/path``;
``--distributed`` reads ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` /
``WORLD_SIZE`` instead). NCCL joins CUDA devices, gloo the CPU
(``--device cpu``). Process 0 stamps the one log directory and writes the
metrics, the sidecar and the checkpoint (``training.zero1`` shards the Adam
moments); the in-process figures are skipped on multi-process runs. With
several local cards and none of these flags, one worker per card is started
this way; ``--no-parallel`` trains on one device.
Accepted and ignored config keys: ``training.loss_chunks``,
``training.compiler_options``.
"""

import argparse
import os
import socket
import subprocess
import sys

import torch

from trustedai_cl_vae_ad_tpu_torch.config import load_config, stamp_logdir, validate_config
from trustedai_cl_vae_ad_tpu_torch.data.loader import load_data
from trustedai_cl_vae_ad_tpu_torch.parallel.mesh import (
    broadcast_str,
    default_device,
    distributed_teardown,
    initialize_distributed,
    process_count,
    process_index,
)
from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config
from trustedai_cl_vae_ad_tpu_torch.train.checkpoint import has_optimizer
from trustedai_cl_vae_ad_tpu_torch.train.loop import evaluate, load_train_state, train_model
from trustedai_cl_vae_ad_tpu_torch.utils.cli import add_device_argument, checked_device


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config_filename", type=str, help="YAML configuration file")
    parser.add_argument("--dry-run", action="store_true", help="Quit before executing training")
    parser.add_argument("--resume", type=str, default=None, metavar="LOGDIR",
                        help="Resume from a previous log dir (weights and Adam moments)")
    add_device_argument(parser)
    parser.add_argument("--seed", type=int, default=0,
                        help="Seed of the initial weights and of the training noise")
    parser.add_argument("--no-parallel", action="store_true", help="Disable data-parallel mesh")
    parser.add_argument("--distributed", action="store_true",
                        help="Multi-process training: join the process group described by "
                             "MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE")
    parser.add_argument("--coordinator", type=str, default=None, metavar="HOST:PORT",
                        help="Multi-process coordinator address, or an init URL such as "
                             "file:///path (implies --distributed; requires --num-processes "
                             "and --process-id)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    args = parser.parse_args(argv)
    if args.coordinator is not None and (args.num_processes is None or args.process_id is None):
        parser.error("--coordinator requires --num-processes and --process-id")
    checked_device(parser, args.device)
    return args


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_workers(argv, n: int) -> int:
    """One training process per local card (cuda:0 .. cuda:n-1) joined
    through a coordinator on this host; the exit code is the first failure's,
    else 0."""
    coordinator = f"127.0.0.1:{_free_port()}"
    print(f"{n} CUDA devices: starting one training process per card ({coordinator})")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *argv,
                               "--coordinator", coordinator, "--num-processes", str(n),
                               "--process-id", str(i), "--device", f"cuda:{i}"])
             for i in range(n)]
    codes = [p.wait() for p in procs]
    return next((c for c in codes if c), 0)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = get_args(argv)
    device = torch.device(args.device)
    if args.distributed or args.coordinator is not None:
        if device.type == "cuda" and device.index is None:
            device = default_device(args.process_id or 0)
        initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                               device=device)
    elif (not args.no_parallel and device.type == "cuda" and device.index is None
          and torch.cuda.device_count() > 1):
        return launch_workers(argv, torch.cuda.device_count())
    print(f"torch {torch.__version__}, device: {device} "
          f"(process {process_index()}/{process_count()})")

    config = validate_config(load_config(args.config_filename))
    if process_count() > 1:
        # one stamped log directory for the whole job: process 0 stamps it
        # (and writes the config copy), the others receive the path
        if process_index() == 0:
            stamp_logdir(config)
        config["logdir"] = broadcast_str(config.get("logdir", ""))
    else:
        stamp_logdir(config)
    print(f"Log dir: {config['logdir']}")

    # training shuffles per epoch; the analysis tools use load_data's
    # deterministic default
    config["data"].setdefault("shuffle", True)

    data = load_data(config, device=device)
    model = load_model_from_config(config, seed=args.seed, device=device)
    initial_epoch = initial_step = 0
    if args.resume:
        print(f"Resuming from: {args.resume}")
        if not has_optimizer(args.resume):
            print("WARNING: no optimizer/ checkpoint in the resume dir: "
                  "weights restored, Adam moments start fresh")
        model.load_model(args.resume, restore_optimizer=True)
        state = load_train_state(args.resume)
        if state is not None:
            initial_epoch, initial_step = state["epochs_completed"], state["step"]
            if state["beta"] is not None:
                model.beta = state["beta"]
            total = int(config["training"]["max_epochs"])
            print(f"Resume state: {initial_epoch} epochs done, step {initial_step}, "
                  f"beta {model.beta:.6g}; training {max(total - initial_epoch, 0)} more")
    if args.dry_run:
        distributed_teardown()
        return
    train_model(config, model, data, parallel=not args.no_parallel,
                initial_epoch=initial_epoch, initial_step=initial_step)
    if process_index() == 0:
        print(f"Saved: {os.path.join(config['logdir'], 'encoder')} (+ decoder, optimizer)")
    if process_count() > 1:
        # the figures are made from one process's forward, which a tensor-parallel
        # mesh cannot run alone: run the latent and reconstruction tools on the logdir
        if process_index() == 0:
            print("multi-process run: skipping in-process eval artifacts (run the tools "
                  f"on {config['logdir']})")
    else:
        evaluate(config, model, data)
    distributed_teardown()


if __name__ == "__main__":
    sys.exit(main())
