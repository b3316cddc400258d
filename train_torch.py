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
It trains on one CUDA device unless ``--device cpu`` is given. The
post-training figures of ``train.py`` (``evaluate``) are not ported yet.
Accepted and ignored config keys: ``training.loss_chunks``,
``training.compiler_options``, ``training.zero1``.
"""

import argparse
import os

import torch

from trustedai_cl_vae_ad_tpu_torch.config import load_config, stamp_logdir, validate_config
from trustedai_cl_vae_ad_tpu_torch.data.loader import load_data
from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config
from trustedai_cl_vae_ad_tpu_torch.train.checkpoint import has_optimizer
from trustedai_cl_vae_ad_tpu_torch.train.loop import load_train_state, train_model


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config_filename", type=str, help="YAML configuration file")
    parser.add_argument("--dry-run", action="store_true", help="Quit before executing training")
    parser.add_argument("--resume", type=str, default=None, metavar="LOGDIR",
                        help="Resume from a previous log dir (weights and Adam moments)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; never falls back to cpu)")
    parser.add_argument("--seed", type=int, default=0,
                        help="Seed of the initial weights and of the training noise")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        parser.error(f"--device {args.device}: no CUDA device is available "
                     "(pass --device cpu to train on the CPU)")
    return args


def main(argv=None):
    args = get_args(argv)
    print(f"torch {torch.__version__}, device: {args.device}")

    config = validate_config(load_config(args.config_filename))
    stamp_logdir(config)
    print(f"Log dir: {config['logdir']}")

    # training shuffles per epoch; the analysis tools use load_data's
    # deterministic default
    config["data"].setdefault("shuffle", True)

    data = load_data(config, device=args.device)
    model = load_model_from_config(config, seed=args.seed, device=args.device)
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
        return
    train_model(config, model, data, initial_epoch=initial_epoch, initial_step=initial_step)
    print(f"Saved: {os.path.join(config['logdir'], 'encoder')} (+ decoder, optimizer); "
          "the evaluation figures of train.py are not ported yet")


if __name__ == "__main__":
    main()
