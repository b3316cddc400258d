"""The ``--device`` flag of the port's command-line tools: the card by
default, the CPU only when asked for, and no silent fallback."""

from __future__ import annotations

import argparse

import torch


def add_device_argument(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the tool computes on (default cuda; never falls "
                             "back to cpu)")


def checked_device(parser: argparse.ArgumentParser, device: str) -> torch.device:
    """``device`` as a torch.device; a parser error when it names CUDA and
    no CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        parser.error(f"--device {device}: no CUDA device is available "
                     "(pass --device cpu to run on the CPU)")
    return dev
