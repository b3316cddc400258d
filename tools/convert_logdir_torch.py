#!/usr/bin/env python3
"""Convert a log directory of the JAX package into the PyTorch port's layout.

Usage:
  python tools/convert_logdir_torch.py <jax logdir> <new logdir>

The port reads a JAX log directory as it is (``-m <jax logdir>`` on every
``*_torch.py`` entry point), through ``tensorstore``. This tool writes a copy
that needs torch alone: the round that restoring selects (``current``, else
the newest complete round, else the flat layout) becomes one round of
``train/checkpoint.py::save_checkpoint`` (``encoder/params.pt``,
``decoder/params.pt``, ``optimizer/state.pt`` with the Adam moments, their
step count and the learning rate), each tensor in its stored dtype and bits.
The top-level files (``config.yml``, ``train_state.json``, ...) are copied,
and a ``quantized/`` sidecar is rewritten in the port's format with a
provenance stamp of the new weights, unless the JAX package would call it
stale (``ops/quant.py::quantized_staleness``): a stale sidecar is left out,
with a warning, and ``tools/quantize_checkpoint_torch.py`` makes a fresh
one. The new directory must not lie inside the source, and must be empty or
absent. An ``adam_fp8`` optimizer state keeps each quantized moment's int8
``q`` and float32 ``scale`` and ``scale_next`` (``mu/<key>/q``, ...), in the
port's layout.
"""

import argparse
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(src: str, dst: str, log=print) -> dict:
    """Write ``src`` into ``dst`` in the port's layout; returns what was written."""
    from trustedai_cl_vae_ad_tpu_torch.ops.quant import (
        has_quantized_checkpoint,
        load_quantized_checkpoint,
        quantized_staleness,
        save_quantized_checkpoint,
    )
    from trustedai_cl_vae_ad_tpu_torch.train.checkpoint import (
        has_optimizer,
        resolve_round_dir,
        restore_optimizer_state,
        restore_params,
        save_checkpoint,
    )

    src, dst = os.path.realpath(src), os.path.realpath(dst)
    if dst == src or dst.startswith(src + os.sep):
        raise ValueError(f"refusing to write into the source directory: {dst} is inside {src}")
    if not os.path.isfile(os.path.join(src, "config.yml")):
        raise FileNotFoundError(f"{src}: no config.yml, not a training log directory")
    if os.path.isdir(dst) and os.listdir(dst):
        raise FileExistsError(f"{dst} is not empty")
    params = restore_params(src)
    opt_state = restore_optimizer_state(src) if has_optimizer(src) else None
    os.makedirs(dst, exist_ok=True)
    copied = []
    for name in sorted(os.listdir(src)):
        path = os.path.join(src, name)
        if os.path.isfile(path) and not os.path.islink(path):
            shutil.copy2(path, os.path.join(dst, name))
            copied.append(name)
    save_checkpoint(dst, params, opt_state=opt_state)
    sidecar = None
    if has_quantized_checkpoint(src):
        verdict = quantized_staleness(src)
        if verdict is None:
            sidecar = save_quantized_checkpoint(dst, load_quantized_checkpoint(src, "cpu"))
        else:
            log(f"WARNING: quantized/ not converted: {verdict[1]}; run "
                "tools/quantize_checkpoint_torch.py on the new directory for a fresh one")
    return {"source_round": resolve_round_dir(src), "files": copied,
            "tensors": len(params), "optimizer": opt_state is not None,
            "learning_rate": None if opt_state is None else opt_state["learning_rate"],
            "quantized": sidecar}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("source", help="log directory written by the JAX package")
    parser.add_argument("dest", help="new log directory in the port's layout")
    args = parser.parse_args(argv)
    done = convert(args.source, args.dest)
    print(f"converted {done['source_round']} -> {os.path.realpath(args.dest)}: "
          f"{done['tensors']} tensors, optimizer {done['optimizer']} "
          f"(learning rate {done['learning_rate']}), files {done['files']}, "
          f"quantized {done['quantized']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
