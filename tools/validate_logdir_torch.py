#!/usr/bin/env python3
"""Log-directory doctor (PyTorch port): check a checkpoint directory against the whole layout.

A log directory holds ``config.yml`` beside ``encoder/`` and ``decoder/``
(the reference's layout) and the additions of this project: ``optimizer/``
(Adam moments, for a true resume), ``train_state.json`` (the schedule's
sidecar), ``quantized/`` (the int8 serving boot), ``replay_buffer_paths.csv``
(continual learning's replay provenance), and the crash-atomic ``rounds/``
behind ``current``. Each piece can drift in a way that a tool finds only at
boot, minutes into a flagship load: a missing piece, a config that no longer
builds, weights whose shapes the config does not imply, an int8 sidecar left
stale by a retrain. This tool checks all of it up front, without reading the
weight payloads (possibly many GB), and without touching a device: it is safe
to run beside a live training or serving process.

It reads both layouts that the port loads: its own (``params.pt`` /
``state.pt``, opened memory-mapped for their shapes and dtypes) and the JAX
package's (orbax checkpoints, whose leaves' metadata only tensorstore reads).
Where tensorstore does not import, a JAX-layout directory is an error, as it
is for ``registry.load_model_from_directory`` on that machine:
``tools/convert_logdir_torch.py`` makes a copy that torch alone loads.

Messages name a leaf by its state-dict key (``encoder.layers.Conv_0.weight``)
and give its shape in the port's layout.

Usage: python tools/validate_logdir_torch.py <log_dir> [--strict] [--json]

Exit code 0: usable for inference (no errors); 2: errors, or with --strict
warnings too (missing optimizer state, a stale quantized sidecar, ...).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def validate_logdir(log_dir: str) -> dict:
    """Return {"errors": [...], "warnings": [...], "info": {...}}.

    Errors make the directory unusable for inference; warnings degrade one
    capability (resume, the int8 boot, the schedule's continuation) while
    scoring works. No weight payload is read and no device is used: the
    expected shapes come from the config's model built on the ``meta``
    device."""
    errors: list = []
    warnings: list = []
    info: dict = {}
    report = {"errors": errors, "warnings": warnings, "info": info}

    if not os.path.isdir(log_dir):
        errors.append(f"not a directory: {log_dir}")
        return report

    # -- config.yml must parse AND build the model (the shapes' source of truth)
    config_path = os.path.join(log_dir, "config.yml")
    if not os.path.exists(config_path):
        errors.append("config.yml missing (every loader needs it: "
                      "registry.load_model_from_directory)")
        return report
    try:
        from trustedai_cl_vae_ad_tpu_torch.config import load_config
        from trustedai_cl_vae_ad_tpu_torch.registry import build_core_from_config

        config = load_config(config_path)
        core = build_core_from_config(config, device="meta")
        info["model_type"] = config.get("model", {}).get("type", "KurtosisGlobal")
        info["latent_dimensions"] = int(config["model"]["latent_dimensions"])
        info["image_size"] = list(config["data"]["image_size"])
    except Exception as e:  # noqa: BLE001 - any failure to build is the finding
        errors.append(f"config.yml does not build a model: {e!r}")
        return report

    # -- expected leaves from the config: the meta-device module allocates nothing
    expected = {part: {key: (tuple(t.shape), t.dtype) for key, t in core.state_dict().items()
                       if key.startswith(part + ".")}
                for part in ("encoder", "decoder")}

    # -- the rounds layout (crash-atomic saves): restoring reads the newest
    # COMPLETE round; report which, and flag interrupted saves
    from trustedai_cl_vae_ad_tpu_torch.train.checkpoint import (
        ROUNDS_SUBDIR,
        _complete_rounds,
        _subtree_layout,
        has_optimizer,
        param_specs,
        resolve_round_dir,
    )

    base = resolve_round_dir(log_dir)
    rounds_path = os.path.join(log_dir, ROUNDS_SUBDIR)
    rounds = _complete_rounds(rounds_path)
    if rounds:
        info["layout"] = "rounds"
        info["rounds_complete"] = len(rounds)
        info["round_selected"] = os.path.basename(base)
        stale_tmp = [n for n in os.listdir(rounds_path) if n.startswith(".tmp-")]
        if stale_tmp:
            warnings.append(
                f"{len(stale_tmp)} interrupted save round(s) in rounds/ "
                f"(e.g. {stale_tmp[0]}) — a save was killed or failed "
                "mid-write; harmless (never selected by restore, swept at "
                "the next save)")
        cur = os.path.join(log_dir, "current")
        newest = rounds[-1][1]
        if os.path.isdir(cur) and not os.path.islink(cur):
            # a copy that followed symlinks (cp -r, rsync without -l,
            # shutil.copytree) makes 'current' a real directory: a healthy
            # copy, not an interrupted save; the next save swaps a symlink in
            warnings.append(
                "'current' is an in-place directory (symlink-following "
                "copy) — restore uses the newest complete round "
                f"({newest}); the next save restores the pointer")
        else:
            cur_name = (os.path.basename(os.readlink(cur).rstrip("/"))
                        if os.path.islink(cur) else None)
            if cur_name != newest:
                warnings.append(
                    f"'current' pointer is {cur_name or 'missing'} but the "
                    f"newest complete round is {newest} — a save was "
                    "interrupted between commit and pointer swap; restore "
                    f"uses {os.path.basename(base)} (the pointer's round "
                    "when valid, else the newest complete round)")
        for sub in ("encoder", "decoder", "optimizer"):
            p = os.path.join(log_dir, sub)
            if os.path.isdir(p) and not os.path.islink(p):
                warnings.append(
                    f"{sub}/ is an in-place directory but rounds/ also "
                    "exists — restore prefers the newest complete round; "
                    "the next save upgrades this to a symlink")
    else:
        info["layout"] = "legacy"

    # -- encoder/ decoder/: present, and every leaf's shape as the config implies
    from trustedai_cl_vae_ad_tpu_torch.train.orbax_read import import_tensorstore

    orbax_path = None
    for sub in ("encoder", "decoder"):
        path = os.path.join(base, sub)
        if not os.path.isdir(path):
            errors.append(f"{sub}/ checkpoint missing")
            continue
        try:
            got = param_specs(log_dir, parts=(sub,))
        except Exception as e:  # noqa: BLE001 - an unreadable subtree is the finding
            errors.append(f"{sub}/ checkpoint unreadable: {e!r}")
            continue
        if _subtree_layout(path, sub) == "orbax":
            orbax_path = path
        dtype_drift = []
        for key, (want_shape, want_dtype) in expected[sub].items():
            if key not in got:
                errors.append(f"{sub}: leaf {key} missing from checkpoint")
                continue
            shape, dtype = got[key]
            if shape != want_shape:
                errors.append(
                    f"{sub}: {key} shape {shape} != config-derived "
                    f"{want_shape} (config/weights drift)")
            elif dtype is not None and dtype != want_dtype:
                dtype_drift.append((key, _dtype_name(dtype), _dtype_name(want_dtype)))
        if dtype_drift:
            key0, got0, want0 = dtype_drift[0]
            warnings.append(
                f"{sub}: {len(dtype_drift)} leaf dtype(s) differ from the "
                f"config-derived tree (e.g. {key0}: checkpoint {got0} vs config "
                f"{want0}) — saved under a different training.precision; "
                "loaders restore the checkpoint dtype")
        extra = set(got) - set(expected[sub])
        if extra:
            warnings.append(f"{sub}: {len(extra)} extra leaves not in the "
                            f"config-derived tree (e.g. {sorted(extra)[:2]})")
    if orbax_path is not None:
        try:
            import_tensorstore(orbax_path)
        except ImportError as e:
            errors.append(f"the port cannot load this directory here: {e}")

    # -- optimizer/ (resume capability), in either layout
    if has_optimizer(log_dir):
        info["optimizer_state"] = True
    else:
        info["optimizer_state"] = False
        warnings.append("optimizer/ missing — --resume restarts Adam moments "
                        "(reference behavior; harmless for inference)")

    # -- train_state.json (the schedule's resume sidecar)
    ts_path = os.path.join(log_dir, "train_state.json")
    if os.path.exists(ts_path):
        try:
            with open(ts_path) as f:
                ts = json.load(f)
            if not isinstance(ts, dict):
                raise ValueError(f"top level is {type(ts).__name__}, not an object")
            info["train_state"] = {k: ts.get(k) for k in
                                   ("epochs_completed", "step", "beta")}
            max_epochs = int(config.get("training", {}).get("max_epochs", 0))
            if max_epochs and int(ts.get("epochs_completed", 0) or 0) > max_epochs:
                warnings.append(
                    f"train_state.json epochs_completed "
                    f"{ts['epochs_completed']} > training.max_epochs "
                    f"{max_epochs} — --resume will train 0 epochs")
        except (ValueError, KeyError, TypeError, OSError) as e:
            warnings.append(f"train_state.json unreadable ({e!r}) — "
                            "--resume falls back to a full restart")
    else:
        warnings.append("train_state.json missing — --resume restores weights "
                        "but restarts the epoch/beta schedule")

    # -- quantized/ int8 serving sidecar: stale against the float weights?
    # The verdict of the int8 boot (ops/quant.py::quantized_staleness):
    # content-based evidence first, filesystem mtimes as the last resort.
    from trustedai_cl_vae_ad_tpu_torch.ops.quant import QUANTIZED_SUBDIR, quantized_staleness

    qdir = os.path.join(log_dir, QUANTIZED_SUBDIR)
    if os.path.isdir(qdir):
        info["quantized"] = True
        verdict = quantized_staleness(log_dir)
        if verdict is not None:
            warnings.append(f"{verdict[1]} — --quantize boots/serves pre-retrain weights; "
                            "re-run tools/quantize_checkpoint_torch.py")
    else:
        info["quantized"] = False

    # -- replay provenance (CL resume)
    rp = os.path.join(log_dir, "replay_buffer_paths.csv")
    if os.path.exists(rp):
        # csv's first column, as csv.writer wrote it (stream/engine.py): a raw
        # line would keep the quoting of a path with a comma and call it
        # missing. The engine's reader filters to existing files, which is
        # what this check diagnoses, so it is not used here.
        with open(rp, newline="") as f:
            paths = [row[0] for row in csv.reader(f) if row and row[0].strip()]
        missing = [p for p in paths if not os.path.exists(p)]
        info["replay_paths"] = len(paths)
        if missing:
            warnings.append(f"replay provenance lists {len(missing)} missing "
                            f"file(s) (e.g. {missing[0]}) — CL resume will "
                            "skip them")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("log_dir")
    ap.add_argument("--strict", action="store_true",
                    help="non-zero exit on warnings too")
    ap.add_argument("--json", action="store_true", help="machine-readable")
    args = ap.parse_args(argv)

    report = validate_logdir(args.log_dir)
    if args.json:
        print(json.dumps(report, indent=1, default=str))
    else:
        for e in report["errors"]:
            print(f"ERROR: {e}")
        for w in report["warnings"]:
            print(f"warning: {w}")
        for k, v in report["info"].items():
            print(f"{k}: {v}")
        verdict = ("UNUSABLE" if report["errors"] else
                   "usable (with warnings)" if report["warnings"] else "healthy")
        print(f"=> {args.log_dir}: {verdict}")
    bad = bool(report["errors"]) or (args.strict and report["warnings"])
    return 2 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
