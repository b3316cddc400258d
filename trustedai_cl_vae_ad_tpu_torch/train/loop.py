"""Offline training loop (library side of ``train_torch.py``).

Counterpart of ``trustedai_cl_vae_ad_tpu/train/loop.py``: the epoch loop with
per-epoch validation, per-epoch beta annealing (x0.98), the opt-in learning
rate schedules, metric logging, a stop request (SIGTERM / SIGINT) honoured at
a batch boundary, periodic checkpoints (written in the background with
``training.async_checkpoint``) and the final one, and the training-progress
sidecar that ``--resume`` reads. The post-training figures (``evaluate``)
are not ported yet.
"""

from __future__ import annotations

import json
import math
import os
import signal
import threading
from typing import Optional

import numpy as np

from trustedai_cl_vae_ad_tpu_torch.data.loader import iter_images
from trustedai_cl_vae_ad_tpu_torch.models.wrapper import VAEModel
from trustedai_cl_vae_ad_tpu_torch.utils.metrics import MetricsWriter


class BetaAnnealing:
    """Per-epoch beta decay (rate 0.98)."""

    def __init__(self, rate: float = 0.98):
        self.rate = rate

    def on_epoch_end(self, model: VAEModel) -> None:
        model.beta = model.beta * self.rate


def lr_schedule_fn(config: dict):
    """``training.lr_schedule`` -> ``lr(epoch)`` callable, or None (constant).

    The schedule is a pure function of (base lr, epoch index), so a resumed
    run recomputes the value of its epoch with no extra saved state, and each
    epoch's value lands through ``model.set_learning_rate``.

    Accepted specs (``training.lr_schedule``):
      - ``"reference"`` / ``"exponential"``: hold the base lr, then decay;
        the dict form tunes ``hold_epochs`` (default 10) and ``decay``
        (default 0.1): lr(e) = base * exp(-decay * max(0, e - hold + 1)).
      - ``{"type": "cosine", "decay_epochs": N, "min_fraction": f}``: cosine
        from base to f*base over N epochs (default N = max_epochs, f = 0).
    """
    spec = (config.get("training") or {}).get("lr_schedule")
    if not spec:
        return None
    base = float(config["training"]["learning_rate"])
    if isinstance(spec, str):
        spec = {"type": spec}
    if not isinstance(spec, dict) or "type" not in spec:
        raise ValueError(
            "training.lr_schedule must be a schedule name or a dict with a "
            f"'type' key, got: {spec!r}")
    kind = str(spec["type"]).lower()
    if kind in ("reference", "exponential"):
        hold = int(spec.get("hold_epochs", 10))
        decay = float(spec.get("decay", 0.1))
        return lambda e: base * math.exp(-decay * max(0, int(e) - hold + 1))
    if kind == "cosine":
        total = int(spec.get("decay_epochs", config["training"]["max_epochs"]))
        lo = float(spec.get("min_fraction", 0.0))

        def _cosine(e: int) -> float:
            t = min(max(int(e), 0), total) / max(total, 1)
            return base * (lo + (1.0 - lo) * 0.5 * (1.0 + math.cos(math.pi * t)))

        return _cosine
    raise ValueError(f"unknown training.lr_schedule type: {kind!r}")


# -- training-progress sidecar ------------------------------------------------
#
# A checkpoint holds weights and moments; {epochs_completed, step, beta} beside
# it lets --resume continue where the run stopped: the remaining epochs only,
# beta at its annealed value, metric steps numbered continuously.

TRAIN_STATE_FILE = "train_state.json"


def save_train_state(logdir: str, epochs_completed: int, step: int, beta: float) -> None:
    path = os.path.join(logdir, TRAIN_STATE_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(
            {"epochs_completed": int(epochs_completed), "step": int(step),
             "beta": float(beta)}, f)
    os.replace(tmp, path)  # a crash mid-write never corrupts the state


def load_train_state(logdir: str) -> Optional[dict]:
    """The progress sidecar of a previous run, or None."""
    path = os.path.join(logdir, TRAIN_STATE_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        state = json.load(f)
    return {"epochs_completed": int(state.get("epochs_completed", 0)),
            "step": int(state.get("step", 0)),
            "beta": float(state["beta"]) if "beta" in state else None}


def _host(loss: dict) -> dict:
    """Loss dict of device tensors -> floats (waits for the device)."""
    return {k: float(v) for k, v in loss.items()}


def train_model(
    config: dict,
    model: VAEModel,
    data: dict,
    writer: Optional[MetricsWriter] = None,
    beta_annealing: Optional[BetaAnnealing] = None,
    max_epochs: Optional[int] = None,
    log_every: int = 50,
    initial_epoch: int = 0,
    initial_step: int = 0,
) -> VAEModel:
    """Epoch loop over data['train'] with validation on data['val'].

    ``initial_epoch`` / ``initial_step`` continue a resumed run:
    ``max_epochs`` stays the TOTAL target, so a run resumed after k epochs
    trains ``max_epochs - k`` more.
    """
    logdir = config.get("logdir", ".")
    training = config.get("training") or {}
    epochs = int(max_epochs if max_epochs is not None else training["max_epochs"])
    if beta_annealing is None:
        beta_annealing = BetaAnnealing()
    owns_writer = writer is None
    if writer is None:
        writer = MetricsWriter(logdir)
    if model.optimizer is None:
        model.compile()
    # training.async_checkpoint (opt-in): a periodic save returns once the
    # state is copied off the live tensors and the files are written by a
    # background thread, so the loop goes on training. The sidecar becomes a
    # commit callback: it still lands only after the weights do.
    async_saver = None
    if training.get("async_checkpoint"):
        from trustedai_cl_vae_ad_tpu_torch.train.checkpoint import AsyncSaver

        async_saver = AsyncSaver()

    step = int(initial_step)
    # SIGTERM (eviction, `timeout`) ends Python without running finally
    # blocks, and an interrupt raised in the middle of a step would save
    # parameters from one step with moments from another. So the handler only
    # RECORDS the request; the loop raises KeyboardInterrupt at the next
    # batch boundary, where the state is whole. A second signal raises at
    # once (the step in flight is then lost, deliberately). Handlers can only
    # be installed from the main thread; elsewhere signals keep their stock
    # delivery.
    stop = {"n": 0}

    def _request_stop(_sig, _frm):
        stop["n"] += 1
        if stop["n"] >= 2:
            raise KeyboardInterrupt

    prev_handlers = []
    if threading.current_thread() is threading.main_thread():
        for s in (signal.SIGTERM, signal.SIGINT):
            prev_handlers.append((s, signal.getsignal(s)))
            signal.signal(s, _request_stop)
    # (epochs_completed, beta at that boundary), updated in ONE assignment
    # after each anneal: an interrupt between the anneal and the bookkeeping
    # must not save an annealed beta with the epoch marked incomplete, or a
    # resume would re-run the epoch and anneal twice.
    progress = (int(initial_epoch), float(model.beta))
    # periodic checkpoints cover what no handler can (SIGKILL, a lost node)
    ckpt_every = int(training.get("checkpoint_every_epochs", 0) or 0)
    lr_sched = lr_schedule_fn(config)
    try:
        for epoch in range(int(initial_epoch), epochs):
            if lr_sched is not None:
                model.set_learning_rate(lr_sched(epoch))
            for batch in iter_images(data["train"]):
                loss = model.train_step(batch)
                if step % log_every == 0:
                    writer.log(step, _host(loss), prefix="train/")
                step += 1
                if stop["n"]:  # deferred SIGTERM/SIGINT: the state is whole here
                    raise KeyboardInterrupt
            if data.get("val") is not None:
                val_losses = []
                for batch in iter_images(data["val"]):
                    val_losses.append(_host(model.test_step(batch)))
                    if stop["n"]:
                        raise KeyboardInterrupt
                if val_losses:
                    mean_val = {
                        k: float(np.mean([d[k] for d in val_losses])) for k in val_losses[0]
                    }
                    writer.log(step, mean_val, prefix="val/")
            beta_annealing.on_epoch_end(model)
            progress = (epoch + 1, float(model.beta))
            epoch_log = {"beta": model.beta, "epoch": epoch}
            if lr_sched is not None:
                epoch_log["learning_rate"] = model.learning_rate
            writer.log(step, epoch_log, prefix="train/")
            if ckpt_every and (epoch + 1) % ckpt_every == 0 and (epoch + 1) < epochs:
                # the sidecar only after the weights land, as in the final save
                if async_saver is not None:
                    model.save_model(logdir, saver=async_saver)
                    # bound to THIS round's values; runs when the round commits
                    async_saver.add_commit_callback(
                        lambda e=progress[0], s=step, b=progress[1]:
                        save_train_state(logdir, e, s, b))
                else:
                    model.save_model(logdir)
                    save_train_state(logdir, progress[0], step, progress[1])
            if stop["n"]:  # the signal landed during validation or a save
                raise KeyboardInterrupt
    except KeyboardInterrupt:
        print("Keyboard Interrupt")
    finally:
        # any failure in an epoch still checkpoints the progress. A stop in
        # the middle of an epoch counts that epoch as NOT completed (a resume
        # re-runs it) and saves the last epoch BOUNDARY's beta. The sidecar is
        # written only AFTER the weights were saved (a sidecar recording
        # progress the saved weights never trained would make --resume skip
        # epochs); the writer closes regardless.
        try:
            if async_saver is not None:
                # drain the periodic write in flight (and its sidecar) before the
                # final synchronous save stages the next round. A FAILED
                # background write must not skip that save: its round never
                # committed, so a fresh synchronous save leaves a consistent logdir
                try:
                    async_saver.wait()
                except Exception as e:  # noqa: BLE001 - any writer failure ends up here
                    print(f"WARNING: async periodic checkpoint failed ({e}); "
                          "writing a final synchronous save")
            model.save_model(logdir)
            save_train_state(logdir, progress[0], step, progress[1])
        finally:
            if async_saver is not None:
                try:
                    async_saver.close()
                except Exception as e:  # noqa: BLE001 - never mask the primary failure
                    print(f"WARNING: async checkpoint saver close failed: {e}")
            for s, h in prev_handlers:
                signal.signal(s, h if h is not None else signal.SIG_DFL)
            if owns_writer:
                writer.close()
    return model
