"""Traffic of kind ``train_steps``: a closed loop of training steps, back to back.

Drives the call that ``train/loop.py::train_model`` makes a step,
``VAEModel.train_step(batch, eps=)``, with the optimizer that ``compile()`` attaches
for the configuration. One epoch of ``batches_in_epoch`` distinct batches of the
configuration's batch size, made from the seed, stays on the device (as
``data.device_cache`` serves the epochs after the first) and the steps cycle
through it, each with its own latent noise; the loss is fetched to the host every
``fetch_every`` steps, as ``log_every`` does.

Set-up runs the first ``checked_steps`` steps through that same call and feed, on
batches that all differ, and reads from the program what the reference follows: each
step's loss, each leaf's first gradient as Adam got it (its first moment after one
step, over 1 - b1), and each leaf's change after those steps (the weights drawn again
from the seed, leaf by leaf). The window then goes on from the same model.

Parameters (``perfbench/traffic/<mix>.json``): ``batches_in_epoch``, ``fetch_every``,
``checked_steps``, ``traced_steps``, ``frames`` {``grid``, ``noise``}.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from perfbench import inputs
from perfbench.harness import WINDOW_RANGE, Window
from perfbench.reference import cvae as ref

#: ranges the traced stretch puts around calls into the program
STEP, LOSS, OPTIMIZER, FETCH = "pb.step", "pb.loss", "pb.optimizer", "pb.fetch"


@dataclass
class State:
    cell: object
    seed: int
    device: str
    model: object
    batches: torch.Tensor  # (n, B, H, W, C) uint8
    eps: torch.Tensor      # (n, B, latent)
    steps: int = 0         # steps taken so far, set-up's included
    readings: Dict[str, object] = field(default_factory=dict)
    memory_peak: int = 0
    fetched: List[float] = field(default_factory=list)


def _sync(device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


def _leaf_norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0) -> Dict[str, float]:
    norms = {k: torch.linalg.vector_norm(t.detach().float()) * scale for k, t in tensors.items()}
    return {k: float(v) for k, v in norms.items()}


def _change_norms(params: Dict[str, torch.Tensor], config: dict, seed: int) -> Dict[str, float]:
    """Each leaf's distance from the weights the seed draws, drawn again leaf by leaf."""
    out = {}
    for i, leaf in enumerate(ref.param_spec(config)):
        p = params[leaf.name].detach()
        start = inputs.make_leaf(leaf, i, seed, p.device)
        out[leaf.name] = float(torch.linalg.vector_norm(p - start))
        del start
    return out


def setup(cell, seed: int, device: str) -> State:
    from trustedai_cl_vae_ad_tpu_torch.config import validate_config
    from trustedai_cl_vae_ad_tpu_torch.models.wrapper import VAEModel
    from trustedai_cl_vae_ad_tpu_torch.registry import build_core_from_config

    config = validate_config(cell.config)
    mix = cell.traffic
    core = build_core_from_config(config).to_empty(device=device)
    inputs.fill_program_params(core.named_parameters(), config, seed)
    model = VAEModel(core, device, seed=inputs.sub_seed(seed, 3))
    model.compile()
    batch = int(config["training"]["batch_size"])
    n = int(mix["batches_in_epoch"])
    batches = inputs.train_epoch(seed, n, batch, config["data"]["image_size"],
                                 mix["frames"]["grid"], mix["frames"]["noise"], device)
    eps = inputs.latent_noise(seed, n, batch, int(config["model"]["latent_dimensions"]), device)
    state = State(cell, seed, device, model, batches, eps)

    losses = []
    for s in range(int(mix["checked_steps"])):
        losses.append(_step(state)["loss"].detach())
        if s == 0:
            opt = model.optimizer
            state.readings["first_grad_norms"] = _leaf_norms(
                {k: opt.full_moment("mu", k) for k in opt.names}, 1.0 / ref.ONE_MINUS_B1)
    state.readings["losses"] = [float(v) for v in losses]
    state.readings["change_norms"] = _change_norms(dict(model.core.named_parameters()),
                                                   config, seed)
    _sync(device)
    return state


def _step(state: State) -> dict:
    i = state.steps % state.batches.shape[0]
    loss = state.model.train_step(state.batches[i], eps=state.eps[i])
    state.steps += 1
    return loss


def window(state: State, seconds: float) -> Window:
    fetch_every = int(state.cell.traffic["fetch_every"])
    cuda = state.device != "cpu"
    _sync(state.device)
    if cuda:
        state.memory_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    steps = 0
    t0 = time.perf_counter()
    while True:
        loss = _step(state)
        steps += 1
        if steps % fetch_every == 0:
            state.fetched.append(float(loss["loss"]))
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(state.device)
    elapsed = time.perf_counter() - t0
    values = {"train_frames_per_s": steps * state.batches.shape[1] / elapsed}
    if cuda:
        peak = torch.cuda.max_memory_allocated()
        values["peak_mem_gib"] = peak / 2 ** 30
        state.memory_peak = max(state.memory_peak, peak)
    failed = sum(1 for v in state.fetched if v != v or v in (float("inf"), float("-inf")))
    return Window(values, attempted=steps, failed=failed)


def _wrap(name: str, fn):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def traced(state: State):
    """``traced_steps`` more steps under the profiler, with ranges around the loss (the
    forward with it) and around the optimizer's step, installed on the instances for
    this stretch only. Returns (Trace, frames a step)."""
    from perfbench.harness import read_trace

    model = state.model
    model.core.compute_loss = _wrap(LOSS, model.core.compute_loss)
    model.optimizer.step = _wrap(OPTIMIZER, model.optimizer.step)
    n = int(state.cell.traffic["traced_steps"])
    activities = [torch.profiler.ProfilerActivity.CPU]
    if state.device != "cpu":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        _sync(state.device)
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function(WINDOW_RANGE):
                for _ in range(n):
                    with torch.profiler.record_function(STEP):
                        loss = _step(state)
                with torch.profiler.record_function(FETCH):
                    float(loss["loss"])
                _sync(state.device)
    finally:
        del model.core.compute_loss, model.optimizer.step
    return read_trace(prof, n), int(state.batches.shape[1])


# -- correctness -------------------------------------------------------------------------
def _reference_run(state: State, tf32: bool, rows: Optional[int] = None) -> dict:
    """The reference over the checked steps' batches and noise, from the weights the
    seed draws; ``rows`` keeps only the first rows of each batch (a fault)."""
    config, n = state.cell.config, int(state.cell.traffic["checked_steps"])
    k = state.batches.shape[0]
    batches = [state.batches[s % k][:rows] for s in range(n)]
    eps = [state.eps[s % k][:rows] for s in range(n)]
    params = inputs.reference_params(config, state.seed, state.device)
    with ref.tf32(tf32):
        run = ref.train_steps(params, config, batches, eps)
    change = _change_norms(params, config, state.seed)
    del params
    if state.device != "cpu":
        torch.cuda.empty_cache()
    return {"losses": run.losses, "first_grad_norms": run.first_grad_norms,
            "change_norms": change}


#: a leaf whose first gradient in the reference is under this share of the median leaf's
#: is rounding, and moves under Adam by round-off alone: its change is not compared
STILL_LEAF = 1e-3


def compare(prog: dict, reference: dict) -> Dict[str, object]:
    """loss_gap: the largest relative gap of a step's loss. grad_gap, change_gap: by the
    worst leaf, the gap between the program's norm and the reference's, over the larger
    of that leaf's reference norm and the median leaf's. Also each leaf's gaps, which
    ``readings.py`` prints to show which leaf is the worst."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], reference["losses"]))
    g_ref = reference["first_grad_norms"]
    median_g = statistics.median(g_ref.values())

    def leaf_gaps(p: dict, r: dict, names) -> Dict[str, float]:
        med = statistics.median(r[k] for k in names)
        return {k: abs(p[k] - r[k]) / max(r[k], med) for k in names}

    moving = [k for k, v in g_ref.items() if v >= STILL_LEAF * median_g]
    grads = leaf_gaps(prog["first_grad_norms"], g_ref, list(g_ref))
    change = leaf_gaps(prog["change_norms"], reference["change_norms"], moving)
    return {"loss_gap": loss_gap, "grad_gap": max(grads.values()),
            "change_gap": max(change.values()),
            "leaf_grad_gaps": grads, "leaf_change_gaps": change}


def check(state: State, variants=("program",)) -> Dict[str, Dict[str, float]]:
    """Free the program, run the reference, and compare with it each variant's readings:
    ``program`` (the program's), ``control`` (the reference with TF32 products),
    ``half_batch`` (the reference on the first half of each batch)."""
    state.model = None
    state.batches = state.batches[:int(state.cell.traffic["checked_steps"])]
    state.eps = state.eps[:int(state.cell.traffic["checked_steps"])]
    if state.device != "cpu":
        torch.cuda.empty_cache()
    reference = _reference_run(state, tf32=False)
    out = {}
    for v in variants:
        if v == "program":
            readings = state.readings
        elif v == "control":
            readings = _reference_run(state, tf32=True)
        elif v == "half_batch":
            readings = _reference_run(state, tf32=False, rows=state.batches.shape[1] // 2)
        else:
            raise ValueError(f"unknown variant {v!r}")
        out[v] = compare(readings, reference)
    return out
