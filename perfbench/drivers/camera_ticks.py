"""Traffic of kind ``camera_ticks``: a closed loop of multi-camera ticks.

Drives ``stream/multicam.py::MultiCameraEngine.process_frames`` directly, with the
engine's defaults but for what the mix sets under ``engine``. ``streams`` cameras
each deliver ``frames_per_stream`` frames of ``frame_size`` uint8, made from the seed:
a scene of their own that drifts by ``motion`` pixels a frame, plus pixel noise.
The frames sit in host memory and are replayed in order, a tick the next frame of
every camera; the engine's device resize brings them to the model's size. Each tick
is timed from the call to its return (its score fetch waits for the device).

Set-up runs the engine's own warm-up and ``warm_ticks`` ticks of the sequence. Every
tick, set-up's and the traced stretch's included, is checked: each stream's score and
count, the scorer's state at the end, and, on ticks drawn from the seed, the uint8
maps of the normalised error and of the reconstruction. The reference replays the
whole sequence from the frames and the weights the seed draws.

Parameters (``perfbench/traffic/<mix>.json``): ``streams``, ``frames_per_stream``,
``frame_size``, ``motion``, ``frames`` {``grid``, ``noise``}, ``warm_ticks``,
``traced_ticks``, ``sample_share``, and optionally ``engine``: keyword arguments of the
engine. The reference reads the engine's error moving average from the engine as
built, and follows no other engine argument.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import inputs
from perfbench.harness import WINDOW_RANGE, Window
from perfbench.reference import cvae as ref
from perfbench.reference import scorer

TICK, LAUNCH, FORWARD, RESIZE, SCORE, EMIT = (
    "pb.tick", "pb.launch", "pb.forward", "pb.resize", "pb.score", "pb.emit")
#: the seed's stream of the draw of the checked ticks
SAMPLES = 4


@dataclass
class State:
    cell: object
    seed: int
    device: str
    engine: object
    frames: np.ndarray            # (T, K, H, W, C) uint8, host memory
    ticks: List[list]             # per frame index, the K frames of a tick
    rng: np.random.Generator      # draws the checked ticks, tick by tick
    alpha: float                  # the engine's error moving average, as built
    scores: List[list] = field(default_factory=list)
    counts: List[list] = field(default_factory=list)
    samples: Dict[int, tuple] = field(default_factory=dict)  # tick -> (norm u8, rec u8)
    memory_peak: int = 0
    missing: int = 0              # streams a tick returned no result for


def _model(cell, seed: int, device: str):
    from trustedai_cl_vae_ad_tpu_torch.config import validate_config
    from trustedai_cl_vae_ad_tpu_torch.models.wrapper import VAEModel
    from trustedai_cl_vae_ad_tpu_torch.registry import build_core_from_config

    config = validate_config(cell.config)
    core = build_core_from_config(config).to_empty(device=device)
    inputs.fill_program_params(core.named_parameters(), config, seed)
    return VAEModel(core, device, seed=inputs.sub_seed(seed, 3))


def setup(cell, seed: int, device: str) -> State:
    from trustedai_cl_vae_ad_tpu_torch.stream.multicam import MultiCameraEngine

    mix = cell.traffic
    model = _model(cell, seed, device)
    k = int(mix["streams"])
    engine = MultiCameraEngine(model, cell.config, n_streams=k, **mix.get("engine", {}))
    frames = inputs.camera_frames(seed, k, int(mix["frames_per_stream"]), mix["frame_size"],
                                  mix["frames"]["grid"], mix["frames"]["noise"], mix["motion"],
                                  device)
    state = State(cell, seed, device, engine, frames, [list(f) for f in frames],
                  np.random.default_rng(inputs.sub_seed(seed, SAMPLES)),
                  float(engine.stream_error_ma))
    engine.warmup(frame_shape=tuple(mix["frame_size"]))
    for _ in range(int(mix["warm_ticks"])):
        _tick(state)
    return state


def _tick(state: State):
    t = len(state.scores)
    out = state.engine.process_frames(state.ticks[t % len(state.ticks)], tag=t)
    _record(state, t, out)
    return out


def _record(state: State, t: int, out: list) -> None:
    state.scores.append([math.nan if o is None else o.score for o in out])
    state.counts.append([math.nan if o is None else o.pixel_count for o in out])
    state.missing += sum(o is None for o in out)
    if state.rng.random() < float(state.cell.traffic["sample_share"]):
        _keep(state, t, out)


def _keep(state: State, t: int, out: list) -> None:
    """A checked tick's maps, fetched to the host at once (through the results' own
    properties), so that the device holds nothing more than the program does."""
    state.samples[t] = (np.stack([o.norm_err_u8 for o in out]),
                        np.stack([o.reconstruction_u8 for o in out]))


def window(state: State, seconds: float) -> Window:
    cuda = state.device != "cpu"
    if cuda:
        torch.cuda.synchronize()
        state.memory_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    k, lat, missing = len(state.ticks[0]), [], state.missing
    t0 = time.perf_counter()
    while True:
        t = len(state.scores)
        a = time.perf_counter()
        out = state.engine.process_frames(state.ticks[t % len(state.ticks)], tag=t)
        b = time.perf_counter()
        lat.append(b - a)
        _record(state, t, out)
        if b - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    _keep(state, len(state.scores) - 1, out)  # the window's last tick is always checked
    values = {"camera_frames_per_s": k * len(lat) / elapsed,
              "tick_ms_p95": float(np.percentile(np.asarray(lat) * 1e3, 95))}
    if cuda:
        peak = torch.cuda.max_memory_allocated()
        values["peak_mem_gib"] = peak / 2 ** 30
        state.memory_peak = max(state.memory_peak, peak)
    return Window(values, attempted=len(lat) * k, failed=state.missing - missing)


def _wrap(name: str, fn):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def traced(state: State):
    """``traced_ticks`` more ticks under the profiler, with ranges around the engine's
    device step (upload and launches), the resize, the forward, the scorer's launch and
    the host's side of the tick (fetch and state machines), installed on the engine and
    on the modules it calls for this stretch only; what the tick does outside them is
    the batch's assembly on the host. Returns (Trace, frames a tick)."""
    from trustedai_cl_vae_ad_tpu_torch.ops import stream_score
    from trustedai_cl_vae_ad_tpu_torch.stream import multicam

    from perfbench.harness import read_trace

    engine = state.engine
    score_fn, resize_fn = stream_score.stream_score_step_batched, multicam.resize_images
    stream_score.stream_score_step_batched = _wrap(SCORE, score_fn)
    multicam.resize_images = _wrap(RESIZE, resize_fn)
    forward_fn = engine._forward  # an attribute of the instance
    engine._forward = _wrap(FORWARD, forward_fn)
    engine._emit = _wrap(EMIT, engine._emit)
    engine._step = _wrap(LAUNCH, engine._step)
    n = int(state.cell.traffic["traced_ticks"])
    activities = [torch.profiler.ProfilerActivity.CPU]
    if state.device != "cpu":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function(WINDOW_RANGE):
                for _ in range(n):
                    with torch.profiler.record_function(TICK):
                        _tick(state)
                if state.device != "cpu":
                    torch.cuda.synchronize()
    finally:
        stream_score.stream_score_step_batched = score_fn
        multicam.resize_images = resize_fn
        engine._forward = forward_fn
        del engine._emit, engine._step
    return read_trace(prof, n), len(state.ticks[0])


# -- correctness -------------------------------------------------------------------------
def _program_readings(state: State) -> dict:
    engine = state.engine
    return {"scores": np.asarray(state.scores, np.float64),
            "counts": np.asarray(state.counts, np.float64),
            "norm_u8": {t: maps[0] for t, maps in state.samples.items()},
            "rec_u8": {t: maps[1] for t, maps in state.samples.items()},
            "maps": engine.maps.detach().cpu().numpy().astype(np.float64),
            "scalars": engine.scalars.detach().cpu().numpy().astype(np.float64)}


def _reference_run(state: State, n_ticks: int, samples, tf32: bool) -> dict:
    """The reference's replay of the first ``n_ticks`` ticks: the forward of each
    distinct tick of frames (at the tick's batch), then the scorer tick by tick."""
    config, device = state.cell.config, state.device
    h, w, _ = (int(v) for v in config["data"]["image_size"])
    params = inputs.reference_params(config, state.seed, device)
    latent = int(config["model"]["latent_dimensions"])
    xs, recs = [], []
    with torch.no_grad(), ref.tf32(tf32):
        for f in state.frames:
            x = torch.from_numpy(f).to(device).to(torch.float32) / 255.0
            x = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                              antialias=True, align_corners=False).permute(0, 2, 3, 1)
            x = x.contiguous()
            eps = torch.zeros((x.shape[0], latent), device=device)
            xs.append(x)
            recs.append(ref.forward(params, config, x, eps)[0].contiguous())
    del params
    k = xs[0].shape[0]
    maps, scalars = scorer.init_state(k, h, w, device)
    scores, counts, norm_u8, rec_u8 = [], [], {}, {}
    with torch.no_grad():
        for t in range(n_ticks):
            x, rec = xs[t % len(xs)], recs[t % len(recs)]
            maps, scalars, norm, score, count = scorer.score_step(maps, scalars, x, rec,
                                                                  state.alpha)
            scores.append(score)
            counts.append(count)
            if t in samples:
                norm_u8[t] = scorer.to_u8(norm).cpu().numpy()
                rec_u8[t] = scorer.to_u8(rec).cpu().numpy()
    out = {"scores": torch.stack(scores).double().cpu().numpy(),
           "counts": torch.stack(counts).double().cpu().numpy(),
           "norm_u8": norm_u8, "rec_u8": rec_u8,
           "maps": maps.double().cpu().numpy(), "scalars": scalars.double().cpu().numpy()}
    del xs, recs
    if device != "cpu":
        torch.cuda.empty_cache()
    return out


def _gaps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b|, 0 where both are NaN, infinite where one is."""
    d = np.abs(a - b)
    return np.where(np.isnan(a) & np.isnan(b), 0.0, np.where(np.isnan(d), np.inf, d))


def compare(prog: dict, reference: dict) -> Dict[str, float]:
    """score_gap, count_gap: the largest gap of a stream's score and count over every
    tick. rec_mismatch, norm_mismatch: the share of grey levels of the checked ticks'
    maps that differ. maps_gap: the largest gap of the final per-pixel state over its
    largest value; range_gap: the largest relative gap of the final min and max EMAs.
    (The count's two EMAs are left out: one pixel's rounding at the threshold moves them
    as much as the control does; the scores, made from them, are compared.)"""
    def mismatch(key):
        ticks = sorted(reference[key])
        return float(np.mean([np.mean(prog[key][t] != reference[key][t]) for t in ticks]))

    r, p = reference["scalars"][:, :2], prog["scalars"][:, :2]
    return {"score_gap": float(_gaps(prog["scores"], reference["scores"]).max()),
            "count_gap": float(_gaps(prog["counts"], reference["counts"]).max()),
            "rec_mismatch": mismatch("rec_u8"), "norm_mismatch": mismatch("norm_u8"),
            "maps_gap": float(_gaps(prog["maps"], reference["maps"]).max())
            / max(float(np.abs(reference["maps"]).max()), 1e-30),
            "range_gap": float(np.max(np.abs(p - r) / np.maximum(np.abs(r), 1e-30)))}


def check(state: State, variants=("program",)) -> Dict[str, Dict[str, float]]:
    """Read the program's outputs, free it, run the reference over the same ticks, and
    compare with it each variant's outputs: ``program`` (the engine's), ``control``
    (the reference's own replay with TF32 products in its forward)."""
    prog = _program_readings(state)
    n_ticks, samples = len(state.scores), set(state.samples)
    state.engine, state.samples = None, {}
    if state.device != "cpu":
        torch.cuda.empty_cache()
    reference = _reference_run(state, n_ticks, samples, tf32=False)
    out = {}
    for v in variants:
        if v == "program":
            readings = prog
        elif v == "control":
            readings = _reference_run(state, n_ticks, samples, tf32=True)
        else:
            raise ValueError(f"unknown variant {v!r}")
        out[v] = compare(readings, reference)
    return out
