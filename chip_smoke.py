#!/usr/bin/env python3
"""Smoke check of the PyTorch port on one NVIDIA GPU.

Runs the port's main paths (trustedai_cl_vae_ad_tpu_torch) on the card, in
phases: live-stream scoring, training of the three model types, and
continual learning in the live engine; any failure raises and the script
exits non-zero without printing its final line.

  (a) device: the card's name and power limit, torch version, TF32 flags;
  (b) build: nvcc builds the stream-scorer and the moments kernels from
      csrc/ into build/, both at once;
  (c) kernel vs its plain PyTorch version on the card, 8-frame sequences at
      224x300x3 and 37x53x3 (constant first frame, seeding, converged state),
      at the tolerances of trustedai_cl_vae_ad_tpu_torch/testing.py, and the
      median time of each over 100 runs (CUDA events);
  (d) a tiny-config engine on cuda vs the same weights on cpu, 16 synthetic
      40x64 frames (the device resize runs);
  (e) the flagship (configs/config.yml, 224x300x3, latent 2000, ~1.34 B
      parameters, seeded random weights) scores 64 synthetic 240x320 frames
      through stream/run.py, as camera_streamer_torch.py does; the kernel's
      launch count must equal the frames scored;
  (f) the moments kernels vs their plain PyTorch versions on the card,
      forward and backward, at (256, 2000) float32 and bfloat16, (768, 2000)
      and a ragged (7, 13): rtol 1e-5 on mean and variance, 1e-4 on skew,
      kurtosis and the gradient (the order of the sums differs), each with
      an absolute floor for values that are differences of large sums; a
      constant input; two runs equal bit for bit; and the median time of
      each over 100 runs (CUDA events);
  (g) a tiny config takes 3 training steps on cuda and, from the same
      weights, batches and latent noise, on cpu: loss dicts at rtol 1e-4 /
      atol 1e-6, parameters within 5% of what three Adam steps can move them
      (cuDNN's backward convolutions sum in another order);
  (h) the flagship trains through the normal entry points: configs/config.yml
      with a synthetic data section (4 batches of 256 frames at 240x320, so
      the device resize runs, 256 validation frames), one epoch, float32,
      load_data -> train_model into a temporary log directory; the losses
      are finite and fall, the moments kernels were launched once per step,
      and the checkpoint reloads to the same validation loss. Then the
      combined train + score step (train/bench_step.py) in bfloat16 with
      adam_lean: 5 warm-up and 10 timed steps. (2 training batches here; the
      two phases below run the same path.)
  (i) the per-dimension moments kernels vs their plain PyTorch versions on
      the card, column by column, forward and backward: (256, 2000) float32
      and bfloat16, a ragged (37, 53), a batch of 1, a constant column among
      random ones, views that are not 16-byte (float32) or 4-byte (bfloat16)
      aligned; tolerances as in (f); two runs equal bit for bit; through
      autograd with the variance row unused; bad inputs raise; and the
      median time of each over 100 runs (CUDA events);
  (j) phase (g) for KurtosisSingle and KLGaussian;
  (k) phase (h) with model.type KurtosisSingle (3 training batches; the
      per-dimension kernels are launched once per step and the global ones
      never), then with KLGaussian (2 batches, w_kl_divergence 1e-4 so that
      the KL term is optimized; no moments kernel is launched);
  (l) continual learning in the live engine at the flagship's size: 8 frames
      on an inference-only engine allocate no optimizer; then 64 synthetic
      240x320 frames through stream/run.py on a 20 frames/s clock with a CL
      period of 1 s and a replay file of 8 generated PNGs, so three CL steps
      run on 16 + 256 rows of which 24 weigh 1; the losses are finite, the
      parameters and the served reconstruction of a fixed frame change.
      Then one CL step each for the other two types at a tiny size.

``--phases b,i`` runs a subset (a build always comes first) and prints no
final line. Before the last line it prints the kernels' JSON line and the nvidia-smi
line; the last line is {"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "trustedai_cl_vae_ad_tpu_torch"
STREAM_KERNEL = {
    "name": "stream_score",
    "route": "cuda",
    "source": f"{PACKAGE}/csrc/stream_score.cu",
    "replaces": "trustedai_cl_vae_ad_tpu/ops/stream_score.py:98",
}
MOMENTS_SOURCE = {"route": "cuda", "source": f"{PACKAGE}/csrc/moments.cu"}
JAX_MOMENTS = "trustedai_cl_vae_ad_tpu/ops/moments.py"
MOMENTS_KERNELS = {
    "global": (f"{JAX_MOMENTS}:77", f"{JAX_MOMENTS}:174"),
    "perdim": (f"{JAX_MOMENTS}:98", f"{JAX_MOMENTS}:210"),
}
# NVIDIA's H100 SXM data sheet: device memory rate, float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
MOMENT_SHAPES = [((256, 2000), "float32"), ((256, 2000), "bfloat16"), ((768, 2000), "float32"),
                 ((7, 13), "float32"), ((7, 13), "bfloat16")]
GRAD_WEIGHTS = (0.3, -0.7, 1.1, 0.9)
PERDIM_SHAPES = [((256, 2000), "float32"), ((256, 2000), "bfloat16"), ((37, 53), "float32"),
                 ((37, 53), "bfloat16"), ((1, 53), "float32")]
VAL_STEPS, BATCH = 1, 256
CL_FRAMES, CL_FPS, CL_PERIOD_MS, CL_REPLAY = 64, 20.0, 1000.0, 8
# phases (d) and (g); every optimized loss term takes part
TINY_CONFIG = {
    "data": {"image_size": [32, 48, 3]},
    "loss": {"kurtosis": 1.8, "w_kl_divergence": 0.0, "w_kurtosis": 1e-2, "w_mse": 1.0,
             "w_skew": 5e-3, "w_z_l1_reg": 1e-3},
    "model": {"type": "KurtosisGlobal", "latent_dimensions": 8, "layers": [4, 8],
              "decoder_dense_filters": 4, "encoder_dense_filters": 16},
    "training": {"batch_size": 8, "beta": 1e-6, "learning_rate": 1e-3, "max_epochs": 1},
}
ALPHA = 0.99


def tiny_config(model_type):
    """TINY_CONFIG with another model type; KLGaussian optimizes its KL term."""
    config = json.loads(json.dumps(TINY_CONFIG))
    config["model"]["type"] = model_type
    if model_type == "KLGaussian":
        config["loss"]["w_kl_divergence"] = 1e-3
    return config
SEQ_SHAPES = [(224, 300, 3), (37, 53, 3)]


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, runs=100, warmup=5):
    import torch

    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(runs)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2]


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over the memory rate and the operations over the float32
    rate."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def queued_ms(fn, runs=100):
    """Device time of one call when the host is out of the way: the card is
    kept busy while ``runs`` calls queue up behind it, so they then run back
    to back. ``median_ms`` above includes the host's time to submit a call,
    which for a kernel of a few microseconds is most of it."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # about 0.1 s at the card's clock
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def time_moments(z, out, gout, forward, plain_forward, backward, plain_backward, library):
    """Times and bounds of a moments kernel pair at z's shape: CUDA-event
    medians of 100, the back-to-back device times, the plain versions, and
    the one PyTorch call that computes half of the forward."""
    record = {
        "ms": median_ms(lambda: forward(z)),
        "plain_ms": median_ms(lambda: plain_forward(z)),
        "device_ms": queued_ms(lambda: forward(z)),
        "bwd_ms": median_ms(lambda: backward(z, out, gout)),
        "bwd_device_ms": queued_ms(lambda: backward(z, out, gout)),
        "plain_bwd_ms": median_ms(lambda: plain_backward(z, out, gout)),
        "library_ms": median_ms(lambda: library(z)),
    }
    n, size = z.numel(), z.element_size()
    # forward: z read once, the moments written; about 2 operations an
    # element for the sum and 8 for the centred powers and their sums
    record["bound_ms"], record["bound_by"] = bound(n * size + 4 * out.numel(), 10 * n)
    # backward: z, the moments and their gradients read, the gradient
    # written; about 14 operations an element
    record["bwd_bound_ms"], record["bwd_bound_by"] = bound(
        2 * n * size + 2 * 4 * out.numel(), 14 * n)
    return record


def log_moments_times(label, record):
    log(f"  {label} median of 100: forward kernel {record['ms']:.4f} ms "
        f"({record['device_ms']:.4f} ms back to back on a full queue), plain "
        f"{record['plain_ms']:.4f} ms, torch.var_mean (half the work) "
        f"{record['library_ms']:.4f} ms, bound {record['bound_ms']:.5f} ms; backward kernel "
        f"{record['bwd_ms']:.4f} ms ({record['bwd_device_ms']:.4f} ms back to back), plain "
        f"{record['plain_bwd_ms']:.4f} ms, bound {record['bwd_bound_ms']:.5f} ms")


def moments_entries(kind, record, launches, bwd_launches):
    """The two lines of the kernels' JSON (forward, backward) of one moments
    kernel pair. No one PyTorch call computes the analytic backward."""
    fwd_line, bwd_line = MOMENTS_KERNELS[kind]
    forward = dict(MOMENTS_SOURCE, name=f"moments_{kind}_forward", replaces=fwd_line,
                   launches=launches,
                   **{k: record[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms", "device_ms")})
    backward = dict(MOMENTS_SOURCE, name=f"moments_{kind}_backward", replaces=bwd_line,
                    launches=bwd_launches, max_abs_err=record["bwd_max_abs_err"],
                    ms=record["bwd_ms"], plain_ms=record["plain_bwd_ms"],
                    bound_ms=record["bwd_bound_ms"], bound_by=record["bwd_bound_by"],
                    library_ms=None, device_ms=record["bwd_device_ms"])
    return [forward, backward]


def phase_c(dev):
    """Kernel vs the plain version on the card; returns the kernel's record
    (max_abs_err, ms, plain_ms, its bound)."""
    import numpy as np
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops import stream_score as ss
    from trustedai_cl_vae_ad_tpu_torch.testing import (
        STARTS,
        compare_sequences,
        run_sequence,
        score_sequence,
    )

    def step(fn):
        def run(state, img, rec, alpha):
            state, norm, score, count = fn(state, torch.from_numpy(img).to(dev),
                                           torch.from_numpy(rec).to(dev), alpha)
            return (state, state.maps.cpu().numpy(), state.scalars.cpu().numpy(),
                    norm.cpu().numpy(), float(score), float(count))
        return run

    max_err = 0.0
    for h, w, c in SEQ_SHAPES:
        for start in STARTS:
            imgs, recs, maps0, scalars0 = score_sequence(h, w, c, 8, seed=h, start=start)

            def state0():
                return ss.StreamScoreState(torch.from_numpy(maps0).to(dev),
                                           torch.from_numpy(scalars0).to(dev))
            got = run_sequence(step(ss.stream_score_step), state0(), imgs, recs, ALPHA)
            ref = run_sequence(step(ss.stream_score_step_reference), state0(), imgs, recs, ALPHA)
            err = compare_sequences(got, ref, f"{h}x{w}x{c} {start}")
            counts = [int(o[4]) for o in got]
            dcount = max(abs(g[4] - r[4]) for g, r in zip(got, ref))
            nan = sum(bool(np.isnan(o[3])) for o in got)
            log(f"  {h}x{w}x{c} {start:9s}: max_abs_err {err:.3g}, counts {counts}, "
                f"max |count - plain| {dcount:g}, NaN scores {nan}")
            if (h, w, c) == SEQ_SHAPES[0]:
                max_err = max(max_err, err)
    h, w, c = SEQ_SHAPES[0]
    imgs, recs, maps0, scalars0 = score_sequence(h, w, c, 8, seed=1, start="converged")
    state = ss.StreamScoreState(torch.from_numpy(maps0).to(dev), torch.from_numpy(scalars0).to(dev))
    img, rec = torch.from_numpy(imgs[3]).to(dev), torch.from_numpy(recs[3]).to(dev)
    ms = median_ms(lambda: ss.stream_score_step(state, img, rec, ALPHA))
    plain_ms = median_ms(lambda: ss.stream_score_step_reference(state, img, rec, ALPHA))
    device_ms = queued_ms(lambda: ss.stream_score_step(state, img, rec, ALPHA))
    # img and rec read, maps and scalars read and written, norm and [score,
    # count] written; about 3 operations a channel and 30 a pixel
    nbytes = 4 * (2 * h * w * c + 2 * 2 * h * w + 2 * 6 + h * w + 2)
    bound_ms, bound_by = bound(nbytes, h * w * (3 * c + 30))
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, device_ms=device_ms)


def phase_d():
    """Tiny-config engine: cuda vs cpu with identical weights."""
    import numpy as np
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops.stream_score import StreamScoreState
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config
    from trustedai_cl_vae_ad_tpu_torch.stream.capture import SyntheticSource
    from trustedai_cl_vae_ad_tpu_torch.stream.run import build_engine, run_stream
    from trustedai_cl_vae_ad_tpu_torch.testing import warm_score_state

    config = TINY_CONFIG
    settings = {"anomaly_score_threshold": 2.0, "anomaly_score_method": "zz_count",
                "buffer_record_period_s": 1.0, "anomalous_state_period_s": 0.05}
    cpu_model = load_model_from_config(config, seed=0, device="cpu")
    gpu_model = load_model_from_config(config, seed=0, device="cuda")
    gpu_model.core.load_state_dict(cpu_model.core.state_dict())
    results = {}
    for name, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        engine = build_engine(model, config, anomaly_settings=settings)
        # both devices start from one warm scorer state (testing.py says why)
        maps, scalars = warm_score_state(engine.height, engine.width)
        engine.score_state = StreamScoreState(torch.from_numpy(maps).to(engine.device),
                                              torch.from_numpy(scalars).to(engine.device))
        rows = []
        src = SyntheticSource(width=64, height=40, n_frames=16, anomaly_frames=range(11, 13),
                              motion=0.0, seed=3)
        run_stream(engine, src, on_result=rows.append, log=lambda m: None)
        results[name] = rows
    a, b = results["cpu"], results["cuda"]
    assert len(a) == len(b) == 16, (len(a), len(b))
    agreed = True
    for ra, rb in zip(a, b):
        assert abs(ra.pixel_count - rb.pixel_count) <= 2, (ra.tag, ra.pixel_count, rb.pixel_count)
        agreed = agreed and ra.pixel_count == rb.pixel_count
        if agreed:
            assert abs(ra.score - rb.score) <= 1e-3, (ra.tag, ra.score, rb.score)
            assert abs(ra.score_ma - rb.score_ma) <= 1e-3, (ra.tag, ra.score_ma, rb.score_ma)
            assert ra.anomalous == rb.anomalous, ra.tag
        for x, y in ((ra.norm_err_u8, rb.norm_err_u8), (ra.reconstruction_u8, rb.reconstruction_u8)):
            assert int(np.max(np.abs(x.astype(int) - y.astype(int)))) <= 1, ra.tag
    assert agreed, "pixel counts differ between cuda and cpu"
    assert any(r.anomalous for r in b), "the injected blob was not flagged on cuda"
    log(f"  16 frames: counts {[int(r.pixel_count) for r in b]}, "
        f"anomalous {[r.tag for r in b if r.anomalous]}")


def phase_e():
    """The flagship on the card through the CLI's run loop; returns the
    launches of the scorer kernel and the run's summary."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops import stream_score
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config_path
    from trustedai_cl_vae_ad_tpu_torch.stream.capture import SyntheticSource
    from trustedai_cl_vae_ad_tpu_torch.stream.run import build_engine, resolve_camera, run_stream

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, config = load_model_from_config_path(os.path.join(REPO, "configs", "config.yml"),
                                                seed=0, device="cuda")
    n_params = sum(p.numel() for p in model.core.parameters())
    torch.cuda.synchronize()
    log(f"  flagship built on the card: {n_params:,} parameters, "
        f"{time.perf_counter() - t0:.1f} s")
    anomaly_settings = resolve_camera(os.path.join(REPO, "configs", "cam_config.yml"))[0]
    engine = build_engine(model, config, anomaly_settings=anomaly_settings)
    source = SyntheticSource(n_frames=64, anomaly_frames=range(40, 44), seed=0)
    results = []
    stream_score.launches = 0
    summary = run_stream(engine, source, on_result=results.append, log=lambda m: None)
    launches = stream_score.launches
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    assert summary["frames"] == 64 and len(results) == 64, summary
    assert launches == len(results), (launches, len(results))
    assert torch.isfinite(engine.score_state.maps).all()
    assert bool(torch.isfinite(engine.score_state.scalars[:2]).all())
    for r in results:
        assert r.norm_err_u8.shape == (224, 300) and r.reconstruction_u8.shape == (224, 300, 3)
    log(f"  64 frames (240x320 -> 224x300): latency p50 {summary['p50_ms']:.3f} ms, "
        f"p95 {summary['p95_ms']:.3f} ms, mean {summary['mean_ms']:.3f} ms; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB; kernel launches {launches}")
    log(f"  counts {[int(r.pixel_count) for r in results]}")
    return launches, summary, peak


def expect_raises(fn, error, what):
    try:
        fn()
    except error:
        return
    raise AssertionError(f"{what} did not raise {error.__name__}")


def phase_f(dev):
    """The moments kernels vs their plain versions on the card; returns the
    kernel's record at the flagship's (256, 2000) float32."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops import moments as mo

    gout = torch.tensor(GRAD_WEIGHTS, device=dev)
    record = {}
    for shape, dtype in MOMENT_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(shape[0])
        z = (torch.randn(shape, device=dev, generator=gen) * 1.3 + 0.4).to(getattr(torch, dtype))
        out = mo.global_moments_packed(z)
        ref = torch.stack(mo.global_moments_reference(z))
        torch.cuda.synchronize()
        # mean and variance; then skew and kurtosis, where the skew of a
        # near-symmetric sample is a small difference of large sums
        torch.testing.assert_close(out[:2], ref[:2], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(out[2:], ref[2:], rtol=1e-4, atol=1e-6)
        assert torch.equal(out, mo.global_moments_packed(z)), "two runs differ"
        grad = mo.global_moments_backward(z, out, gout)
        grad_ref = mo.global_moments_backward_reference(z, out, gout)
        assert grad.dtype == z.dtype and grad.shape == z.shape
        assert torch.equal(grad, mo.global_moments_backward(z, out, gout)), "two runs differ"
        scale = float(grad_ref.float().abs().max())
        torch.testing.assert_close(grad.float(), grad_ref.float(), rtol=1e-4, atol=1e-6 * scale)
        # through autograd, with one output unused
        za = z.clone().requires_grad_(True)
        (1.8 - mo.global_moments(za)[3]).abs().backward()
        zb = z.clone().float().requires_grad_(True)
        (1.8 - mo.global_moments_reference(zb)[3]).abs().backward()
        gscale = float(zb.grad.abs().max())
        # bfloat16 gradients are rounded to 8 bits
        rtol = 1e-4 if dtype == "float32" else 2.0 ** -7
        torch.testing.assert_close(za.grad.float(), zb.grad, rtol=rtol, atol=rtol * gscale)
        err = float((out - ref).abs().max())
        gerr = float((grad.float() - grad_ref.float()).abs().max())
        log(f"  {shape} {dtype}: moments {[round(v, 6) for v in out.tolist()]}, "
            f"max_abs_err {err:.3g}, gradient max_abs_err {gerr:.3g} of {scale:.3g}")
        if (shape, dtype) == MOMENT_SHAPES[0]:
            record.update(max_abs_err=err, bwd_max_abs_err=gerr)
            # torch.var_mean gives two of the four moments: half the work
            record.update(time_moments(
                z, out, gout, mo.global_moments_packed, mo.global_moments_reference,
                mo.global_moments_backward, mo.global_moments_backward_reference,
                lambda t: torch.var_mean(t, correction=0)))
    const = torch.full((16, 128), 0.5, device=dev)
    out = mo.global_moments_packed(const)
    assert out.tolist() == [0.5, 0.0, 0.0, 0.0], out.tolist()
    assert torch.isfinite(mo.global_moments_backward(const, out, gout)).all()
    for bad, error in ((const.double(), TypeError), (const[0], ValueError),
                       (const.t(), ValueError)):
        expect_raises(lambda: mo.global_moments(bad), error,
                      f"global_moments of a {bad.dtype} tensor of shape {tuple(bad.shape)}")
    log_moments_times("(256, 2000) float32", record)
    return record


def phase_i(dev):
    """The per-dimension moments kernels vs their plain versions on the card,
    column by column; returns the record at the flagship's (256, 2000)
    float32."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops import moments as mo

    def loss_of(ms):  # KurtosisSingle's use of the rows: the variance row is unused
        m, _var, skew, kurt = ms
        return ((kurt - 1.8) ** 2).mean() + (skew ** 2).mean() + torch.sqrt((m ** 2).sum())

    def check(z, label, autograd=True):
        cols = z.shape[1]
        gen = torch.Generator(device=dev).manual_seed(cols)
        gout = torch.randn((4, cols), device=dev, generator=gen)
        out = mo.perdim_moments_packed(z)
        ref = torch.stack(mo.perdim_moments_reference(z))
        torch.cuda.synchronize()
        assert out.shape == (4, cols) and out.dtype == torch.float32
        torch.testing.assert_close(out[:2], ref[:2], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(out[2:], ref[2:], rtol=1e-4, atol=1e-6)
        assert torch.equal(out, mo.perdim_moments_packed(z)), "two runs differ"
        grad = mo.perdim_moments_backward(z, out, gout)
        grad_ref = mo.perdim_moments_backward_reference(z, out, gout)
        assert grad.dtype == z.dtype and grad.shape == z.shape
        assert bool(torch.isfinite(grad.float()).all())
        assert torch.equal(grad, mo.perdim_moments_backward(z, out, gout)), "two runs differ"
        scale = float(grad_ref.float().abs().max())
        torch.testing.assert_close(grad.float(), grad_ref.float(), rtol=1e-4, atol=1e-6 * scale)
        if autograd:  # against autograd of the plain forward, in float32
            za = z.clone().requires_grad_(True)
            loss_of(mo.perdim_moments(za)).backward()
            zb = z.clone().float().requires_grad_(True)
            loss_of(mo.perdim_moments_reference(zb)).backward()
            gscale = float(zb.grad.abs().max())
            # bfloat16 gradients are rounded to 8 bits
            rtol = 1e-4 if z.dtype == torch.float32 else 2.0 ** -7
            torch.testing.assert_close(za.grad.float(), zb.grad, rtol=rtol, atol=rtol * gscale)
        err = float((out - ref).abs().max())
        gerr = float((grad.float() - grad_ref.float()).abs().max())
        log(f"  {label}: max_abs_err {err:.3g} over {4 * cols} moments, gradient max_abs_err "
            f"{gerr:.3g} of {scale:.3g}")
        return out, gout, err, gerr

    def randn(shape, dtype, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return (torch.randn(shape, device=dev, generator=gen) * 1.3 + 0.4).to(dtype)

    record = {}
    before = (mo.launches, mo.bwd_launches)
    for shape, dtype in PERDIM_SHAPES:
        z = randn(shape, getattr(torch, dtype), shape[0])
        # one row has no spread: the plain forward's autograd is 0/0 there
        out, gout, err, gerr = check(z, f"{shape} {dtype}", autograd=shape[0] > 1)
        if shape[0] == 1:
            assert float(out[1:].abs().max()) == 0.0, "a batch of one has var = skew = kurt = 0"
        if (shape, dtype) == PERDIM_SHAPES[0]:
            record.update(max_abs_err=err, bwd_max_abs_err=gerr)
            record.update(time_moments(
                z, out, gout, mo.perdim_moments_packed, mo.perdim_moments_reference,
                mo.perdim_moments_backward, mo.perdim_moments_backward_reference,
                lambda t: torch.var_mean(t, dim=0, correction=0)))
    for dtype in (torch.float32, torch.bfloat16):
        z = randn((64, 40), dtype, 7)
        z[:, 5] = 2.0  # exact in both types, so the column's variance is exactly 0
        out, _gout, _err, _gerr = check(z, f"(64, 40) {dtype} with a constant column",
                                        autograd=False)
        assert out[:, 5].tolist() == [2.0, 0.0, 0.0, 0.0], out[:, 5].tolist()
    # contiguous views that start one element into an allocation: 4 bytes
    # (float32) and 2 bytes (bfloat16, which then takes one column a thread)
    check(randn((37 * 53 + 1,), torch.float32, 8)[1:].view(37, 53), "(37, 53) float32 view at +4 B")
    check(randn((10 * 100 + 1,), torch.bfloat16, 9)[1:].view(10, 100),
          "(10, 100) bfloat16 view at +2 B")
    assert (mo.launches, mo.bwd_launches) == before, "the global kernels ran"
    z = randn((8, 16), torch.float32, 10)
    for bad, error in ((z.double(), TypeError), (z.half(), TypeError), (z[0], ValueError),
                       (z.t(), ValueError), (z[:0], ValueError)):
        expect_raises(lambda: mo.perdim_moments(bad), error,
                      f"perdim_moments of a {bad.dtype} tensor of shape {tuple(bad.shape)}")
    out = mo.perdim_moments_packed(z)
    expect_raises(lambda: mo.perdim_moments_backward(z, out[:, :8].contiguous(), out), ValueError,
                  "perdim_moments_backward with moments of another width")
    expect_raises(lambda: mo.perdim_moments_backward(z, out, out.double()), ValueError,
                  "perdim_moments_backward with a float64 gout")
    log_moments_times("(256, 2000) float32", record)
    return record


def phase_g(model_type="KurtosisGlobal"):
    """Tiny config: 3 training steps on cuda vs cpu from the same weights,
    batches and latent noise."""
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config
    from trustedai_cl_vae_ad_tpu_torch.testing import (
        compare_train_runs,
        run_train_steps,
        train_inputs,
    )

    config = tiny_config(model_type)
    inputs = train_inputs(config, n_steps=3, batch=8, seed=5)
    cpu_model = load_model_from_config(config, seed=0, device="cpu")
    gpu_model = load_model_from_config(config, seed=0, device="cuda")
    gpu_model.core.load_state_dict(cpu_model.core.state_dict())
    runs = {}
    for name, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        model.compile()
        runs[name] = run_train_steps(model, inputs)
    worst = compare_train_runs(runs["cuda"], runs["cpu"], rtol=1e-4, atol=1e-6,
                               label="cuda vs cpu")
    lr = config["training"]["learning_rate"]
    far = 0.0
    for key, ref in cpu_model.params.items():
        diff = (gpu_model.params[key].cpu() - ref).abs()
        assert float(diff.max()) <= 0.05 * 3 * lr, (key, float(diff.max()))
        assert float((diff <= 1e-5).float().mean()) > 0.99, key
        far = max(far, float(diff.max()))
    log(f"  {model_type}, 3 steps: losses {[round(r['loss'], 6) for r in runs['cuda']]}, "
        f"max |loss - cpu| "
        f"{worst:.3g}, max |param - cpu| {far:.3g}")


def phase_h(model_type="KurtosisGlobal", train_steps=2, loss_update=None, bf16_steps=True):
    """The flagship with ``model.type`` set to ``model_type`` trains on the
    card through load_data and train_model, reloads its checkpoint, then
    takes the bfloat16 train + score steps. Returns the float32 run's launches
    of the moments kernels: (global forward, global backward, per-dimension
    forward, per-dimension backward)."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.config import load_config, save_config, validate_config
    from trustedai_cl_vae_ad_tpu_torch.data.loader import iter_images, load_data
    from trustedai_cl_vae_ad_tpu_torch.ops import moments
    from trustedai_cl_vae_ad_tpu_torch.registry import (
        load_model_from_config,
        load_model_from_directory,
    )
    from trustedai_cl_vae_ad_tpu_torch.train.bench_step import flagship_config, train_score_step
    from trustedai_cl_vae_ad_tpu_torch.train.loop import load_train_state, train_model

    def counts():
        return (moments.launches, moments.bwd_launches, moments.perdim_launches,
                moments.perdim_bwd_launches)

    # which kernels the type's loss runs: one forward per train and per
    # validation step, one backward per train step
    steps = (train_steps + VAL_STEPS, train_steps)
    expected = {"KurtosisGlobal": steps + (0, 0), "KurtosisSingle": (0, 0) + steps,
                "KLGaussian": (0, 0, 0, 0)}[model_type]
    config = validate_config(load_config(os.path.join(REPO, "configs", "config.yml")))
    config["model"]["type"] = model_type
    config["loss"].update(loss_update or {})
    config["data"] = {"image_size": config["data"]["image_size"], "dataset": "synthetic",
                      "n_train": train_steps * BATCH, "n_val": VAL_STEPS * BATCH,
                      "synthetic_frame_size": [240, 320]}
    config["training"].update(max_epochs=1, precision="float32")
    assert config["training"]["batch_size"] == BATCH
    logdir = tempfile.mkdtemp(prefix="chip_smoke_fit_")
    try:
        config["logdir"] = logdir
        # the run reads its config from a file, as train_torch.py does
        save_config(config, os.path.join(logdir, "config.yml"))
        config = validate_config(load_config(os.path.join(logdir, "config.yml")))
        torch.cuda.reset_peak_memory_stats()
        data = load_data(config)
        model = load_model_from_config(config, seed=0)
        assert model.device.type == "cuda" and type(model.core).__name__ == f"{model_type}CVAE"
        moments.launches = moments.bwd_launches = 0
        moments.perdim_launches = moments.perdim_bwd_launches = 0
        t0 = time.perf_counter()
        train_model(config, model, data, log_every=1)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launched = counts()
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        train = [r for r in records if "train/loss" in r]
        (val,) = [r for r in records if "val/loss" in r]
        losses = [r["train/loss"] for r in train]
        assert len(losses) == train_steps, losses
        assert all(v == v and abs(v) != float("inf") for r in train + [val]
                   for k, v in r.items() if "/" in k), records
        if model_type == "KurtosisGlobal":
            assert losses[-1] < losses[0], losses
        assert launched == expected, (model_type, launched, expected)
        assert model.optimizer.count == train_steps
        assert load_train_state(logdir) == {"epochs_completed": 1, "step": train_steps,
                                            "beta": model.beta}
        # host clock between the records of consecutive steps; each record
        # fetches the loss, so it waits for the step (and for the batch)
        step_ms = [(b["time"] - a["time"]) * 1e3 for a, b in zip(train, train[1:])]
        log(f"  {model_type}, float32 adam, batch {BATCH}, {train_steps} train + {VAL_STEPS} "
            f"validation steps and the save in {total_s:.1f} s; losses "
            f"{[round(v, 6) for v in losses]}, validation loss {val['val/loss']:.6f} "
            f"({len(val) - 2} keys)")
        log(f"  ms per step (host clock, batch making included): "
            f"{[round(v, 1) for v in step_ms]}, "
            f"{[round(BATCH / v * 1e3, 1) for v in step_ms]} frames/s; max_memory_allocated "
            f"{peak / 2**30:.2f} GiB; moments launches: global {launched[0]} forward, "
            f"{launched[1]} backward; per dimension {launched[2]} forward, {launched[3]} backward")
        del model
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        reloaded, _ = load_model_from_directory(logdir)
        (batch,) = list(iter_images(data["val"]))
        again = float(reloaded.test_step(batch)["loss"])
        # the same kernels on the same card: equal up to cuDNN's choice of algorithm
        assert abs(again - val["val/loss"]) <= 1e-5 * abs(val["val/loss"]), (again, val["val/loss"])
        log(f"  checkpoint reloaded in {time.perf_counter() - t0:.1f} s: validation loss "
            f"{again:.6f}")
        del reloaded, data, batch
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    if not bf16_steps:
        return launched

    # the combined step as the JAX package's bench.py runs it
    bench = flagship_config()
    bench["model"]["type"] = model_type
    bench["training"]["precision"] = "bfloat16"
    model = load_model_from_config(bench, seed=0)
    model.compile()
    assert model.optimizer.name == "adam_lean"
    w, h, c = bench["data"]["image_size"]
    x_u8 = torch.randint(0, 256, (BATCH, w, h, c), dtype=torch.uint8, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        loss, z_scores = train_score_step(model, x_u8, 100.0, 10.0)
    torch.cuda.synchronize()
    before = counts()
    t0 = time.perf_counter()
    for _ in range(10):
        loss, z_scores = train_score_step(model, x_u8, 100.0, 10.0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 10
    timed = tuple(b - a for a, b in zip(before, counts()))
    assert timed == tuple(10 * (e > 0) for e in expected), (model_type, timed)
    assert z_scores.shape == (BATCH,) and bool(torch.isfinite(z_scores).all())
    assert bool(torch.isfinite(loss))
    peak = torch.cuda.max_memory_allocated()
    log(f"  {model_type}, bfloat16 adam_lean train + score step, batch {BATCH}, uint8 input: "
        f"{ms:.2f} ms per step, {BATCH / ms * 1e3:.1f} frames/s (10 steps after 5 warm-up, "
        f"synchronized); loss {float(loss):.6f}; max_memory_allocated {peak / 2**30:.2f} GiB")
    del model, x_u8
    torch.cuda.empty_cache()
    return launched


def write_replay_file(directory, n=CL_REPLAY):
    """n generated 240x320 PNGs and a txt that lists them (and one path that
    does not exist, which the loader skips); returns the txt's path."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(11)
    paths = []
    for i in range(n):
        path = os.path.join(directory, f"replay_{i}.png")
        Image.fromarray(rng.randint(0, 256, (240, 320, 3), dtype=np.uint8)).save(path)
        paths.append(path)
    listing = os.path.join(directory, "replay.txt")
    with open(listing, "w") as f:
        f.write("\n".join(paths + [os.path.join(directory, "missing.png")]) + "\n")
    return listing


def phase_l():
    """Continual learning in the live engine at the flagship's size, then one
    CL step each for the other two types at a tiny size. Returns the scorer
    kernel's launches of the flagship's CL stream."""
    import numpy as np
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops import moments, stream_score
    from trustedai_cl_vae_ad_tpu_torch.registry import (
        load_model_from_config,
        load_model_from_config_path,
    )
    from trustedai_cl_vae_ad_tpu_torch.stream.capture import SyntheticSource
    from trustedai_cl_vae_ad_tpu_torch.stream.run import (
        build_engine,
        configure_continual_learning,
        resolve_camera,
        run_stream,
    )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, config = load_model_from_config_path(os.path.join(REPO, "configs", "config.yml"),
                                                seed=0, device="cuda")
    anomaly_settings = resolve_camera(os.path.join(REPO, "configs", "cam_config.yml"))[0]
    engine = build_engine(model, config, anomaly_settings=anomaly_settings,
                          continuous_learning_period_ms=CL_PERIOD_MS)
    run_stream(engine, SyntheticSource(n_frames=8, seed=1), log=lambda m: None)
    torch.cuda.synchronize()
    idle_peak = torch.cuda.max_memory_allocated()
    assert model.optimizer is None, "an inference-only engine allocated an optimizer"
    # weights 5.4 GB and one frame's activations; Adam's moments would add 10.8 GB
    assert idle_peak < 6 * 2**30, idle_peak
    log(f"  inference only, 8 frames: max_memory_allocated {idle_peak / 2**30:.2f} GiB, "
        f"no optimizer")

    replay_dir = tempfile.mkdtemp(prefix="chip_smoke_replay_")
    try:
        configure_continual_learning(engine, continual_learning=True,
                                     replay_buffer=write_replay_file(replay_dir),
                                     log=lambda m: None)
    finally:
        shutil.rmtree(replay_dir, ignore_errors=True)
    assert engine.replay_n == CL_REPLAY and engine.replay_buffer.shape[0] == 256
    assert model.optimizer is None  # no CL control has needed it yet
    fixed = torch.full((1, engine.height, engine.width, engine.channels), 0.5, device="cuda")
    watched = ("decoder.layers.ConvTranspose_2.bias", "encoder.layers.Dense_0.weight")

    def snapshot():
        with torch.inference_mode():
            rec = engine._forward(engine._serve_params, fixed).clone()
        return rec, {k: model.params[k].flatten()[:4096].clone() for k in watched}

    rec0, params0 = snapshot()
    engine.warmup(frame_shape=(240, 320, 3), cl=True)
    rec1, params1 = snapshot()
    assert all(torch.equal(params0[k], params1[k]) for k in watched), "the warm-up moved weights"
    # the same weights, but cuDNN may pick another algorithm once the
    # optimizer's memory is taken: equal up to float32 rounding
    warm_diff = float((rec1 - rec0).abs().max())
    assert warm_diff <= 1e-5, warm_diff
    assert model.optimizer is not None and model.optimizer.count == 0
    assert engine.ring_filled == 8 and engine.cl_epochs == 0

    rows = []
    stream_score.launches = 0
    before = (moments.launches, moments.bwd_launches, moments.perdim_launches,
              moments.perdim_bwd_launches)
    start = 100.0  # later than the warm-up frames' wall clock is early
    engine._last_inference_t = engine._last_cl_t = start
    summary = run_stream(
        engine, SyntheticSource(n_frames=CL_FRAMES, anomaly_frames=range(40, 44), seed=0),
        on_result=lambda r: rows.append((r, dict(engine.timings))),
        clock=lambda n: start + (n + 1) / CL_FPS, log=lambda m: None)
    torch.cuda.synchronize()
    launches = stream_score.launches
    peak = torch.cuda.max_memory_allocated()
    assert summary["frames"] == CL_FRAMES and len(rows) == CL_FRAMES, summary
    assert launches == CL_FRAMES, launches
    stepped = [r.tag for r, _ in rows if r.cl_stepped]
    assert engine.cl_epochs == len(stepped) == 3 == model.optimizer.count, (stepped,
                                                                            engine.cl_epochs)
    losses = [r.loss for r, _ in rows if r.cl_stepped]
    assert all(len(d) == 14 and all(np.isfinite(v) for v in d.values()) for d in losses), losses
    assert all(r.loss is None for r, _ in rows if not r.cl_stepped)
    # the weighted loss is plain PyTorch: no moments kernel on this path
    assert before == (moments.launches, moments.bwd_launches, moments.perdim_launches,
                      moments.perdim_bwd_launches)
    rec2, params2 = snapshot()
    assert all(not torch.equal(params1[k], params2[k]) for k in watched), "parameters unchanged"
    rec_change = float((rec2 - rec1).abs().max())
    assert rec_change > max(1e-4, 10 * warm_diff), (rec_change, warm_diff)
    lat = np.array(summary["latencies_ms"])
    is_cl = np.array([r.cl_stepped for r, _ in rows])
    cl_s = [t["cl_s"] * 1e3 for (r, t) in rows if r.cl_stepped]
    plain = lat[~is_cl][2:]
    log(f"  {CL_FRAMES} frames at {CL_FPS:g} frames/s on the injected clock, CL period "
        f"{CL_PERIOD_MS:g} ms, batch {engine.RING_SIZE} + {engine.replay_buffer.shape[0]} "
        f"({engine.RING_SIZE + engine.replay_n} rows weigh 1): CL steps in frames {stepped}, "
        f"losses {[round(d['loss'], 6) for d in losses]}")
    log(f"  frames without a CL step: p50 {np.percentile(plain, 50):.3f} ms, p95 "
        f"{np.percentile(plain, 95):.3f} ms; frames with one: {[round(float(v), 1) for v in lat[is_cl]]} "
        f"ms, of which timings['cl_s'] {[round(v, 1) for v in cl_s]} ms (the warm-up took the "
        f"optimizer's first allocations); max_memory_allocated {peak / 2**30:.2f} GiB; "
        f"max |reconstruction change| {rec_change:.3g} (across the warm-up: {warm_diff:.3g})")
    del engine, model, rec0, rec1, rec2, params0, params1, params2
    torch.cuda.empty_cache()

    for model_type in ("KurtosisSingle", "KLGaussian"):
        config = tiny_config(model_type)
        model = load_model_from_config(config, seed=0)
        engine = build_engine(model, config, continuous_learning_period_ms=0.0)
        engine.enable_cont_learning = True
        results = []
        run_stream(engine, SyntheticSource(width=64, height=40, n_frames=3, seed=2),
                   on_result=results.append, log=lambda m: None)
        assert [r.cl_stepped for r in results] == [True] * 3 and model.optimizer.count == 3
        keys = {"KurtosisSingle": 10, "KLGaussian": 7}[model_type] + 2
        assert all(len(r.loss) == keys and all(np.isfinite(v) for v in r.loss.values())
                   for r in results), results[-1].loss
        log(f"  tiny {model_type}: 3 CL steps, losses "
            f"{[round(r.loss['loss'], 6) for r in results]}")
    return launches


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--phases", default=None,
                        help="comma-separated subset of c..l to run after the build (for "
                             "finding a fault); the final line is then not printed")
    args = parser.parse_args(argv)
    only = set(args.phases.split(",")) if args.phases else None
    if not __debug__:
        print("chip_smoke: run without python -O (its checks are assert statements)",
              file=sys.stderr)
        return 1
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, PACKAGE)):
        print(f"chip_smoke: {PACKAGE} not found beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()

    log("[a] device")
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    from trustedai_cl_vae_ad_tpu_torch.registry import use_full_float32

    use_full_float32()
    log(f"  {smi}; torch {torch.__version__} (CUDA {torch.version.cuda}); "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    log("[b] build")
    from concurrent.futures import ThreadPoolExecutor

    from trustedai_cl_vae_ad_tpu_torch.ops import _build, moments, stream_score

    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:  # one nvcc for each source, started together
        list(pool.map(lambda module: module.build(), (stream_score, moments)))
    log(f"  stream_score and moments built and loaded in {time.perf_counter() - t0:.1f} s")
    for kernel in ("stream_score", "moments"):
        for line in _build.build_log.get(kernel, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {kernel}: {line.strip()}")

    dev = torch.device("cuda")
    out = {}

    def run(phase, title, fn):
        if only is None or phase in only:
            t0 = time.perf_counter()
            log(f"[{phase}] {title}")
            out[phase] = fn()
            log(f"  ({time.perf_counter() - t0:.1f} s)")

    run("c", "stream-scorer kernel vs plain version on the card", lambda: phase_c(dev))
    if "c" in out:
        log(f"  224x300x3 median of 100: kernel {out['c']['ms']:.4f} ms "
            f"({out['c']['device_ms']:.4f} ms back to back on a full queue), plain "
            f"{out['c']['plain_ms']:.4f} ms, bound {out['c']['bound_ms']:.5f} ms")
    run("d", "tiny engine: cuda vs cpu", phase_d)
    run("e", "flagship single-stream engine", phase_e)
    run("f", "global moments kernels vs plain versions on the card", lambda: phase_f(dev))
    run("g", "tiny KurtosisGlobal training: cuda vs cpu", phase_g)
    run("h", "flagship KurtosisGlobal training", phase_h)
    run("i", "per-dimension moments kernels vs plain versions on the card", lambda: phase_i(dev))
    run("j", "tiny KurtosisSingle and KLGaussian training: cuda vs cpu",
        lambda: [phase_g("KurtosisSingle"), phase_g("KLGaussian")])
    run("k", "flagship KurtosisSingle and KLGaussian training",
        lambda: [phase_h("KurtosisSingle", train_steps=3),
                 phase_h("KLGaussian", loss_update={"w_kl_divergence": 1e-4},
                         bf16_steps=False)])
    run("l", "continual learning in the live engine", phase_l)
    log(f"all phases in {time.perf_counter() - t_start:.1f} s")
    if only is not None:
        print(f"partial run (phases {sorted(out)}): no result line")
        return 0

    # launches of each kernel on the path that runs it, counted from zero
    # just before that path: (e) for the scorer, (h) for the global moments,
    # (k) with KurtosisSingle for the per-dimension moments
    global_launches, perdim_launches = out["h"], out["k"][0]
    print(json.dumps({"kernels": [
        dict(STREAM_KERNEL, launches=out["e"][0], launches_cl_stream=out["l"], **out["c"]),
        *moments_entries("global", out["f"], global_launches[0], global_launches[1]),
        *moments_entries("perdim", out["i"], perdim_launches[2], perdim_launches[3]),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
