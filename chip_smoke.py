#!/usr/bin/env python3
"""Smoke check of the PyTorch port on one NVIDIA GPU.

Runs the port's two main paths (trustedai_cl_vae_ad_tpu_torch) on the card,
live-stream scoring and training, in phases; any failure raises and the
script exits non-zero without printing its final line.

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
      adam_lean: 5 warm-up and 10 timed steps.

Before the last line it prints the kernels' JSON line and the nvidia-smi
line; the last line is {"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py
"""

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
MOMENTS_KERNEL = {
    "name": "moments",
    "route": "cuda",
    "source": f"{PACKAGE}/csrc/moments.cu",
    "replaces": "trustedai_cl_vae_ad_tpu/ops/moments.py:77 (forward), :174 (backward)",
}
# NVIDIA's H100 SXM data sheet: device memory rate, float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
MOMENT_SHAPES = [((256, 2000), "float32"), ((256, 2000), "bfloat16"), ((768, 2000), "float32"),
                 ((7, 13), "float32"), ((7, 13), "bfloat16")]
GRAD_WEIGHTS = (0.3, -0.7, 1.1, 0.9)
TRAIN_STEPS, VAL_STEPS, BATCH = 4, 1, 256
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
            record["ms"] = median_ms(lambda: mo.global_moments_packed(z))
            record["plain_ms"] = median_ms(lambda: mo.global_moments_reference(z))
            record["device_ms"] = queued_ms(lambda: mo.global_moments_packed(z))
            record["bwd_ms"] = median_ms(lambda: mo.global_moments_backward(z, out, gout))
            record["bwd_device_ms"] = queued_ms(lambda: mo.global_moments_backward(z, out, gout))
            record["plain_bwd_ms"] = median_ms(
                lambda: mo.global_moments_backward_reference(z, out, gout))
            # torch.var_mean gives two of the four moments: half the work
            record["library_ms"] = median_ms(lambda: torch.var_mean(z, correction=0))
            n, size = z.numel(), z.element_size()
            # forward: z read once, four floats out; about 2 operations an
            # element for the sum and 8 for the centred powers and their sums
            record["bound_ms"], record["bound_by"] = bound(n * size + 16, 10 * n)
            # backward: z read, the gradient written; about 14 operations
            record["bwd_bound_ms"], record["bwd_bound_by"] = bound(2 * n * size + 32, 14 * n)
    const = torch.full((16, 128), 0.5, device=dev)
    out = mo.global_moments_packed(const)
    assert out.tolist() == [0.5, 0.0, 0.0, 0.0], out.tolist()
    assert torch.isfinite(mo.global_moments_backward(const, out, gout)).all()
    for bad, error in ((const.double(), TypeError), (const[0], ValueError),
                       (const.t(), ValueError)):
        try:
            mo.global_moments(bad)
        except error:
            continue
        raise AssertionError(f"global_moments took a {bad.dtype} tensor of shape {bad.shape}")
    log(f"  (256, 2000) float32 median of 100: forward kernel {record['ms']:.4f} ms "
        f"({record['device_ms']:.4f} ms back to back on a full queue), plain "
        f"{record['plain_ms']:.4f} ms, torch.var_mean (half the work) "
        f"{record['library_ms']:.4f} ms, bound {record['bound_ms']:.5f} ms; backward kernel "
        f"{record['bwd_ms']:.4f} ms ({record['bwd_device_ms']:.4f} ms back to back), plain "
        f"{record['plain_bwd_ms']:.4f} ms, bound {record['bwd_bound_ms']:.5f} ms")
    return record


def phase_g():
    """Tiny config: 3 training steps on cuda vs cpu from the same weights,
    batches and latent noise."""
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config
    from trustedai_cl_vae_ad_tpu_torch.testing import (
        compare_train_runs,
        run_train_steps,
        train_inputs,
    )

    config = TINY_CONFIG
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
    log(f"  3 steps: losses {[round(r['loss'], 6) for r in runs['cuda']]}, max |loss - cpu| "
        f"{worst:.3g}, max |param - cpu| {far:.3g}")


def phase_h():
    """The flagship trains on the card through load_data and train_model,
    then takes the bfloat16 train + score steps; returns the moments
    kernel's (forward, backward) launches of the float32 run."""
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

    config = validate_config(load_config(os.path.join(REPO, "configs", "config.yml")))
    config["data"] = {"image_size": config["data"]["image_size"], "dataset": "synthetic",
                      "n_train": TRAIN_STEPS * BATCH, "n_val": VAL_STEPS * BATCH,
                      "synthetic_frame_size": [240, 320]}
    config["training"].update(max_epochs=1, precision="float32")
    assert config["training"]["batch_size"] == BATCH
    logdir = tempfile.mkdtemp(prefix="chip_smoke_fit_")
    try:
        config["logdir"] = logdir
        save_config(config, os.path.join(logdir, "config.yml"))
        torch.cuda.reset_peak_memory_stats()
        data = load_data(config)
        model = load_model_from_config(config, seed=0)
        assert model.device.type == "cuda"
        moments.launches = moments.bwd_launches = 0
        t0 = time.perf_counter()
        train_model(config, model, data, log_every=1)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches, bwd_launches = moments.launches, moments.bwd_launches
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        train = [r for r in records if "train/loss" in r]
        (val,) = [r for r in records if "val/loss" in r]
        losses = [r["train/loss"] for r in train]
        assert len(losses) == TRAIN_STEPS, losses
        assert all(v == v and abs(v) != float("inf") for r in train + [val]
                   for k, v in r.items() if "/" in k), records
        assert losses[3] < losses[0], losses
        assert launches == TRAIN_STEPS + VAL_STEPS, (launches, TRAIN_STEPS + VAL_STEPS)
        assert bwd_launches == TRAIN_STEPS, (bwd_launches, TRAIN_STEPS)
        assert model.optimizer.count == TRAIN_STEPS
        assert load_train_state(logdir) == {"epochs_completed": 1, "step": TRAIN_STEPS,
                                            "beta": model.beta}
        # host clock between the records of consecutive steps; each record
        # fetches the loss, so it waits for the step (and for the batch)
        step_ms = [(b["time"] - a["time"]) * 1e3 for a, b in zip(train, train[1:])]
        log(f"  float32 adam, batch {BATCH}, {TRAIN_STEPS} train + {VAL_STEPS} validation steps "
            f"and the save in {total_s:.1f} s; losses {[round(v, 6) for v in losses]}, "
            f"validation loss {val['val/loss']:.6f}")
        log(f"  ms per step (host clock, batch making included): "
            f"{[round(v, 1) for v in step_ms]}; max_memory_allocated {peak / 2**30:.2f} GiB; "
            f"moments launches {launches} forward, {bwd_launches} backward")
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

    # the combined step as the JAX package's bench.py runs it
    bench = flagship_config()
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
    t0 = time.perf_counter()
    for _ in range(10):
        loss, z_scores = train_score_step(model, x_u8, 100.0, 10.0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 10
    assert z_scores.shape == (BATCH,) and bool(torch.isfinite(z_scores).all())
    assert bool(torch.isfinite(loss))
    peak = torch.cuda.max_memory_allocated()
    log(f"  bfloat16 adam_lean train + score step, batch {BATCH}, uint8 input: {ms:.2f} ms per "
        f"step, {BATCH / ms * 1e3:.1f} frames/s (10 steps after 5 warm-up, synchronized); "
        f"loss {float(loss):.6f}; max_memory_allocated {peak / 2**30:.2f} GiB")
    return launches, bwd_launches


def main():
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

    log("[c] stream-scorer kernel vs plain version on the card")
    dev = torch.device("cuda")
    stream_record = phase_c(dev)
    log(f"  224x300x3 median of 100: kernel {stream_record['ms']:.4f} ms "
        f"({stream_record['device_ms']:.4f} ms back to back on a full queue), plain "
        f"{stream_record['plain_ms']:.4f} ms, bound {stream_record['bound_ms']:.5f} ms")

    log("[d] tiny engine: cuda vs cpu")
    phase_d()

    log("[e] flagship single-stream engine")
    stream_launches, _summary, _peak = phase_e()

    log("[f] moments kernels vs plain versions on the card")
    moments_record = phase_f(dev)

    log("[g] tiny training: cuda vs cpu")
    phase_g()

    log("[h] flagship training")
    moments_launches, moments_bwd_launches = phase_h()

    print(json.dumps({"kernels": [
        dict(STREAM_KERNEL, launches=stream_launches, **stream_record),
        dict(MOMENTS_KERNEL, launches=moments_launches, bwd_launches=moments_bwd_launches,
             **moments_record),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
