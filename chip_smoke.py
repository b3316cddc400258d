#!/usr/bin/env python3
"""Smoke check of the PyTorch port on one NVIDIA GPU.

Runs the port's main paths (trustedai_cl_vae_ad_tpu_torch) on the card, in
phases: live-stream scoring, training of the three model types, continual
learning in the live engine, int8 serving with the multi-camera tick, and the
dense-kernel update probes, the convolution weight-gradient kernel with its probe,
crash-atomic checkpoints, and the live application's autosave, recording and fleet
continual learning, and the scoring surfaces (the HTTP server and the offline
two-pass CLI), JAX-written log directories and the COCO-JSON data path, the dataset
builders and adam_fp8, parallel/ (data parallelism, ZeRO-1, a model axis), and the
multi-camera engine on a device mesh with adam_fp8 on one; any failure raises and the
script exits non-zero without printing its final line.

  (a) device: the card's name and power limit, torch version, TF32 flags;
  (b) build: nvcc builds the stream-scorer (one block a frame and one
      thread-block cluster a frame), the moments (on thread-block clusters,
      and moments.cu's blocks), the int8 GEMM (on CUDA cores and on the
      tensor cores), the dense-update and the convolution weight-gradient
      kernels (ten sources) from csrc/ into build/, all at once, and logs
      each one's ptxas registers, shared memory and spills;
  (c) the scorer vs its plain PyTorch version on the card, 8-frame sequences
      at 224x300x3 and 37x53x3 (constant first frame, seeding, converged
      state), at the tolerances of trustedai_cl_vae_ad_tpu_torch/testing.py:
      through stream_score_step (the rule's arrangement, the cluster kernel,
      one counted launch a frame) and through each arrangement on its own
      (clusters of 16 and of 8, the one-block kernel); the cluster sizes'
      cudaOccupancyMaxActiveClusters; the CUDA-event median of 100 and the
      back-to-back time of each arrangement on the same operands at K = 1;
  (d) a tiny-config engine on cuda vs the same weights on cpu, 16 synthetic
      40x64 frames (the device resize runs);
  (e) the flagship (configs/config.yml, 224x300x3, latent 2000, ~1.34 B
      parameters, seeded random weights) scores 64 synthetic 240x320 frames
      through stream/run.py, as camera_streamer_torch.py does; the scorer's
      launches must equal the frames scored, all on the cluster kernel;
  (f) the global moments kernels of both arrangements (the cluster kernels
      of csrc/moments_cluster.cu, which every CUDA tensor takes, and
      csrc/moments.cu by name) vs their plain PyTorch versions on the card,
      forward and backward, at (256, 2000) float32 and bfloat16 (staged),
      (768, 2000) float32 (streamed), a ragged (7, 13) and views off 16
      bytes: rtol 1e-5 on mean and variance, 1e-4 on skew, kurtosis and the
      gradient (the order of the sums differs), each with an absolute floor
      for values that are differences of large sums; a constant input; two
      runs equal bit for bit, staged and streamed equal, the backward equal
      to moments.cu's bit for bit; launches the source refuses raise;
      registers, shared memory and cudaOccupancyMaxActiveClusters; the
      CUDA-event median of 100 and the back-to-back time of each arrangement
      on the same operands, taken twice in turns; the back-to-back time of
      both at a tiny (7, 13), and of the flagship's z staged and streamed;
  (g) a tiny config takes 3 training steps on cuda and, from the same
      weights, batches and latent noise, on cpu: loss dicts at rtol 1e-4 /
      atol 1e-6, parameters within 5% of what three Adam steps can move them
      (cuDNN's backward convolutions sum in another order);
  (h) the flagship trains through the normal entry points: configs/config.yml
      with a synthetic data section (4 batches of 256 frames at 240x320, so
      the device resize runs, 256 validation frames), one epoch, float32,
      load_data -> train_model into a temporary log directory; the losses
      are finite and fall, the moments kernels were launched once per step,
      all on the cluster kernels and none on moments.cu,
      and the checkpoint reloads to the same validation loss. Then the
      combined train + score step (train/bench_step.py) in bfloat16 with
      adam_lean: 5 warm-up and 10 timed steps. (2 training batches here; the
      two phases below run the same path.)
  (i) the per-dimension moments kernels of both arrangements vs their plain
      PyTorch versions on the card, column by column, forward and backward:
      (256, 2000) float32 and bfloat16, (768, 2000) float32, a ragged
      (37, 53), a batch of 1, a constant column among random ones, views
      that are not 16-byte aligned, an odd bfloat16 width, every cluster size
      the rule can take; tolerances as in (f); two runs equal bit for bit,
      staged and streamed equal, the backward equal to moments.cu's; through
      autograd with the variance row unused; bad inputs and refused
      arrangements raise; the times of (f) at (256, 2000) float32;
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
  (m) the int8 GEMM's two arrangements vs the plain PyTorch version on the
      card, bit for bit: IMMA in the tensor-core library's SASS (cuobjdump) and
      its ptxas report; the archived probe's (32, 268800, 4096) in one range;
      the encoder Dense's (1 and 16, 268800, 4000) in chunks of 131072 as
      ops/quant.py calls it (one launch on the tensor cores, 3 on the CUDA
      cores), the decoder Dense's (1 and 16, 2000, 134400), each by both
      arrangements and torch._int_mm; a ragged (3, 1003, 37) and a range off
      16 (CUDA cores); ragged M, N edges, M = 40, saturated chunks of 131072 (+
      and -) and a range past I32_EXACT_K that wraps (tensor cores); a view
      that is not 16-byte aligned takes the CUDA cores and the tensor-core
      launcher refuses it; bad inputs raise. Times: CUDA-event median of 100
      and the back-to-back device time of both arrangements and
      torch._int_mm (x zero-padded to 32 rows, which it needs, a call a chunk)
      at the probe's and the path's shapes, the plain version at the probe's;
  (n) the batched scorer (one launch for K = 16 frames with a validity mask)
      vs the plain batched version at 224x300x3, 8 ticks from mixed start
      states with some streams dropping ticks, per stream at the tolerances
      of (c), through stream_score_step_batched and through each arrangement;
      the times of (c) at K = 16;
  (o) a tiny config: the multi-camera engine on cuda vs cpu, K = 3 with one
      stream dropping ticks, float and w8a8 (the int8 GEMM counted by
      arrangement: the encoder's Dense layers on the tensor cores, the
      decoder's, K = 8, on the CUDA cores); w8 and w8a8 fidelity against the
      float forward; an int8 sidecar written, healed after a simulated kill
      between its two renames, and reloaded;
  (p) the flagship through run_all_cameras, as camera_streamer_torch.py
      --all-cameras --n-streams 16 --quantize drives it: 16 synthetic 240x320
      cameras, one dropping every 4th tick, 64 ticks in float and in w8a8 (the
      int8 GEMM launched once a quantized Dense on the tensor cores, 2 a tick,
      or once a chunk on the CUDA cores, as its rule sends each shape, counted
      by arrangement; the scorer once a tick on the cluster kernel), 64 frames on the
      single-stream engine in float and with quantize=True, the quantization
      pass timed, the reconstruction of a fixed batch against the float
      forward; then an int8-checkpoint boot of the same weights from a
      temporary quantized/ sidecar, with no float Dense on the device.
  (q) the six dense-update kernels (csrc/dense_grad_adam.cu) vs their plain
      PyTorch versions on the card: ragged (5, 37, 53) and (3, 1003, 250) and
      (64, 384, 256) in bfloat16 and float32, the probes' (768, 12800, 4000),
      (768, 12800, 4096) and (768, 2000, 13440) in bfloat16, views that do not
      start on a 16-byte boundary, step counts 1 and 5, both tiles. The
      streaming copy and both streaming epilogues equal their plain versions
      bit for bit (the same operations in the same order, each rounded once);
      the product is within one step of its dtype of a float64 product
      rounded once; w, mu, nu of the fused kernels are within one step of the
      plain version on a small share of elements (the K sums are taken in
      another order) and within 1/64 of the tensor's scale, as the archived
      harness asks; two runs give equal bits; bad inputs raise. Times at
      (768, 12800, 4000): CUDA-event median of 100 and back-to-back time of
      each kernel, its bound, its plain version and the PyTorch calls that
      compute the same function. The product alone takes the tensor cores
      (csrc/dense_grad_wgmma.cu) for bfloat16 at multiples of 8 on 16-byte
      boundaries and the CUDA-core tile kernel otherwise, counted per
      arrangement at every shape above; then the tensor-core kernel alone:
      HGMMA in its SASS (cuobjdump), its ptxas report, one-hot products in
      their place, small integers exact, (3, 64, 128), (200, 1000, 4000) and
      the flagship's (768, 268800, 4000), (768, 2000, 134400), (768, 4000,
      268800) within one bfloat16 step of a float64 product over row blocks
      of M on at most 1% of the elements, two runs equal; the flagship
      shapes timed beside the bound, the CUDA-core arrangement and
      torch.matmul(x.T, dz) (a yardstick only this script calls);
  (r) the probes at full width through probes/r11.py::run, as
      probe_r11_torch.py drives them: harness fused at enc (768, 268800,
      4000) and dec (768, 2000, 134400), variants torch and fused, with the
      check; harness diag, every variant; the encoder shape in the port's own
      (out, in) layout (768, 4000, 268800). Each kernel's launch count equals
      the steps taken, and dot_only's launches are all on the tensor cores; a
      kernel variant allocates nothing in a step, the torch variant at least
      one (M, N) gradient; at enc the whole state
      after one step agrees with the plain version taken over row blocks of
      M. Then the float32 epilogue on the flagship's two dense kernels beside
      ops/adam.py's adam_lean step on a tensor of the same shape (logged, not
      compared: they round mu differently).
  (s) the convolution weight-gradient kernels vs their plain PyTorch version
      and a float64 reference on the card. The CUDA-core kernel
      (csrc/conv_dw.cu): the archived check's two shapes, a ragged batch of 5
      and a shape with more channels than one tile (40 -> 70), in float32 and
      bfloat16, each also as views that do not start on a 16-byte boundary,
      which give the same bits (both calls take that kernel); odd H raises;
      two runs give equal bits; both gradients through the autograd Function
      against autograd of conv2d_same, float32 and bfloat16. The tensor-core
      kernel (csrc/conv_dw_wgmma.cu, bfloat16 with channel counts that are
      multiples of 8 on 16-byte boundaries, as ops.conv_dw.conv_dw_arrangement
      picks): HGMMA in its SASS (cuobjdump) and its ptxas report, one-hot
      products in their place, one line, conv2 at batch 2, a tail of
      positions, lines across the stages, a partial tile of CI, CO = 8 and
      two tiles of CO against float64, two runs equal, and each shape as a
      view one element into an allocation, which takes the CUDA-core kernel
      and is held to float64 as well; a wgmma launch off the rule raises.
      Then the flagship encoder's conv1 (768, 224, 300, 3 -> 32, the
      CUDA-core kernel) and conv2 (768, 112, 150, 32 -> 64, the tensor cores)
      in bfloat16 at the full batch, the float64 reference taken over blocks
      of 32 images. Tolerance: 1e-4 of the largest |dW| plus 1e-4 relative
      (12.9 M float32 additions in another order than the reference's; the
      products of bfloat16 values are exact). Times at conv1 and conv2:
      CUDA-event median of 100 and back-to-back time of the kernel, its
      bound, the plain version, cuDNN's weight gradient (a yardstick only
      this script calls), an NHWC copy of dy, and at conv2 the CUDA-core
      kernel on the same operands;
  (t) probes/r18.py's bench at full width, as probe_r18_torch.py --bench
      --batch 256 drives it: the flagship KurtosisGlobal train + score step in
      bfloat16 with adam_lean, with 0, 1 and 2 encoder convolutions' weight
      gradients routed through the kernel; the variants' losses after one
      update agree; then 3 warm-up + 10 timed steps a variant. The kernel's
      launches equal steps x routed convolutions, conv1's all on the CUDA-core
      kernel and conv2's all on the tensor cores; the global moments kernels
      launch once a step;
  (u) checkpoints of the flagship (float32, adam, 16 GB of state) from the
      card: two synchronous saves, the first of the weights alone (rounds 1
      and 2, ``current`` and the three stable symlinks present), a reload through load_model_from_directory to
      the same validation loss, then one AsyncSaver round with a training
      step taken between save and wait: the reloaded weights equal the state
      at save, not after the step. Seconds of each are logged.
  (v) the live application's persistence, recording and fleet CL at the
      flagship (float32 + adam): the seeded weights saved to a temporary log
      directory, then, as camera_streamer_torch.py runs ``-m <it> -c
      --model-cache-dir <cache> --async-autosave --record-dir <rec>``
      (stream/run.py, a replayed 20 frames/s clock, CL period 1 s), 64
      synthetic 240x320 frames: CL steps in frames 20, 41, 62, one async
      autosave in frame 39, recordings every 500 ms; the five PNG streams hold
      equal counts and labels.json annotates each recorded frame; the cache's
      round is committed after the drain, and load_engine_from_directory
      restores parameters and Adam moments equal bit for bit to clones taken
      at the autosave and scores a fixed frame from a copied scorer state with
      the original's bits; one synchronous autosave (the override, on the
      frame it blocks); the scorer once a frame on the cluster kernel. Then 16
      cameras (one dropping every 4th tick), a ring of 4 ticks, CL period 1 s,
      recording on, 32 ticks at 20 ticks/s through run_all_cameras: a fleet CL
      step with a finite loss, changed parameters and reconstruction,
      per-camera recordings, one fleet snapshot, the scorer once a tick.
      Logged: the seconds of the frames that carried each autosave, the frame
      p50 without either, the recording ticks' added ms, the fleet CL step's
      ms and max_memory_allocated. Four synchronous flagship saves: the seed
      directory (weights alone), the two recording snapshots and the override.
  (w) the scoring surfaces at the flagship: the seeded weights saved to a
      temporary log directory with config.yml (its data section pointing at
      a saved dataset of 512 synthetic 224x300 frames, a second one of 256 for
      evaluation) and an int8 sidecar. serve_torch.build_server(port=0,
      max_batch=16) in a thread, in float and booted from the sidecar (w8a8),
      driven by a client process: 64 /score requests one at a time, 128 from
      16 client threads at once, 8 /reconstruct; request p50/p95 (client and
      server side), batch fill and buckets, each batch's dispatch time by
      bucket under load and with the server idle, peak memory; every float
      eps against the plain float forward's of the same image at rtol 1e-5,
      every w8a8 batch again through the same forward
      with the plain int8 products (asserted equal to the kernel's) at rtol
      1e-5, w8a8 against float within 2%, float reconstructions within one
      grey level of the plain forward's; kernel 10 launched twice a w8a8
      batch, all on the tensor cores, never in float. Then
      do_anomaly_detection_torch.py's main in float with artifacts and with
      --quantize --histogram-only (the sidecar boot): each pass's frames/s,
      peak memory and int8 launches (2 a batch of 256, all mma); w8a8 frames'
      eps within 2% of float, so meu too, and sigma within the std of the
      frames' differences; one offline w8a8 batch against the plain int8
      products at rtol 1e-5. Last, kernel 10 at the offline batch's (256,
      268800, 4000) and (256, 2000, 134400): equal to the plain version, timed
      (mma, the CUDA cores, the plain version) beside torch._int_mm and the
      bound. Prints its own run time.
  (x) the JAX package's log directories and the RAITE / COCO-JSON data path. (x1) Each
      committed JAX-written fixture of tests/data/jax_logdirs (global_f32: KurtosisGlobal,
      float32, adam, a w8a8 sidecar; single_bf16: KurtosisSingle, bfloat16, adam_lean; both
      with a learning rate dialled away from the config's), read as
      tools/convert_logdir_torch.py's copy under converted/ (the card's machine has no
      tensorstore), through load_model_from_directory(restore_optimizer=True), timed: the eval
      forward against the JAX package's stored CPU outputs (float32 rtol 1e-4 / atol 1e-5,
      bfloat16 1e-2 / 1e-3); the live engine for 8 frames through kernel 1 from a warm
      scorer state (counts within 2, scores at rtol 1e-4 while counts agree); the w8a8
      forward from the sidecar through kernel 10 (both Dense layers on the tensor cores,
      within 2e-4 of JAX's, and equal to the forward with the plain int8 products); one
      training step with the JAX step's latent noise through kernel 2 (global_f32) or 3
      (single_bf16): the loss dict at rtol 1e-4 (bfloat16 1e-3) / atol 1e-6, the parameters
      within 0.05 lr (bfloat16: one step of the dtype plus 0.5 lr), the Adam moments after
      the step within 1e-3 (bfloat16 0.25) of the step's own change of each leaf, the step
      count and the learning rate the saved one; each kernel then against its plain
      version at the path's shapes. (x2) configs/raite.yml's model at its own widths
      (224x300x3, layers [32, 64], latent 200, KurtosisGlobal, batch 32) through
      train_torch.py's main on 1024 + 64 synthetic 300x224 PNG frames with COCO labels.json
      files, data.device_cache on, 3 epochs of 32 steps (the first decodes and fills the
      cache, the others read the card): every batch cached on the card and the host source
      read once, the cache's bytes, each epoch's wall clock over its frames with its first
      step included, the first epoch's host decode time, kernel 2's launches and a check of
      it at (32, 200).
  (y) the dataset builders and adam_fp8. (y1) 512 + 256 synthetic VeRi-layout crops (JPEG
      and PNG, six sizes) through build_veri_dataset_torch.py (224x224), then
      configs/veri.yml at its own widths (224x224x3, layers [32, 64], latent 256, batch
      256) with training.optimizer adam_fp8 through train_torch.py's main, 2 epochs of 2
      steps: each epoch's seconds, the losses, kernel 2's launches by arrangement, the
      encoder's and decoder's Dense moments quantized, the saved state reloaded bit for
      bit, kernel 2 against its plain version at (256, 256); then two synthetic videos
      through build_virat_dataset_torch.py --extract-frames 4 and the port's loader onto the
      card at virat_cl.yml's 224x300. (y2) the flagship's bfloat16 train + score step at
      batch 256, adam_lean then adam_fp8 from the same seeded weights and batch, 3 + 10
      steps each, synchronized: ms a step, max_memory_allocated (adam_fp8's no higher), the
      moments' bytes, each update timed alone, the losses finite, the first equal and the
      last within Y_LOSS_RTOL of each other; adam_fp8 on the card against the CPU's update.
  (z) parallel/ (data parallelism over the global batch, ZeRO-1, a model axis, scoring over
      a mesh). (z1) train_torch.py's main on configs/config.yml at flagship width (float32 +
      adam, 2 training and 1 validation batches of 256 synthetic 240x320 frames), once through
      --coordinator 127.0.0.1:<port> --num-processes 1 --process-id 0 (NCCL, the data-parallel
      path at world size 1) and once with --no-parallel: the losses equal at 1e-5 relative,
      kernel 2 launched once forward a step and once backward a training step, all cluster,
      both ways; each step's ms. (z2) two processes of this script (--worker) on the one
      card joined by gloo (NCCL refuses two ranks on one GPU; gloo carries CUDA tensors), the
      flagship float32 + adam + ZeRO-1, each rank its 128 rows of one seeded 256-frame batch,
      2 steps, against this process's 2 steps on the whole batch: the losses equal on both
      ranks and within 1e-4 of one process's, the moments' bytes of the sharded leaves halved
      on each rank, kernel 2 on every rank on the gathered z; ms a step and
      max_memory_allocated per rank. (z3) the same two processes as a (data 1, model 2) mesh,
      1 step: the encoder Dense's blocks (2000, 268800) on each rank, the loss within 1e-4.
      (z4) get_data_scale over an explicit one-device mesh, 256 frames, float and w8a8 (kernel
      10 twice under the mesh), equal to the no-mesh pass.
  (zm) the multi-camera engine on a device mesh and adam_fp8 on one. (zm1) the flagship fleet
      engine, 16 synthetic 240x320 cameras (the last dropping every 4th tick), 32 ticks float
      and 32 w8a8 with no mesh, make_mesh(devices=[dev]) and make_mesh(devices=[dev, dev]),
      from testing.py's warm scorer state: scores against no mesh's by testing.py's rule
      (float rtol 1e-5, w8a8 W8A8_EPS_RTOL), kernel 1 launched once a block a tick and kernel
      10 twice a block a w8a8 tick, all mma; tick p50 / p95 and, over 8 more ticks under
      torch.profiler, the device's busy ms a tick. (zm2) kernel 1 at a block's K = 8 and
      kernel 10 at M = 8 against their plain versions. (zm3) fleet CL, K = 16, a ring of 4
      ticks, 2 steps over the two-entry mesh against no mesh from the same seed: the losses
      within 1e-6, the 2-step update within 0.05 (update_gap). (zm4) two processes of this
      script (--worker --job zm) on the one card by gloo: on identical injected gradients each
      rank's blocks of the flagship Dense weights' q, scale, scale_next and parameter after 2
      adam_fp8 steps equal one process's bits, ZeRO-1 and (data 1, model 2); then the
      flagship bfloat16 with adam_fp8, 2 steps of one seeded 256-frame batch with ZeRO-1 and
      on (data 1, model 2), under cudnn.deterministic as the one process it is held against:
      the losses within 1e-6, the 2-step update within ZM_FP8_UPDATE_GAP, the float8 codes of
      the split leaves halved a rank; ms a step and max_memory_allocated a rank.

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
# kernel 1's two arrangements (ops.stream_score.stream_score_arrangement): the one-block kernel,
# which takes frames whose slice does not fit a CTA's shared memory, and the cluster kernel, which
# every frame of the main path takes
STREAM_KERNEL = {
    "name": "stream_score",
    "route": "cuda",
    "source": f"{PACKAGE}/csrc/stream_score.cu",
    "replaces": "trustedai_cl_vae_ad_tpu/ops/stream_score.py:98",
    "arrangement": "block",
}
STREAM_CLUSTER_KERNEL = dict(STREAM_KERNEL, name="stream_score_cluster", arrangement="cluster",
                             source=f"{PACKAGE}/csrc/stream_score_cluster.cu")
# (arrangement, cluster size) of the scorer held against its plain version and timed on the same
# operands in phases (c) and (n): both cluster sizes the rule may take, and the one-block kernel
SCORER_VARIANTS = [("cluster", 16), ("cluster", 8), ("block", 1)]
# kernel 10's two arrangements (ops.int8_gemm.int8_gemm_arrangement): the tensor-core kernel,
# which the flagship's w8a8 path runs, and the CUDA-core one, which takes operands off the rule
# (the tiny model's decoder Dense of K = 8 in phase o)
INT8_KERNEL = {
    "name": "int8_gemm",
    "route": "cuda",
    "source": f"{PACKAGE}/csrc/int8_gemm.cu",
    "replaces": "benchmarks/r4_int8_gemm.py:45",
    "arrangement": "cuda_core",
}
INT8_MMA_KERNEL = dict(INT8_KERNEL, name="int8_gemm_mma", arrangement="mma",
                       source=f"{PACKAGE}/csrc/int8_gemm_mma.cu")
DGA_SOURCE = {"route": "cuda", "source": f"{PACKAGE}/csrc/dense_grad_adam.cu"}
# the bf16 product alone runs on the tensor cores (ops.dense_grad_adam.dense_grad_arrangement)
DGW_SOURCE = {"route": "cuda", "source": f"{PACKAGE}/csrc/dense_grad_wgmma.cu",
              "arrangement": "wgmma"}
# name in the kernels' line -> (its counter in ops.dense_grad_adam.launches, the TPU kernel,
# the source of the kernel that the main path launches)
DGA_KERNELS = {
    "dense_grad_adam_fused": ("fused", "benchmarks/r11_kernel.py:84", DGA_SOURCE),
    "dense_grad_adam_fused_xt": ("fused_xt", "benchmarks/r11_diag.py:132", DGA_SOURCE),
    "dense_grad": ("dense_grad", "benchmarks/r11_diag.py:163", DGW_SOURCE),
    "stream_copy": ("stream_copy", "benchmarks/r11_diag.py:183", DGA_SOURCE),
    "adam_epilogue_bf16": ("epilogue_bf16", "benchmarks/r11_diag.py:207", DGA_SOURCE),
    "adam_epilogue_f32": ("epilogue_f32", "benchmarks/r11_diag.py:238", DGA_SOURCE),
}
# kernel 11's two arrangements (ops.conv_dw.conv_dw_arrangement): the CUDA-core kernel, which the
# main path runs at conv1, and the tensor-core one, which it runs at conv2
CONV_DW_KERNEL = {
    "name": "conv_dw",
    "route": "cuda",
    "source": f"{PACKAGE}/csrc/conv_dw.cu",
    "replaces": "benchmarks/r18_conv_dw.py:53",
    "arrangement": "cuda_core",
}
CONV_DW_WGMMA_KERNEL = dict(CONV_DW_KERNEL, name="conv_dw_wgmma", arrangement="wgmma",
                            source=f"{PACKAGE}/csrc/conv_dw_wgmma.cu")
# (B, H, W, CI, CO): the archived check's two shapes, a ragged batch, more channels than a tile
CONV_DW_SMALL = [(2, 8, 12, 3, 8), (3, 16, 16, 5, 4), (5, 6, 10, 3, 32), (3, 4, 70, 40, 70)]
# the tensor-core arrangement's: one line, conv2 at batch 2, a tail of positions (105), lines of
# 67 positions across the stages of 64, a second (partial) tile of CI, CO = 8, two tiles of CO
CONV_DW_WGMMA_SMALL = [(1, 4, 150, 32, 64), (2, 112, 150, 32, 64), (7, 10, 6, 16, 24),
                       (3, 6, 134, 32, 64), (3, 4, 70, 40, 64), (5, 6, 130, 64, 8),
                       (2, 4, 140, 32, 128)]
# ((B, H, W, CI, CO), x index, dy index): a 1 in each puts dW's only nonzero at (h - 2 oh,
# w - 2 ow, ci, co): tile corners, all three warpgroups (kh), the right padding column, the
# bottom row, second tiles of CI and CO, the last position of the last split
CONV_DW_ONE_HOT = [((1, 4, 150, 32, 64), (0, 0, 0, 0), (0, 0, 0, 0)),
                   ((1, 4, 150, 32, 64), (0, 3, 149, 31), (0, 1, 74, 63)),
                   ((1, 4, 150, 32, 64), (0, 2, 148, 17), (0, 1, 74, 40)),
                   ((2, 8, 140, 40, 72), (1, 7, 139, 39), (1, 3, 69, 71)),
                   ((2, 8, 140, 40, 72), (1, 6, 130, 33), (1, 2, 64, 70)),
                   ((2, 112, 150, 32, 64), (1, 111, 149, 31), (1, 55, 74, 63))]
CONV_DW_BATCH, CONV_DW_BLOCK = 768, 32
R18_BATCH, R18_WARMUP, R18_STEPS = 256, 3, 10
# kernels 2 and 3's two arrangements: the cluster kernels, which every CUDA tensor takes, and
# csrc/moments.cu, the yardstick they are checked and timed against (only by name)
MOMENTS_SOURCES = {
    "cluster": {"route": "cuda", "source": f"{PACKAGE}/csrc/moments_cluster.cu",
                "arrangement": "cluster"},
    "blocks": {"route": "cuda", "source": f"{PACKAGE}/csrc/moments.cu", "arrangement": "blocks"},
}
JAX_MOMENTS = "trustedai_cl_vae_ad_tpu/ops/moments.py"
MOMENTS_KERNELS = {
    "global": (f"{JAX_MOMENTS}:77", f"{JAX_MOMENTS}:174"),
    "perdim": (f"{JAX_MOMENTS}:98", f"{JAX_MOMENTS}:210"),
}
# NVIDIA's H100 SXM data sheet: device memory rate, float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
INT8_OP_PER_S = 1979e12  # dense int8 rate of the tensor cores
BF16_FLOP_PER_S = 989e12  # dense bfloat16 rate of the tensor cores
# the dense-update probes: small shapes in both dtypes, the archived harnesses' in bfloat16
DGA_SMALL_SHAPES = [(5, 37, 53), (3, 1003, 250), (64, 384, 256)]
DGA_DIAG_SHAPE = (768, 12800, 4000)
DGA_LARGE_SHAPES = [DGA_DIAG_SHAPE, (768, 12800, 4096), (768, 2000, 13440)]
DGA_PORT_LAYOUT = (768, 4000, 268800)  # the encoder Dense as the port stores it, (out, in)
# kernel 6's tensor-core arrangement: a K tail, a masked N edge, and the flagship's dense
# shapes (the encoder Dense both ways round, the decoder Dense)
DGW_SMALL_SHAPES = [(3, 64, 128), (200, 1000, 4000)]
DGW_FLAGSHIP_SHAPES = [(768, 268800, 4000), (768, 2000, 134400), (768, 4000, 268800)]
# (K, M, N, k, i, j): a 1 at x[k, i] and dz[k, j] puts g's only nonzero at (i, j): tile
# corners, the second warpgroup, the last stage of K, the masked N edge, a second tile
DGW_ONE_HOT = [(200, 256, 200, 0, 0, 0), (200, 256, 200, 199, 127, 199),
               (200, 256, 200, 130, 200, 131), (200, 256, 200, 71, 71, 9),
               (3, 64, 128, 2, 63, 127)]
DGA_STEPS = 10
PROBE_SHAPE = (32, 268800, 4096)  # benchmarks/r4_int8_gemm.py:81
# (M, K, N) of the two quantized Dense layers on the multi-camera and the single-stream path
PATH_SHAPES = [(16, 268800, 4000), (1, 268800, 4000), (16, 2000, 134400), (1, 2000, 134400)]
FLEET_STREAMS, FLEET_TICKS, DROP_EVERY = 16, 64, 4
# (shape, dtype, elements the view starts into its allocation): the flagship in both types
# (staged), (768, 2000) float32 (streamed), ragged ones, and views off 16 bytes
MOMENT_SHAPES = [((256, 2000), "float32", 0), ((256, 2000), "bfloat16", 0),
                 ((768, 2000), "float32", 0), ((7, 13), "float32", 0), ((7, 13), "bfloat16", 0),
                 ((10, 100), "float32", 1), ((37, 53), "bfloat16", 1)]
GRAD_WEIGHTS = (0.3, -0.7, 1.1, 0.9)
PERDIM_SHAPES = [((256, 2000), "float32"), ((256, 2000), "bfloat16"), ((768, 2000), "float32"),
                 ((37, 53), "float32"), ((37, 53), "bfloat16"), ((1, 53), "float32")]
VAL_STEPS, BATCH = 1, 256
CL_FRAMES, CL_FPS, CL_PERIOD_MS, CL_REPLAY = 64, 20.0, 1000.0, 8
# phase (v): on CL_FPS's replayed clock the first frame seeds the autosave clock at 0.05 s, so
# the period fires once, at frame 39 (2.0 s), after the CL step of frame 20 and before those of
# frames 41 and 62; recordings every 500 ms (frames 9, 19, ..., 59)
PERSIST_AUTOSAVE_S = 1.92
FLEET_CL_TICKS, FLEET_CL_RING = 32, 4
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
    """Median over ``runs`` calls, each between two CUDA events."""
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


def int8_bound(m, k, n):
    """(bound_ms, bound_by) of an int8 product: x, w read and the int32 result
    written once, against 2 m k n operations at the int8 tensor-core rate."""
    by_bytes = (m * k + n * k + 4 * m * n) / HBM_BYTES_PER_S * 1e3
    by_ops = 2 * m * k * n / INT8_OP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def product_bound(nbytes, flops):
    """(bound_ms, bound_by) of a kernel whose operations are a bfloat16 matrix
    product: against the tensor cores' dense bfloat16 rate."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
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


def moments_bounds(n, size, out_numel):
    """(bound_ms, bound_by) of a moments forward and backward over n elements of ``size``
    bytes with ``out_numel`` moments: the forward reads z once and writes the moments, about
    2 operations an element for the sum and 8 for the centred powers and their sums; the
    backward reads z, the moments and their gradients and writes the gradient, about 14 an
    element."""
    record = {}
    record["bound_ms"], record["bound_by"] = bound(n * size + 4 * out_numel, 10 * n)
    record["bwd_bound_ms"], record["bwd_bound_by"] = bound(2 * n * size + 2 * 4 * out_numel,
                                                           14 * n)
    return record


def time_moments(z, out, gout, forward, plain_forward, backward, plain_backward, library):
    """Times and bounds of a moments kernel pair at z's shape, both arrangements on the same
    operands: CUDA-event medians of 100 through the entry point, the back-to-back device
    times, the plain versions, and the one PyTorch call that computes half of the
    forward."""
    record = {
        "plain_ms": median_ms(lambda: plain_forward(z)),
        "plain_bwd_ms": median_ms(lambda: plain_backward(z, out, gout)),
        "library_ms": median_ms(lambda: library(z)),
    }
    for arrangement in ("cluster", "blocks", "blocks", "cluster"):  # in turns
        times = record.setdefault(arrangement, {})
        for key, fn in (("ms", lambda: median_ms(lambda: forward(z, arrangement=arrangement))),
                        ("device_ms", lambda: queued_ms(
                            lambda: forward(z, arrangement=arrangement))),
                        ("bwd_ms", lambda: median_ms(
                            lambda: backward(z, out, gout, arrangement=arrangement))),
                        ("bwd_device_ms", lambda: queued_ms(
                            lambda: backward(z, out, gout, arrangement=arrangement)))):
            times.setdefault(f"{key}_runs", []).append(fn())
    for times in (record["cluster"], record["blocks"]):
        for key in ("ms", "device_ms", "bwd_ms", "bwd_device_ms"):
            times[key] = min(times[f"{key}_runs"])
    record.update(moments_bounds(z.numel(), z.element_size(), out.numel()))
    return record


def moments_fixed_costs(mo, kind, z, dev):
    """Back-to-back device times that separate a moments forward's fixed cost from its data:
    both arrangements at a tiny (7, 13) float32, and the flagship's z both staged and
    streamed (the rule stages it)."""
    import torch

    op = f"{kind}_forward"
    tiny = moments_operand(dev, (7, 13), "float32", seed=7)
    rule = mo.moments_arrangement(kind, z.shape, z.dtype, z.data_ptr() % 16 == 0)
    assert rule.staged, rule
    out = {f"tiny_{name}_device_ms": queued_ms(lambda: mo._launch(op, name, tiny))
           for name in ("cluster", "blocks")}
    for staged in (True, False):
        arrangement = rule._replace(staged=staged)
        out[f"{'staged' if staged else 'streamed'}_device_ms"] = queued_ms(
            lambda: mo._launch(op, arrangement, z))
    torch.cuda.synchronize()
    log(f"  {kind} forward, back to back: (7, 13) float32 cluster "
        f"{out['tiny_cluster_device_ms']:.4f} ms, blocks {out['tiny_blocks_device_ms']:.4f} ms; "
        f"{tuple(z.shape)} {z.dtype} staged {out['staged_device_ms']:.4f} ms, streamed "
        f"{out['streamed_device_ms']:.4f} ms")
    return out


def log_moments_times(label, record):
    for arrangement in ("cluster", "blocks"):
        t = record[arrangement]
        log(f"  {label} {arrangement}: forward median of 100 {t['ms']:.4f} ms "
            f"(runs {t['ms_runs']}), back to back {t['device_ms']:.4f} ms "
            f"({t['device_ms_runs']}); backward {t['bwd_ms']:.4f} ms ({t['bwd_ms_runs']}), "
            f"back to back {t['bwd_device_ms']:.4f} ms ({t['bwd_device_ms_runs']})")
    log(f"  {label} plain {record['plain_ms']:.4f} ms, backward {record['plain_bwd_ms']:.4f} ms; "
        f"library (half the forward) {record['library_ms']:.4f} ms; bound "
        f"{record['bound_ms']:.5f} ms, backward {record['bwd_bound_ms']:.5f} ms")


def moments_entries(kind, record, arrangements):
    """The kernels' JSON lines (forward, backward of each arrangement) of one moments kernel
    pair; ``arrangements``: the launches by operation and arrangement on the main path. No
    one PyTorch call computes the analytic backward."""
    fwd_line, bwd_line = MOMENTS_KERNELS[kind]
    entries = []
    for arrangement, source in MOMENTS_SOURCES.items():
        t = record[arrangement]
        prefix = "moments_cluster" if arrangement == "cluster" else "moments"
        entries.append(dict(
            source, name=f"{prefix}_{kind}_forward", replaces=fwd_line,
            launches=arrangements[f"{kind}_forward"][arrangement],
            max_abs_err=record["errors"][arrangement], ms=t["ms"], plain_ms=record["plain_ms"],
            bound_ms=record["bound_ms"], bound_by=record["bound_by"],
            library_ms=record["library_ms"], device_ms=t["device_ms"]))
        entries.append(dict(
            source, name=f"{prefix}_{kind}_backward", replaces=bwd_line,
            launches=arrangements[f"{kind}_backward"][arrangement],
            max_abs_err=record["bwd_errors"][arrangement], ms=t["bwd_ms"],
            plain_ms=record["plain_bwd_ms"], bound_ms=record["bwd_bound_ms"],
            bound_by=record["bwd_bound_by"], library_ms=None, device_ms=t["bwd_device_ms"]))
    return entries


def scorer_bound(k, h, w, c):
    """(bound_ms, bound_by) of one scorer update of k frames: img and rec read, maps and
    scalars read and written, norm and [score, count] written; about 3 operations a channel
    and 30 a pixel."""
    nbytes = 4 * k * (2 * h * w * c + 2 * 2 * h * w + 2 * 6 + h * w + 2)
    return bound(nbytes, k * h * w * (3 * c + 30))


def forced_scorer(arrangement, clusters):
    """A single-frame scorer step through the named arrangement, uncounted."""
    from trustedai_cl_vae_ad_tpu_torch.ops import stream_score as ss

    def step(state, img, rec, alpha):
        maps, scalars, norm, sc = ss._launch(arrangement, clusters, (), img, rec, state.maps,
                                             state.scalars, alpha, None)
        return ss.StreamScoreState(maps, scalars), norm, sc[0], sc[1]
    return step


def scorer_times(launch, plain, k, h, w, c):
    """The CUDA-event median of 100 and the back-to-back time of each arrangement's launch
    on the same operands (``launch(arrangement, clusters)``), the plain version's median
    (of 10 at K > 1) and the bound."""
    rows = {}
    for arrangement, clusters in SCORER_VARIANTS:
        rows[f"{arrangement}{clusters if arrangement == 'cluster' else ''}"] = dict(
            ms=median_ms(lambda: launch(arrangement, clusters)),
            device_ms=queued_ms(lambda: launch(arrangement, clusters)))
    plain_ms = (median_ms(plain) if k == 1 else median_ms(plain, runs=10, warmup=2))
    bound_ms, bound_by = scorer_bound(k, h, w, c)
    return rows, dict(plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def scorer_records(rule, errors, rows, common):
    """The kernels' line records of the two arrangements: the cluster kernel at the size the
    rule takes, the one-block kernel, each with its error against the plain version."""
    cluster = f"cluster{rule[1]}"
    return {"cluster": dict(common, max_abs_err=errors[cluster], clusters=rule[1], **rows[cluster]),
            "block": dict(common, max_abs_err=errors["block"], **rows["block"]),
            "variants": rows, "max_abs_err": errors}


def log_scorer_times(label, rows, common):
    for name, row in rows.items():
        log(f"  {label} {name}: median of 100 {row['ms']:.4f} ms, back to back "
            f"{row['device_ms']:.4f} ms ({common['bound_ms'] / row['device_ms']:.1%} of the "
            f"bound {common['bound_ms']:.5f} ms)")
    log(f"  {label} plain version {common['plain_ms']:.4f} ms")


def occupancy_line(ss, hw):
    """cudaOccupancyMaxActiveClusters and the slice of each cluster size at hw pixels."""
    return "; ".join(
        f"C = {clusters}: cudaOccupancyMaxActiveClusters {ss.cluster_occupancy(hw, clusters)}, "
        f"slice {ss.cluster_slice(hw, clusters)} pixels ({4 * ss.cluster_slice(hw, clusters)} "
        f"bytes of shared memory a CTA)" for clusters in (16, 8))


def phase_c(dev):
    """The scorer's arrangements vs the plain version on the card, one frame at a time:
    through the entry point (the rule's arrangement, counted) and through each of
    SCORER_VARIANTS; returns the records of both arrangements with their times."""
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

    errors = {}
    for h, w, c in SEQ_SHAPES:
        rule = ss.stream_score_arrangement(1, h * w, c)
        assert rule[0] == "cluster", (h, w, c, rule)
        for start in STARTS:
            imgs, recs, maps0, scalars0 = score_sequence(h, w, c, 8, seed=h, start=start)

            def state0():
                return ss.StreamScoreState(torch.from_numpy(maps0).to(dev),
                                           torch.from_numpy(scalars0).to(dev))
            ref = run_sequence(step(ss.stream_score_step_reference), state0(), imgs, recs, ALPHA)
            before = (ss.launches, ss.stream_score_arrangements["cluster"])
            got = run_sequence(step(ss.stream_score_step), state0(), imgs, recs, ALPHA)
            assert (ss.launches, ss.stream_score_arrangements["cluster"]) == (
                before[0] + 8, before[1] + 8), "one cluster launch a frame"
            compare_sequences(got, ref, f"{h}x{w}x{c} {start} entry point")
            line = []
            for arrangement, clusters in SCORER_VARIANTS:
                name = f"{arrangement}{clusters if arrangement == 'cluster' else ''}"
                forced = run_sequence(step(forced_scorer(arrangement, clusters)), state0(), imgs,
                                      recs, ALPHA)
                err = compare_sequences(forced, ref, f"{h}x{w}x{c} {start} {name}")
                if (h, w, c) == SEQ_SHAPES[0]:
                    errors[name] = max(errors.get(name, 0.0), err)
                line.append(f"{name} {err:.3g}")
            counts = [int(o[4]) for o in got]
            dcount = max(abs(g[4] - r[4]) for g, r in zip(got, ref))
            nan = sum(bool(np.isnan(o[3])) for o in got)
            log(f"  {h}x{w}x{c} {start:9s}: rule {rule}, max_abs_err {', '.join(line)}; counts "
                f"{counts}, max |count - plain| {dcount:g}, NaN scores {nan}")
    h, w, c = SEQ_SHAPES[0]
    rule = ss.stream_score_arrangement(1, h * w, c)
    log(f"  {occupancy_line(ss, h * w)}")
    resources = {name: resource_usage(name) for name in ("stream_score_cluster", "stream_score")}
    for name, lines in resources.items():
        assert lines, f"cuobjdump found no kernel in {name}"
        log(f"  {name}: {'; '.join(lines)}")
    imgs, recs, maps0, scalars0 = score_sequence(h, w, c, 8, seed=1, start="converged")
    state = ss.StreamScoreState(torch.from_numpy(maps0).to(dev), torch.from_numpy(scalars0).to(dev))
    img, rec = torch.from_numpy(imgs[3]).to(dev), torch.from_numpy(recs[3]).to(dev)
    rows, common = scorer_times(
        lambda arrangement, clusters: ss._launch(arrangement, clusters, (), img, rec, state.maps,
                                                 state.scalars, ALPHA, None),
        lambda: ss.stream_score_step_reference(state, img, rec, ALPHA), 1, h, w, c)
    entry_ms = median_ms(lambda: ss.stream_score_step(state, img, rec, ALPHA))
    log_scorer_times(f"{h}x{w}x{c} K = 1", rows, common)
    log(f"  {h}x{w}x{c} K = 1 through stream_score_step (rule {rule}): median of 100 "
        f"{entry_ms:.4f} ms")
    return dict(scorer_records(rule, errors, rows, common), entry_ms=entry_ms, rule=rule,
                resources=resources)


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


def reset_scorer_counts(stream_score):
    stream_score.launches = 0
    for arrangement in stream_score.stream_score_arrangements:
        stream_score.stream_score_arrangements[arrangement] = 0


def scorer_counts(stream_score, n):
    """The scorer's launches by arrangement since the reset: n in all, all on the cluster
    kernel (the rule's for the flagship's 224x300 frames, one and 16 at a time)."""
    counts = dict(stream_score.stream_score_arrangements)
    assert stream_score.launches == n and counts == {"cluster": n, "block": 0}, (
        stream_score.launches, counts, n)
    return counts


def phase_e():
    """The flagship on the card through the CLI's run loop; returns the
    scorer's launches by arrangement and the run's summary."""
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
    reset_scorer_counts(stream_score)
    summary = run_stream(engine, source, on_result=results.append, log=lambda m: None)
    launches = scorer_counts(stream_score, len(results))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    assert summary["frames"] == 64 and len(results) == 64, summary
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


def moments_operand(dev, shape, dtype, offset=0, seed=0):
    """z of shape and dtype (a name), ``offset`` elements into its allocation."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    rows, cols = shape
    flat = torch.randn(rows * cols + offset, device=dev, generator=gen) * 1.3 + 0.4
    return flat.to(getattr(torch, dtype))[offset:].view(rows, cols)


def close_moments(got, ref):
    """rtol 1e-5 on mean and variance, 1e-4 on skew and kurtosis (the order of the sums
    differs), with an absolute floor of 1e-6 for values that are small differences of large
    sums (the skew of a near-symmetric sample); rows or elements 0-1 and 2-3."""
    import torch

    torch.testing.assert_close(got[:2], ref[:2], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[2:], ref[2:], rtol=1e-4, atol=1e-6)


def moments_resources(mo, kinds):
    """The cluster source's registers, shared memory and stack (cuobjdump), its ptxas
    report, and cudaOccupancyMaxActiveClusters of the flagship's arrangements."""
    import torch

    lines = resource_usage("moments_cluster")
    assert lines, "cuobjdump found no kernel in moments_cluster"
    for line in lines + ptxas_report("moments_cluster"):
        log(f"  moments_cluster: {line}")
    occupancy = {}
    for kind in kinds:
        for dtype in (torch.float32, torch.bfloat16):
            arrangement = mo.moments_arrangement(kind, (256, 2000), dtype, True)
            active = mo.cluster_occupancy(arrangement, dtype)
            assert active >= 1, (kind, dtype, arrangement)
            occupancy[f"{kind} {dtype}"] = active
            log(f"  {kind} (256, 2000) {dtype}: {arrangement}, cudaOccupancyMaxActiveClusters "
                f"{active}")
    return {"resources": lines, "occupancy": occupancy}


def phase_f(dev):
    """The global moments kernels of both arrangements vs their plain versions on the card;
    returns the record at the flagship's (256, 2000) float32."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops import moments as mo

    gout = torch.tensor(GRAD_WEIGHTS, device=dev)
    record = {}
    for shape, dtype, offset in MOMENT_SHAPES:
        z = moments_operand(dev, shape, dtype, offset, seed=shape[0])
        rule = mo.moments_arrangement("global", z.shape, z.dtype, z.data_ptr() % 16 == 0)
        out = mo.global_moments_packed(z)
        blocks = mo.global_moments_packed(z, arrangement="blocks")
        ref = torch.stack(mo.global_moments_reference(z))
        torch.cuda.synchronize()
        close_moments(out, ref)
        close_moments(blocks, ref)
        assert torch.equal(out, mo.global_moments_packed(z)), "two runs differ"
        other = rule._replace(staged=not rule.staged)
        forced = rule.vector and other.slice * z.element_size() <= mo.STAGE_BUDGET_BYTES
        if forced:  # the other of staged and streamed on the same operands: the same bits
            assert torch.equal(out, mo._launch("global_forward", other, z)), (
                "staged and streamed differ")
        grad = mo.global_moments_backward(z, out, gout)
        grad_blocks = mo.global_moments_backward(z, out, gout, arrangement="blocks")
        grad_ref = mo.global_moments_backward_reference(z, out, gout)
        assert grad.dtype == z.dtype and grad.shape == z.shape
        assert torch.equal(grad, mo.global_moments_backward(z, out, gout)), "two runs differ"
        assert torch.equal(grad, grad_blocks), "the backward differs from moments.cu's"
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
        errors = {"cluster": float((out - ref).abs().max()),
                  "blocks": float((blocks - ref).abs().max())}
        gerr = float((grad.float() - grad_ref.float()).abs().max())
        log(f"  {shape} {dtype} at +{offset}: {rule}; moments "
            f"{[round(v, 6) for v in out.tolist()]}, max_abs_err cluster {errors['cluster']:.3g}, "
            f"blocks {errors['blocks']:.3g}; gradient max_abs_err {gerr:.3g} of {scale:.3g}, "
            f"equal to moments.cu's; {'staged = streamed, ' if forced else ''}two runs equal")
        if (shape, dtype, offset) == MOMENT_SHAPES[0]:
            record.update(errors=errors, bwd_errors={"cluster": gerr, "blocks": gerr},
                          arrangement=rule._asdict())
            # torch.var_mean gives two of the four moments: half the work
            record.update(time_moments(
                z, out, gout, mo.global_moments_packed, mo.global_moments_reference,
                mo.global_moments_backward, mo.global_moments_backward_reference,
                lambda t: torch.var_mean(t, correction=0)))
            record.update(moments_fixed_costs(mo, "global", z, dev))
    const = torch.full((16, 128), 0.5, device=dev)
    for arrangement in ("cluster", "blocks"):
        out = mo.global_moments_packed(const, arrangement=arrangement)
        assert out.tolist() == [0.5, 0.0, 0.0, 0.0], (arrangement, out.tolist())
        assert torch.isfinite(mo.global_moments_backward(const, out, gout,
                                                         arrangement=arrangement)).all()
    for bad, error in ((const.double(), TypeError), (const[0], ValueError),
                       (const.t(), ValueError)):
        expect_raises(lambda: mo.global_moments(bad), error,
                      f"global_moments of a {bad.dtype} tensor of shape {tuple(bad.shape)}")
    z = moments_operand(dev, (256, 2000), "float32")
    flagship = mo.moments_arrangement("global", z.shape, z.dtype, True)
    for bad in (flagship._replace(cluster=17, slice=30124),  # past Hopper's largest cluster
                flagship._replace(slice=flagship.slice - 4),  # slices that miss elements
                flagship._replace(cluster=2, slice=256000)):  # a staged slice past the budget
        expect_raises(lambda: mo._launch("global_forward", bad, z), RuntimeError,
                      f"a global forward in {bad}")
    torch.cuda.synchronize()
    record.update(moments_resources(mo, ("global",)))
    log_moments_times("(256, 2000) float32", record)
    return record


def phase_i(dev):
    """The per-dimension moments kernels of both arrangements vs their plain versions on
    the card, column by column; returns the record at the flagship's (256, 2000)
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
        rule = mo.moments_arrangement("perdim", z.shape, z.dtype, z.data_ptr() % 16 == 0)
        out = mo.perdim_moments_packed(z)
        blocks = mo.perdim_moments_packed(z, arrangement="blocks")
        ref = torch.stack(mo.perdim_moments_reference(z))
        torch.cuda.synchronize()
        assert out.shape == (4, cols) and out.dtype == torch.float32
        close_moments(out, ref)
        close_moments(blocks, ref)
        assert torch.equal(out, mo.perdim_moments_packed(z)), "two runs differ"
        if rule.staged:  # pass 2 reading z again instead of the staged rows: the same bits
            assert torch.equal(out, mo._launch("perdim_forward", rule._replace(staged=False),
                                               z)), "staged and streamed differ"
        grad = mo.perdim_moments_backward(z, out, gout)
        grad_ref = mo.perdim_moments_backward_reference(z, out, gout)
        assert grad.dtype == z.dtype and grad.shape == z.shape
        assert bool(torch.isfinite(grad.float()).all())
        assert torch.equal(grad, mo.perdim_moments_backward(z, out, gout)), "two runs differ"
        assert torch.equal(grad, mo.perdim_moments_backward(z, out, gout, arrangement="blocks")), (
            "the backward differs from moments.cu's")
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
        errors = {"cluster": float((out - ref).abs().max()),
                  "blocks": float((blocks - ref).abs().max())}
        gerr = float((grad.float() - grad_ref.float()).abs().max())
        log(f"  {label}: {rule}; max_abs_err cluster {errors['cluster']:.3g}, blocks "
            f"{errors['blocks']:.3g} over {4 * cols} moments; gradient max_abs_err {gerr:.3g} of "
            f"{scale:.3g}, equal to moments.cu's; two runs equal")
        return out, gout, errors, gerr

    def randn(shape, dtype, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return (torch.randn(shape, device=dev, generator=gen) * 1.3 + 0.4).to(dtype)

    record = {}
    before = (mo.launches, mo.bwd_launches)
    for shape, dtype in PERDIM_SHAPES:
        z = randn(shape, getattr(torch, dtype), shape[0])
        # one row has no spread: the plain forward's autograd is 0/0 there
        out, gout, errors, gerr = check(z, f"{shape} {dtype}", autograd=shape[0] > 1)
        if shape[0] == 1:
            assert float(out[1:].abs().max()) == 0.0, "a batch of one has var = skew = kurt = 0"
        if (shape, dtype) == PERDIM_SHAPES[0]:
            record.update(errors=errors, bwd_errors={"cluster": gerr, "blocks": gerr},
                          arrangement=mo.moments_arrangement("perdim", z.shape, z.dtype,
                                                             True)._asdict())
            record.update(time_moments(
                z, out, gout, mo.perdim_moments_packed, mo.perdim_moments_reference,
                mo.perdim_moments_backward, mo.perdim_moments_backward_reference,
                lambda t: torch.var_mean(t, dim=0, correction=0)))
            record.update(moments_fixed_costs(mo, "perdim", z, dev))
    for dtype in (torch.float32, torch.bfloat16):
        z = randn((64, 40), dtype, 7)
        z[:, 5] = 2.0  # exact in both types, so the column's variance is exactly 0
        out, _gout, _err, _gerr = check(z, f"(64, 40) {dtype} with a constant column",
                                        autograd=False)
        assert out[:, 5].tolist() == [2.0, 0.0, 0.0, 0.0], out[:, 5].tolist()
    # contiguous views that start one element into an allocation: 4 bytes (float32) and 2
    # bytes (bfloat16); an odd bfloat16 width; every cluster size the rule can take
    check(randn((37 * 53 + 1,), torch.float32, 8)[1:].view(37, 53), "(37, 53) float32 view at +4 B")
    check(randn((10 * 100 + 1,), torch.bfloat16, 9)[1:].view(10, 100),
          "(10, 100) bfloat16 view at +2 B")
    check(randn((9, 301), torch.bfloat16, 11), "(9, 301) bfloat16")
    z = randn((256, 2000), torch.float32, 12)
    ref = torch.stack(mo.perdim_moments_reference(z))
    rule = mo.moments_arrangement("perdim", z.shape, z.dtype, True)
    for cluster in (1, 2, 4):
        close_moments(mo._launch("perdim_forward",
                                 rule._replace(cluster=cluster, slice=256 // cluster), z), ref)
    assert (mo.launches, mo.bwd_launches) == before, "the global kernels ran"
    for bad in (rule._replace(cluster=3, slice=86), rule._replace(cluster=16, slice=16),
                rule._replace(slice=16)):
        expect_raises(lambda: mo._launch("perdim_forward", bad, z), RuntimeError,
                      f"a per-dimension forward in {bad}")
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
    torch.cuda.synchronize()
    record.update(moments_resources(mo, ("perdim",)))
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
    of the moments kernels: {"launched": (global forward, global backward,
    per-dimension forward, per-dimension backward), "arrangements": those by
    operation and arrangement}, all on the cluster kernels."""
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
        moments.reset_counts()
        t0 = time.perf_counter()
        train_model(config, model, data, log_every=1)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launched = counts()
        arrangements = {op: dict(c) for op, c in moments.moments_arrangements.items()}
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
        # every launch on the cluster kernels, none on moments.cu
        assert arrangements == {op: {"cluster": n, "blocks": 0}
                                for op, n in zip(moments.OPS, expected)}, arrangements
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
            f"{launched[1]} backward; per dimension {launched[2]} forward, {launched[3]} backward "
            f"(by arrangement {arrangements})")
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
    result = {"launched": launched, "arrangements": arrangements}
    if not bf16_steps:
        return result

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
    assert all(c["blocks"] == 0 for c in moments.moments_arrangements.values()), (
        moments.moments_arrangements)
    assert z_scores.shape == (BATCH,) and bool(torch.isfinite(z_scores).all())
    assert bool(torch.isfinite(loss))
    peak = torch.cuda.max_memory_allocated()
    log(f"  {model_type}, bfloat16 adam_lean train + score step, batch {BATCH}, uint8 input: "
        f"{ms:.2f} ms per step, {BATCH / ms * 1e3:.1f} frames/s (10 steps after 5 warm-up, "
        f"synchronized); loss {float(loss):.6f}; max_memory_allocated {peak / 2**30:.2f} GiB")
    del model, x_u8
    torch.cuda.empty_cache()
    return result


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
    CL step each for the other two types at a tiny size. Returns the scorer's
    launches by arrangement in the flagship's CL stream."""
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
    reset_scorer_counts(stream_score)
    before = (moments.launches, moments.bwd_launches, moments.perdim_launches,
              moments.perdim_bwd_launches)
    start = 100.0  # later than the warm-up frames' wall clock is early
    engine._last_inference_t = engine._last_cl_t = start
    summary = run_stream(
        engine, SyntheticSource(n_frames=CL_FRAMES, anomaly_frames=range(40, 44), seed=0),
        on_result=lambda r: rows.append((r, dict(engine.timings))),
        clock=lambda n: start + (n + 1) / CL_FPS, log=lambda m: None)
    torch.cuda.synchronize()
    launches = scorer_counts(stream_score, CL_FRAMES)
    peak = torch.cuda.max_memory_allocated()
    assert summary["frames"] == CL_FRAMES and len(rows) == CL_FRAMES, summary
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


def phase_m(dev):
    """Kernel 10's two arrangements vs the plain version on the card, bit for bit; IMMA in
    the tensor-core library's SASS; both timed at the probe's and the path's shapes. Returns
    {"cuda_core": record, "mma": record}: each at the probe's shape with the path's beside it."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm as ig
    from trustedai_cl_vae_ad_tpu_torch.ops.quant import _I32_SAFE_K

    imma = sass_instructions("int8_gemm_mma", "IMMA")
    assert imma, "no IMMA instruction in the SASS of int8_gemm_mma"
    ptxas = ptxas_report("int8_gemm_mma")
    log(f"  SASS of int8_gemm_mma: {len(imma)} IMMA instructions, e.g. {imma[0]}")
    for line in ptxas:
        log(f"  ptxas int8_gemm_mma: {line}")

    def rnd(shape, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(-127, 128, shape, device=dev, generator=gen,
                             dtype=torch.int32).to(torch.int8)

    def counted(arrangement, fn, n_launches=1):  # fn's launches, all under `arrangement`
        want = dict(ig.int8_gemm_arrangements)
        want[arrangement] += n_launches
        out = fn()
        torch.cuda.synchronize()
        assert ig.int8_gemm_arrangements == want, (ig.int8_gemm_arrangements, want)
        return out

    def check(x, w, k0=0, k1=None, label="", arrangement="mma"):
        assert ig.int8_gemm_arrangement(x, w, k0, k1) == arrangement, label
        got = counted(arrangement, lambda: ig.int8_gemm(x, w, k0, k1))
        ref = ig.int8_gemm_reference(x, w, k0, k1)
        assert got.dtype == torch.int32 and got.shape == ref.shape
        assert torch.equal(got, ref), (label, int((got.long() - ref.long()).abs().max()))
        return got

    def times(x, w, chunk):
        """Both arrangements' CUDA-event medians and back-to-back times on the same operands."""
        k = x.shape[1]
        out = {}
        for arrangement in ("mma", "cuda_core"):
            fn = lambda: ig._launch(arrangement, x, w, 0, k, chunk)  # noqa: E731
            out[arrangement] = (median_ms(fn), queued_ms(fn))
        return out

    def library(x, w, chunk):
        """torch._int_mm over the chunks, x zero-padded to 32 rows (it takes M > 16 only); each
        chunk's operands copied once beforehand, the weights as a transposed (N, K) view."""
        k = x.shape[1]
        xp = torch.zeros((max(32, x.shape[0]), k), dtype=torch.int8, device=dev)
        xp[:x.shape[0]] = x
        parts = [(xp[:, s:s + chunk].contiguous(), w[:, s:s + chunk].contiguous())
                 for s in range(0, k, chunk)]
        got = torch.stack([torch._int_mm(a, b.t()) for a, b in parts])[:, :x.shape[0]]
        fn = lambda: [torch._int_mm(a, b.t()) for a, b in parts]  # noqa: E731
        return got, median_ms(fn), queued_ms(fn)

    records = {"cuda_core": {"path": []}, "mma": {"path": [], "sass_imma": len(imma),
                                                   "ptxas": ptxas}}
    for m, k, n in PATH_SHAPES:
        x, w = rnd((m, k), m), rnd((n, k), n)
        arrangement = ig.int8_gemm_arrangement(x, w, 0, k, _I32_SAFE_K)
        chunks = -(-k // _I32_SAFE_K)
        got = counted(arrangement, lambda: ig.int8_gemm_chunked(x, w, _I32_SAFE_K),
                      1 if arrangement == "mma" else chunks)
        assert torch.equal(got, ig.int8_gemm_chunked_reference(x, w, _I32_SAFE_K)), (m, k, n)
        for other in ("mma", "cuda_core"):  # the other arrangement gives the same bits
            assert torch.equal(ig._launch(other, x, w, 0, k, _I32_SAFE_K), got), (m, k, n, other)
        assert torch.equal(ig.int8_gemm_chunked(x, w, _I32_SAFE_K), got), "two runs differ"
        timed = times(x, w, _I32_SAFE_K)
        lib_got, lib_ms, lib_device_ms = library(x, w, _I32_SAFE_K)
        assert torch.equal(lib_got, got), "torch._int_mm disagrees"
        bound_ms, bound_by = int8_bound(m, k, n)
        for name, record in records.items():
            record["path"].append({
                "shape": [m, k, n], "chunks": chunks, "rule": arrangement,
                "launches_per_call": 1 if name == "mma" else chunks,
                "ms": timed[name][0], "device_ms": timed[name][1], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms, "library_device_ms": lib_device_ms})
        log(f"  ({m}, {k}, {n}) in {chunks} chunks, the rule's {arrangement}: equal bit for "
            f"bit, both arrangements and torch._int_mm; mma (1 launch) "
            f"{timed['mma'][0]:.4f} ms ({timed['mma'][1]:.4f} b2b), cuda_core ({chunks} "
            f"launches) {timed['cuda_core'][0]:.4f} ms ({timed['cuda_core'][1]:.4f} b2b), "
            f"torch._int_mm on x padded to 32 rows {lib_ms:.4f} ms ({lib_device_ms:.4f} b2b), "
            f"bound {bound_ms:.5f} ms ({bound_by})")
        del x, w

    x, w = rnd((3, 1003), 1), rnd((37, 1003), 2)
    check(x, w, label="ragged", arrangement="cuda_core")
    check(x, w, 5, 900, "ragged range", arrangement="cuda_core")
    check(rnd((5, 4096), 3), rnd((50, 4096), 4), 16, 4000, "a range inside a larger matrix")
    check(rnd((40, 512), 5), rnd((33, 512), 6), label="M above one tile of 32")
    for m, k, n in ((3, 4096, 1000), (17, 2000, 130), (16, 144, 129)):  # ragged M, N edges
        check(rnd((m, k), m), rnd((n, k), n), label=f"({m}, {k}, {n})")
    sat = torch.full((2, _I32_SAFE_K), 127, dtype=torch.int8, device=dev)
    got = check(sat, torch.full((17, _I32_SAFE_K), 127, dtype=torch.int8, device=dev),
                label="saturated")
    assert int(got[0, 0]) == 127 * 127 * _I32_SAFE_K < 2 ** 31
    got = check(sat, -sat, label="saturated, negative")
    assert int(got[1, 1]) == -127 * 127 * _I32_SAFE_K
    long = torch.full((1, ig.I32_EXACT_K + 8), 127, dtype=torch.int8, device=dev)
    assert int(check(long, long, label="wrapping")[0, 0]) == \
        127 * 127 * (ig.I32_EXACT_K + 8) - 2 ** 32
    # a contiguous view that starts one byte into an allocation: the CUDA-core kernel's bytes
    view = rnd((16 * 2000 + 1,), 7)[1:].view(16, 2000)
    assert view.data_ptr() % 16 != 0
    check(view, rnd((100, 2000), 8), label="misaligned view", arrangement="cuda_core")
    expect_raises(lambda: ig._launch("mma", view, rnd((100, 2000), 8), 0, 2000, 2000),
                  RuntimeError, "an mma launch of a view off a 16-byte boundary")
    log("  ragged (3, 1003, 37) and ranges (CUDA cores), M = 40, ragged M and N edges, saturated "
        "chunks of 131072 (+ and -), wrapping past I32_EXACT_K (tensor cores), a view at +1 "
        "byte (CUDA cores; refused by the tensor-core launcher): equal bit for bit")
    x, w = rnd((4, 64), 9), rnd((6, 64), 10)
    for bad_x, bad_w, error in ((x.int(), w, TypeError), (x, w.float(), TypeError),
                                (x[:, ::2], w[:, ::2], ValueError), (x[0], w, ValueError),
                                (x, w[:, :32].contiguous(), ValueError),
                                (x, w.cpu(), ValueError)):
        expect_raises(lambda: ig.int8_gemm(bad_x, bad_w), error,
                      f"int8_gemm of {bad_x.dtype} {tuple(bad_x.shape)} x "
                      f"{bad_w.dtype} {tuple(bad_w.shape)}")
    expect_raises(lambda: ig.int8_gemm(x, w, 8, 8), ValueError, "an empty range")
    expect_raises(lambda: ig.int8_gemm(x, w, 0, 65), ValueError, "a range past K")
    expect_raises(lambda: ig.int8_gemm_chunked(x, w, 0), ValueError, "a chunk of 0")

    m, k, n = PROBE_SHAPE
    x, w = rnd((m, k), 11), rnd((n, k), 12)
    got = check(x, w, label="probe")  # one launch over all of K: no sum of random data leaves int32
    assert torch.equal(ig._launch("cuda_core", x, w, 0, k, k)[0], got)
    assert torch.equal(ig.int8_gemm(x, w), got), "two runs differ"
    lib = torch._int_mm(x, w.t())
    assert torch.equal(got, lib), "torch._int_mm disagrees"
    bound_ms, bound_by = int8_bound(m, k, n)
    timed = times(x, w, k)
    plain_ms = median_ms(lambda: ig.int8_gemm_reference(x, w), runs=10, warmup=2)
    lib_ms = median_ms(lambda: torch._int_mm(x, w.t()))
    lib_device_ms = queued_ms(lambda: torch._int_mm(x, w.t()))
    for name, record in records.items():
        record.update(shape=list(PROBE_SHAPE), max_abs_err=0.0, ms=timed[name][0],
                      device_ms=timed[name][1], plain_ms=plain_ms, library_ms=lib_ms,
                      library_device_ms=lib_device_ms, bound_ms=bound_ms, bound_by=bound_by)
    log(f"  probe {PROBE_SHAPE}, one launch each, median of 100: mma {timed['mma'][0]:.4f} ms "
        f"({timed['mma'][1]:.4f} b2b), cuda_core {timed['cuda_core'][0]:.4f} ms "
        f"({timed['cuda_core'][1]:.4f} b2b), plain (float64, median of 10) {plain_ms:.3f} ms, "
        f"torch._int_mm {lib_ms:.4f} ms ({lib_device_ms:.4f} b2b), bound {bound_ms:.5f} ms "
        f"({bound_by})")
    return records


def phase_n(dev):
    """The batched scorer (one launch for K = 16 frames with a validity mask) vs the plain
    batched version, stream by stream: through the entry point (counted) and through each
    of SCORER_VARIANTS; returns the records of both arrangements with their times."""
    import numpy as np
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops import stream_score as ss
    from trustedai_cl_vae_ad_tpu_torch.testing import STARTS, compare_sequences, score_sequence

    k, n_ticks = FLEET_STREAMS, 8
    h, w, c = SEQ_SHAPES[0]
    rule = ss.stream_score_arrangement(k, h * w, c)
    assert rule[0] == "cluster", rule
    seqs = [score_sequence(h, w, c, n_ticks, seed=100 + i, start=STARTS[i % 3]) for i in range(k)]
    imgs = np.stack([s[0] for s in seqs], axis=1)  # (ticks, K, H, W, C)
    recs = np.stack([s[1] for s in seqs], axis=1)
    valid = np.ones((n_ticks, k), bool)
    valid[2, 3] = valid[4, 7] = valid[5, 7] = False
    valid[:, 11] = False  # a camera that never delivers
    valid[0, 5] = False   # a fresh state whose first frame is dropped

    def run(fn):
        maps = torch.from_numpy(np.stack([s[2] for s in seqs])).to(dev)
        scalars = torch.from_numpy(np.stack([s[3] for s in seqs])).to(dev)
        outs = []
        for t in range(n_ticks):
            maps, scalars, norm, sc = fn(maps, scalars, torch.from_numpy(imgs[t]).to(dev),
                                         torch.from_numpy(recs[t]).to(dev), ALPHA,
                                         torch.from_numpy(valid[t]).to(dev))
            outs.append((maps.cpu().numpy(), scalars.cpu().numpy(), norm.cpu().numpy(),
                         sc.cpu().numpy()))
        return outs

    def forced(arrangement, clusters):
        def fn(maps, scalars, img, rec, alpha, ok):
            return ss._launch(arrangement, clusters, (img.shape[0],), img, rec, maps, scalars,
                              alpha, ok)
        return fn

    def check(got, label):
        max_err = 0.0
        for i in range(k):
            def stream(outs):
                return [(o[0][i], o[1][i], o[2][i], float(o[3][i, 0]), float(o[3][i, 1]))
                        for o in outs]
            max_err = max(max_err, compare_sequences(stream(got), stream(ref),
                                                     f"{label} stream {i}"))
            for t in range(n_ticks):
                if not valid[t, i]:
                    assert np.isnan(got[t][3][i, 0]) and got[t][3][i, 1] == 0.0, (t, i)
                    prev = got[t - 1] if t else (np.stack([s[2] for s in seqs]),
                                                 np.stack([s[3] for s in seqs]))
                    assert np.array_equal(got[t][0][i], prev[0][i]), "a dropped tick moved maps"
                    assert np.array_equal(got[t][1][i], prev[1][i]), "a dropped tick moved scalars"
        return max_err

    ref = run(ss.stream_score_step_batched_reference)
    before = (ss.launches, ss.stream_score_arrangements["cluster"])
    entry_err = check(run(ss.stream_score_step_batched), "entry point")
    assert (ss.launches, ss.stream_score_arrangements["cluster"]) == (
        before[0] + n_ticks, before[1] + n_ticks), "one cluster launch per tick"
    errors = {}
    for arrangement, clusters in SCORER_VARIANTS:
        name = f"{arrangement}{clusters if arrangement == 'cluster' else ''}"
        errors[name] = check(run(forced(arrangement, clusters)), name)
    maps = torch.from_numpy(ref[3][0]).to(dev)
    scalars = torch.from_numpy(ref[3][1]).to(dev)
    img, rec = torch.from_numpy(imgs[4]).to(dev), torch.from_numpy(recs[4]).to(dev)
    ok = torch.from_numpy(valid[4]).to(dev)
    rows, common = scorer_times(
        lambda arrangement, clusters: forced(arrangement, clusters)(maps, scalars, img, rec,
                                                                   ALPHA, ok),
        lambda: ss.stream_score_step_batched_reference(maps, scalars, img, rec, ALPHA, ok),
        k, h, w, c)
    entry_ms = median_ms(lambda: ss.stream_score_step_batched(maps, scalars, img, rec, ALPHA, ok))
    expect_raises(lambda: ss.stream_score_step_batched(maps, scalars, img, rec, ALPHA, ok[:4]),
                  ValueError, "a validity mask of another length")
    expect_raises(lambda: ss.stream_score_step_batched(maps, scalars, img, rec, ALPHA,
                                                       ok.float()), ValueError,
                  "a float validity mask")
    log(f"  K = {k} at {h}x{w}x{c}, {n_ticks} ticks, {int((~valid).sum())} dropped frames, rule "
        f"{rule}: max_abs_err per stream, entry point {entry_err:.3g}, "
        + ", ".join(f"{name} {err:.3g}" for name, err in errors.items()) + "; one launch a tick")
    log(f"  {occupancy_line(ss, h * w)}")
    log_scorer_times(f"K = {k}", rows, common)
    log(f"  K = {k} through stream_score_step_batched: median of 100 {entry_ms:.4f} ms")
    return dict(scorer_records(rule, errors, rows, common), streams=k, entry_ms=entry_ms,
                rule=rule)


class DroppingReader:
    """A camera that delivers no frame on every ``every``-th tick."""

    def __init__(self, source, every):
        self.source, self.every, self.ticks = source, every, 0

    def read(self):
        frame = self.source.read()
        self.ticks += 1
        return None if self.ticks % self.every == 0 else frame

    def release(self):
        self.source.release()


def fleet_readers(n_streams, n_ticks, width=320, height=240, motion=1.0):
    """Synthetic cameras, the last one dropping every DROP_EVERY-th tick."""
    from trustedai_cl_vae_ad_tpu_torch.stream.capture import SyntheticSource
    from trustedai_cl_vae_ad_tpu_torch.stream.run import PacedReader

    sources = [SyntheticSource(width=width, height=height, n_frames=n_ticks, seed=i,
                               motion=motion, anomaly_frames=range(n_ticks - 6, n_ticks - 3))
               for i in range(n_streams)]
    readers = [PacedReader(s, 20.0, 20.0) for s in sources[:-1]]
    return readers + [DroppingReader(sources[-1], DROP_EVERY)]


def run_fleet(engine, n_ticks, **reader_kwargs):
    """run_all_cameras over fleet_readers; returns (summary, per-tick results)."""
    from trustedai_cl_vae_ad_tpu_torch.stream.run import run_all_cameras

    ticks = []
    names = [f"synthetic{i}" for i in range(engine.n_streams)]
    summary = run_all_cameras(engine, fleet_readers(engine.n_streams, n_ticks, **reader_kwargs),
                              names, on_tick=lambda tick, results: ticks.append(results),
                              log=lambda m: None)
    assert summary["ticks"] == n_ticks == len(ticks), summary["ticks"]
    for t, results in enumerate(ticks):
        dropped = (t + 1) % DROP_EVERY == 0
        assert (results[-1] is None) == dropped, t
        assert all(r is not None for r in results[:-1]), t
    return summary, ticks


def phase_o():
    """Tiny config: the multi-camera engine on cuda vs cpu, float and w8a8;
    the modes' fidelity; the int8 sidecar written, healed and reloaded."""
    import numpy as np
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm, quant
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config
    from trustedai_cl_vae_ad_tpu_torch.stream.multicam import MultiCameraEngine
    from trustedai_cl_vae_ad_tpu_torch.testing import warm_score_state

    config = TINY_CONFIG
    settings = {"anomaly_score_threshold": 2.0, "anomaly_score_method": "zz_count",
                "buffer_record_period_s": 1.0, "anomalous_state_period_s": 0.05}
    cpu_model = load_model_from_config(config, seed=0, device="cpu")
    gpu_model = load_model_from_config(config, seed=0, device="cuda")
    gpu_model.core.load_state_dict(cpu_model.core.state_dict())
    k, n_ticks = 3, 16
    default_min = quant.DEFAULT_MIN_ELEMS
    quant.DEFAULT_MIN_ELEMS = 0  # the tiny model's Dense kernels are far below 2^25
    try:
        for quantize in (False, True):
            runs = {}
            for name, model in (("cpu", cpu_model), ("cuda", gpu_model)):
                engine = MultiCameraEngine(model, config, n_streams=k, anomaly_settings=settings,
                                           quantize=quantize)
                assert engine.quantized == quantize
                # both devices start from one warm scorer state (testing.py says why)
                maps, scalars = warm_score_state(engine.height, engine.width)
                engine.maps = torch.from_numpy(np.stack([maps] * k)).to(engine.device)
                engine.scalars = torch.from_numpy(np.stack([scalars] * k)).to(engine.device)
                if name == "cuda" and quantize:  # the int8 launches of this run, from zero
                    torch.cuda.synchronize()
                    int8_gemm.launches = 0
                    for arrangement in int8_gemm.int8_gemm_arrangements:
                        int8_gemm.int8_gemm_arrangements[arrangement] = 0
                runs[name] = run_fleet(engine, n_ticks, width=64, height=40, motion=0.0)[1]
                if name == "cuda" and quantize:
                    int8_counts = dict(int8_gemm.int8_gemm_arrangements)
                    # the encoder's two Dense layers (K = 768, 16) on the tensor cores, the
                    # decoder's (K = 8, off the rule's multiples of 16) on the CUDA cores
                    assert int8_counts["mma"] == 2 * int8_counts["cuda_core"] > 0, int8_counts
                    assert int8_gemm.launches == sum(int8_counts.values())
            agreed = True
            # w8a8: a convolution that differs by 1e-7 between the devices can
            # move one activation across a rounding boundary of its quantization
            rec_tol = 2 if quantize else 1
            for ta, tb in zip(runs["cpu"], runs["cuda"]):
                for ra, rb in zip(ta, tb):
                    if ra is None:
                        assert rb is None
                        continue
                    assert abs(ra.pixel_count - rb.pixel_count) <= 2
                    agreed = agreed and ra.pixel_count == rb.pixel_count
                    if agreed:
                        assert abs(ra.score - rb.score) <= 1e-3, (ra.score, rb.score)
                        assert ra.anomalous == rb.anomalous
                    assert int(np.abs(ra.norm_err_u8.astype(int)
                                      - rb.norm_err_u8.astype(int)).max()) <= rec_tol
                    assert int(np.abs(ra.reconstruction_u8.astype(int)
                                      - rb.reconstruction_u8.astype(int)).max()) <= rec_tol
            assert agreed, "pixel counts differ between cuda and cpu"
            flagged = [t for t, tick in enumerate(runs["cuda"]) if any(r.anomalous for r in tick
                                                                       if r is not None)]
            assert flagged, "the injected blob was not flagged on cuda"
            log(f"  K = {k}, {n_ticks} ticks, {'w8a8' if quantize else 'float'}: cuda == cpu; "
                f"ticks with an alarm {flagged}"
                + (f"; int8 launches by arrangement {int8_counts}" if quantize else ""))
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.rand((4, *config["data"]["image_size"]), device="cuda", generator=gen)
        qp = quant.quantize_params(gpu_model.core, gpu_model.params)
        with torch.inference_mode():
            ref = gpu_model.core.call(x)
            for mode in ("w8", "w8a8"):
                got = quant.call_quantized(gpu_model.core, qp, x, mode=mode)
                mse, worst = float(((got - ref) ** 2).mean()), float((got - ref).abs().max())
                assert mse < 1e-4 and worst < 0.05, (mode, mse, worst)
                log(f"  {mode} vs float on cuda: mse {mse:.3g}, max abs {worst:.3g}")
        logdir = tempfile.mkdtemp(prefix="chip_smoke_quant_")
        try:
            path = quant.save_quantized_checkpoint(logdir, qp)
            # a kill between the two renames of a second save: the old copy
            # moved aside, the staged one complete but not yet in place
            os.rename(path, path + ".old")
            shutil.copytree(path + ".old", path + ".staging")
            assert quant.has_quantized_checkpoint(logdir) and os.path.isdir(path)
            back = quant.load_quantized_checkpoint(logdir, "cuda")
            for part in qp:
                for layer, entry in qp[part].items():
                    for leaf, t in entry.items():
                        r = back[part][layer][leaf]
                        assert r.device.type == "cuda" and torch.equal(r, t), (part, layer, leaf)
            quant.save_quantized_checkpoint(logdir, qp)
            assert sorted(os.listdir(logdir)) == ["quantized"], os.listdir(logdir)
        finally:
            shutil.rmtree(logdir, ignore_errors=True)
        log("  int8 sidecar written, healed after a simulated kill, reloaded equal")
    finally:
        quant.DEFAULT_MIN_ELEMS = default_min
    return {"int8_arrangements": int8_counts}


def assert_scores_finite(results, label):
    """A stream's scores are finite once its count EMAs have a variance, that
    is from the frame after its first non-zero count on (before that the
    score is 0/0, as in the JAX package)."""
    import numpy as np

    seen = False
    for r in results:
        if r is None:
            continue
        assert np.isfinite(r.pixel_count), label
        if seen:
            assert np.isfinite(r.score), (label, [x and x.score for x in results])
        seen = seen or r.pixel_count > 0
    assert seen, f"{label}: no frame counted a pixel"


def phase_p():
    """The flagship's int8 serving and multi-camera tick on the card; returns
    the launch counts of the w8a8 fleet run and the measured latencies."""
    import numpy as np
    import torch

    from trustedai_cl_vae_ad_tpu_torch.config import save_config
    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm, quant, stream_score
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config_path
    from trustedai_cl_vae_ad_tpu_torch.stream.capture import SyntheticSource
    from trustedai_cl_vae_ad_tpu_torch.stream.multicam import MultiCameraEngine
    from trustedai_cl_vae_ad_tpu_torch.stream.run import (
        build_engine,
        load_serving_model,
        resolve_camera,
        run_stream,
    )

    gib = 2.0 ** 30
    torch.cuda.empty_cache()
    model, config = load_model_from_config_path(os.path.join(REPO, "configs", "config.yml"),
                                                seed=0, device="cuda")
    settings = resolve_camera(os.path.join(REPO, "configs", "cam_config.yml"))[0]
    out = {}

    def reset_counts():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        int8_gemm.launches = 0
        reset_scorer_counts(stream_score)
        for arrangement in int8_gemm.int8_gemm_arrangements:
            int8_gemm.int8_gemm_arrangements[arrangement] = 0

    def int8_per_forward(m):
        """Launches of each int8 arrangement in one w8a8 forward of m frames: the encoder Dense
        (K = 268800, 3 chunks) and the decoder Dense (K = 2000, 1 chunk), as the rule sends
        them: one launch a Dense on the tensor cores, one a chunk on the CUDA cores."""
        per = {"mma": 0, "cuda_core": 0}
        for k, n in ((268800, 4000), (2000, 134400)):
            x = torch.empty((m, k), dtype=torch.int8, device="meta")
            w = torch.empty((n, k), dtype=torch.int8, device="meta")
            arrangement = int8_gemm.int8_gemm_arrangement(x, w, 0, k, quant._I32_SAFE_K)
            per[arrangement] += 1 if arrangement == "mma" else -(-k // quant._I32_SAFE_K)
        return per

    def int8_counts(per, times):
        return {a: per[a] * times for a in per}

    def single(quantize, qparams=None, serving_model=None):
        engine = build_engine(serving_model or model, config, anomaly_settings=settings,
                              quantize=quantize, qparams=qparams)
        engine.warmup(frame_shape=(240, 320, 3))
        reset_counts()
        results = []
        summary = run_stream(engine, SyntheticSource(n_frames=64, anomaly_frames=range(40, 44),
                                                     seed=0),
                             on_result=results.append, log=lambda m: None)
        counts = (int8_gemm.launches, stream_score.launches)
        want = int8_counts(int8_per_forward(1), 64 * bool(quantize or qparams))
        assert len(results) == 64 and counts == (sum(want.values()), 64), counts
        out.setdefault("frame_scorer", []).append(scorer_counts(stream_score, 64))
        assert int8_gemm.int8_gemm_arrangements == want, (int8_gemm.int8_gemm_arrangements, want)
        assert_scores_finite(results, "single stream")
        return summary, torch.cuda.max_memory_allocated(), results

    def fleet(quantize, qparams=None, serving_model=None, n_ticks=FLEET_TICKS):
        engine = MultiCameraEngine(serving_model or model, config, n_streams=FLEET_STREAMS,
                                   anomaly_settings=settings, quantize=quantize, qparams=qparams)
        engine.warmup(frame_shape=(240, 320, 3))
        reset_counts()
        summary, ticks = run_fleet(engine, n_ticks)
        counts = (int8_gemm.launches, stream_score.launches)
        out.setdefault("tick_scorer", []).append(scorer_counts(stream_score, n_ticks))
        # the encoder Dense contracts over 268800 = 3 safe chunks, the decoder's over 2000 = 1;
        # on the tensor cores each Dense is one launch
        want = int8_counts(int8_per_forward(FLEET_STREAMS), n_ticks * engine.quantized)
        assert counts == (sum(want.values()), n_ticks), counts
        assert int8_gemm.int8_gemm_arrangements == want, (int8_gemm.int8_gemm_arrangements, want)
        counts = counts + (dict(int8_gemm.int8_gemm_arrangements),)
        for i in range(FLEET_STREAMS):
            assert_scores_finite([tick[i] for tick in ticks], f"stream {i}")
        assert torch.isfinite(engine.maps).all()
        return summary, torch.cuda.max_memory_allocated(), ticks, counts, engine

    s1, peak1, _ = single(False)
    out["frame_float"] = s1
    sf, peakf, _, _, engine = fleet(False)
    out["tick_float"] = sf
    gen = torch.Generator(device="cuda").manual_seed(1)
    fixed = torch.rand((FLEET_STREAMS, engine.height, engine.width, engine.channels),
                       device="cuda", generator=gen)
    with torch.inference_mode():
        rec_float = engine._forward(engine._serve_params, fixed).clone()
    del engine

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qparams = quant.quantize_params(model.core, model.params)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    quant_peak = torch.cuda.max_memory_allocated() - base
    q_bytes = sum(t.numel() for part in qparams.values() for p in part.values()
                  for name, t in p.items() if name == "kernel_i8")
    # the two large Dense layers, and the small encoder head stays float
    assert quant._is_qdense(qparams["decoder"]["Dense_0"]), "the decoder Dense stayed float"
    assert sum(quant._is_qdense(p) for p in qparams["encoder"].values()) == 1
    log(f"  quantize_params over the flagship: {quant_s * 1e3:.1f} ms, peak "
        f"{quant_peak / gib:.3f} GiB above the resident {base / gib:.2f} GiB; int8 kernels "
        f"{q_bytes / 1e9:.3f} GB, serving tree {quant.tree_nbytes(qparams) / 1e9:.3f} GB")

    sq, peakq, ticks_q, counts, engine = fleet(True)
    out["tick_w8a8"], out["launches"] = sq, counts
    with torch.inference_mode():
        rec_q = engine._forward(engine._serve_params, fixed)
        mse = float(((rec_q - rec_float) ** 2).mean())
        worst = float((rec_q - rec_float).abs().max())
    assert mse < 1e-4 and worst < 0.05, (mse, worst)
    del engine
    s1q, peak1q, frames_q = single(True)
    out["frame_w8a8"] = s1q
    out["frame_int8_arrangements"] = dict(int8_gemm.int8_gemm_arrangements)
    log(f"  K = {FLEET_STREAMS} cameras, {FLEET_TICKS} ticks (240x320 -> 224x300), camera "
        f"{FLEET_STREAMS - 1} dropping every {DROP_EVERY}th tick: tick latency float p50 "
        f"{sf['p50_ms']:.3f} ms p95 {sf['p95_ms']:.3f} ms, w8a8 p50 {sq['p50_ms']:.3f} ms p95 "
        f"{sq['p95_ms']:.3f} ms; max_memory_allocated float {peakf / gib:.2f} GiB, w8a8 beside "
        f"the float model {peakq / gib:.2f} GiB; launches in the w8a8 run: int8_gemm "
        f"{counts[0]} ({counts[2]}), stream_score {counts[1]}")
    log(f"  K = 1, 64 frames: frame latency float p50 {s1['p50_ms']:.3f} ms p95 "
        f"{s1['p95_ms']:.3f} ms, w8a8 p50 {s1q['p50_ms']:.3f} ms p95 {s1q['p95_ms']:.3f} ms; "
        f"max_memory_allocated float {peak1 / gib:.2f} GiB, w8a8 beside the float model "
        f"{peak1q / gib:.2f} GiB")
    log(f"  reconstruction of a fixed batch of {FLEET_STREAMS}, w8a8 vs float: mse {mse:.3g}, "
        f"max abs {worst:.3g}")

    # the int8-checkpoint boot: a log directory with config.yml and the sidecar
    logdir = tempfile.mkdtemp(prefix="chip_smoke_int8_")
    try:
        save_config(config, os.path.join(logdir, "config.yml"))
        t0 = time.perf_counter()
        quant.save_quantized_checkpoint(logdir, qparams)
        save_s = time.perf_counter() - t0
        first_counts = [[None if r is None else r.pixel_count for r in tick]
                        for tick in ticks_q[:16]]
        rec_q = rec_q.cpu()
        del model, qparams, rec_float, ticks_q, frames_q
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() < 0.1 * gib, torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        booted, _config, boot_q = load_serving_model(logdir, None, "cuda", quantize=True,
                                                     log=lambda m: None)
        torch.cuda.synchronize()
        boot_s = time.perf_counter() - t0
        resident = torch.cuda.memory_allocated()
        assert booted.params is None and boot_q is booted.qparams
        # 1.344 GB of int8 kernels, the float32 scales, biases and convolutions: no float Dense
        # (and cuBLAS's workspace and the fixed batch): far from the 5 GiB of a float boot
        assert resident < 1.5 * gib, resident
        sb, peakb, ticks_b, _, engine = fleet(False, qparams=boot_q, serving_model=booted,
                                              n_ticks=16)
        assert engine.quantized
        again = [[None if r is None else r.pixel_count for r in tick] for tick in ticks_b]
        # the same int8 weights and frames, but cuDNN may pick another
        # algorithm now that less memory is taken, which can flip the rounding
        # of an activation (as between cuda and cpu); and a fresh scorer's
        # early counts, some hundreds, are rounding noise (ROADMAP queue 3)
        with torch.inference_mode():
            rec_boot = engine._forward(engine._serve_params, fixed).cpu()
        boot_diff = float((rec_boot - rec_q).abs().max())
        assert boot_diff <= 2e-4, boot_diff
        for a_tick, b_tick in zip(again, first_counts):
            assert all((a is None) == (b is None)
                       and (a is None or abs(a - b) <= 2 + 0.05 * max(a, b))
                       for a, b in zip(a_tick, b_tick)), (a_tick, b_tick)
        s1b, peak1b, _ = single(False, qparams=boot_q, serving_model=booted)
        expect_raises(lambda: build_engine(booted, config, qparams=boot_q).set_learning_rate(1e-4),
                      RuntimeError, "a CL control on an int8 boot")
        out["tick_int8_boot"], out["frame_int8_boot"] = sb, s1b
        log(f"  int8 sidecar saved in {save_s:.1f} s and booted in {boot_s:.1f} s: "
            f"{resident / gib:.3f} GiB resident (no float Dense on the device); the fixed batch "
            f"reconstructs within {boot_diff:.3g} of the tree it was saved from, 16 ticks count "
            f"as the first 16 above, tick p50 {sb['p50_ms']:.3f} ms, peak {peakb / gib:.2f} GiB; "
            f"K = 1 frame p50 {s1b['p50_ms']:.3f} ms, peak {peak1b / gib:.2f} GiB")
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def library_adam(g, w, mu, nu, step, lr=1e-4, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step on w, mu, nu in place in a single pass by the library's own
    kernel (the one behind ``torch.optim.Adam(fused=True)``): float32 arithmetic
    on bfloat16 state, the same bias corrections, eps outside the root, another
    order of roundings. ``step``: the post-step count, a float32 0-dim tensor on
    the card. A yardstick that this script times; the port never calls it."""
    import torch

    torch._fused_adam_([w], [g], [mu], [nu], [], [step], lr=lr, beta1=b1, beta2=b2,
                       weight_decay=0.0, eps=eps, amsgrad=False, maximize=False)


DGA_BLOCK_ELEMENTS = 12800 * 4000  # a row block of the whole-state comparisons


def phase_q(dev):
    """The six dense-update kernels vs their plain versions on the card;
    returns, per launch counter, the kernel's record at (768, 12800, 4000)."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops import dense_grad_adam as dga
    from trustedai_cl_vae_ad_tpu_torch.probes import r11
    from trustedai_cl_vae_ad_tpu_torch.testing import shifted, steps_apart

    adam, names = r11.ADAM, ("w", "mu", "nu")

    def case(shape, dtype, offset=0):
        K, M, N = shape
        gen = torch.Generator(device=dev).manual_seed(K + M + N)
        ops = r11.make_operands(K, M, N, dev, gen, dtype=dtype)
        ops["g"] = r11.make_gradient(M, N, dev, gen, dtype)
        ops["xt"] = ops["x"].t().contiguous()
        if offset:
            ops = {k: shifted(v, offset) for k, v in ops.items()}
            assert all(v.data_ptr() % 16 for v in ops.values())
        return ops

    def check(shape, dtype, offset=0):
        """Every kernel at one shape; returns the largest absolute errors."""
        K, M, N = shape
        ops = case(shape, dtype, offset)
        x, xt, dz, g = ops["x"], ops["xt"], ops["dz"], ops["g"]
        errs = {}

        def state():
            return [shifted(ops[k], offset) for k in names]

        def record(key, got, ref):
            errs[key] = max(errs.get(key, 0.0), *(
                float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref)))

        # the copy: into new tensors, into given ones, and onto itself
        sources = [ops[k] for k in names]
        for out in (None, state()):
            copies = dga.stream_copy(*state(), out=out)
            record("stream_copy", copies, sources)
            assert all(torch.equal(c, t) for c, t in zip(copies, sources)), "copy differs"
        own = state()
        assert all(a is b for a, b in zip(dga.stream_copy(*own, out=own), own))
        record("stream_copy", own, sources)
        assert all(torch.equal(c, t) for c, t in zip(own, sources)), "copy onto itself"

        # the epilogues on a given gradient: the plain version's operations in its order,
        # each rounded once (--fmad=false, IEEE division and root): equal bit for bit
        for arithmetic in ("float32", "bfloat16")[:1 + (dtype == torch.bfloat16)]:
            reference = (dga.adam_epilogue_bf16_reference if arithmetic == "bfloat16"
                         else dga.adam_epilogue_reference)
            for count in (1, 5):
                got, ref = state(), state()
                dga.adam_epilogue_step(g, *got, count=count, arithmetic=arithmetic, **adam)
                reference(g, *ref, count=count, **adam)
                torch.cuda.synchronize()
                record("epilogue_bf16" if arithmetic == "bfloat16" else "epilogue_f32", got, ref)
                for name, a, b in zip(names, got, ref):
                    assert torch.equal(a, b), (shape, dtype, arithmetic, count, name,
                                               steps_apart(a, b))
                assert not torch.equal(got[0], ops["w"]), "w did not move"
                again = state()
                dga.adam_epilogue_step(g, *again, count=count, arithmetic=arithmetic, **adam)
                assert all(torch.equal(a, b) for a, b in zip(got, again)), "two runs differ"

        # the product alone against a float64 product rounded once: the order of the sums;
        # bfloat16 at multiples of 8 on 16-byte boundaries runs on the tensor cores
        g64 = x.double().t() @ dz.double()
        bf16 = dtype == torch.bfloat16
        arrangement = "wgmma" if bf16 and not offset and M % 8 == 0 and N % 8 == 0 \
            else "cuda_core"
        taken = dict(dga.dense_grad_arrangements)
        got = dga.dense_grad(x, dz)
        plain = dga.dense_grad_reference(x, dz)
        torch.cuda.synchronize()
        assert torch.equal(got, dga.dense_grad(x, dz, out=torch.empty_like(got))), "two runs"
        taken[arrangement] += 2
        assert dga.dense_grad_arrangements == taken, (shape, dtype, offset, taken)
        # bfloat16: one step, on few elements (the float32 sum is far finer than its
        # rounding). float32: each of the K additions rounds once, so up to K steps, anywhere.
        max_steps, max_share = (1.0, 0.01) if bf16 else (float(K), 1.0)
        # where the K products cancel, the float32 sum carries up to K roundings at the
        # size of its partial sums, which a small result's own step does not cover
        share, worst = steps_apart(got, g64.float().to(dtype),
                                   floor=K * 2.0 ** -24 * float(g64.abs().max()))
        assert worst <= max_steps and share <= max_share, (shape, dtype, "dense_grad", share,
                                                           worst)
        errs["dense_grad"] = float((got.double() - plain.double()).abs().max())
        product_share, shares = share, [0.0]
        del g64

        # the fused kernels against the plain version: the K sums are taken in another
        # order, which now and then flips the rounding of g and moves w, mu, nu by a step
        for count in (1, 5):
            ref = state()
            dga.fused_dense_grad_adam_reference(x, dz, *ref, count=count, **adam)
            # where its terms cancel, a sum is held to a step at the size of the terms
            w_old = ops["w"].float()
            terms = [torch.maximum(w_old.abs(), (w_old - ref[0].float()).abs()),
                     torch.maximum(ops["mu"].float().abs(), plain.float().abs()), None]
            for tile in dga.TILES:
                for transposed in (False, True):
                    got = state()
                    dga.fused_dense_grad_adam(xt if transposed else x, dz, *got, count=count,
                                              x_transposed=transposed, tile=tile, **adam)
                    torch.cuda.synchronize()
                    key = "fused_xt" if transposed else "fused"
                    for i, name in enumerate(names):
                        share, worst = steps_apart(got[i], ref[i], terms[i])
                        scale = float((got[i].float() - ref[i].float()).abs().max()
                                      / ref[i].float().abs().max())
                        assert worst <= max_steps and share <= max_share and scale < 1 / 64, \
                            (shape, dtype, tile, transposed, count, name, share, worst, scale)
                        shares.append(share)
                        if i == 0:
                            errs[key] = max(errs.get(key, 0.0), float(
                                (got[i].float() - ref[i].float()).abs().max()))
                    assert not torch.equal(got[0], ops["w"]), "w did not move"
            again = state()
            dga.fused_dense_grad_adam(xt, dz, *again, count=count, x_transposed=True,
                                      tile=dga.TILES[-1], **adam)
            assert all(torch.equal(a, b) for a, b in zip(got, again)), "two runs differ"
        log(f"  {shape} {str(dtype)[6:]}{' at +1 element' if offset else ''}: copy and "
            f"epilogues equal bit for bit; within {max_steps:g} step(s): the product "
            f"({arrangement}) of a "
            f"float64 product rounded once, on {product_share:.2e} of the elements, the fused "
            f"kernels of the plain version, on at most {max(shares):.2e}")
        return errs

    before = dict(dga.launches)
    for shape in DGA_SMALL_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            check(shape, dtype)
    check(DGA_SMALL_SHAPES[1], torch.bfloat16, offset=1)
    check(DGA_SMALL_SHAPES[2], torch.float32, offset=1)
    for shape in DGA_LARGE_SHAPES[1:]:
        check(shape, torch.bfloat16)
    errs = check(DGA_DIAG_SHAPE, torch.bfloat16)
    assert all(dga.launches[k] > before[k] for k in before), dga.launches

    ops = case((4, 8, 6), torch.bfloat16)
    x, dz, w, mu, nu, g = (ops[k] for k in ("x", "dz", "w", "mu", "nu", "g"))
    for what, call, error in (
            ("float64 operands", lambda: dga.dense_grad(x.double(), dz.double()), TypeError),
            ("a float32 moment", lambda: dga.fused_dense_grad_adam(
                x, dz, w, mu.float(), nu, count=1, **adam), TypeError),
            ("a non-contiguous x", lambda: dga.fused_dense_grad_adam(
                ops["xt"].t(), dz, w, mu, nu, count=1, **adam), ValueError),
            ("w and mu overlapping", lambda: dga.adam_epilogue_step(
                g, w, w, nu, count=1, **adam), ValueError),
            ("dz on the cpu", lambda: dga.fused_dense_grad_adam(
                x, dz.cpu(), w, mu, nu, count=1, **adam), ValueError),
            ("w of another shape", lambda: dga.fused_dense_grad_adam(
                x, dz, w.t().contiguous(), mu, nu, count=1, **adam), ValueError),
            ("bfloat16 arithmetic on float32", lambda: dga.adam_epilogue_step(
                g.float(), w.float(), mu.float(), nu.float(), count=1, arithmetic="bfloat16",
                **adam), TypeError),
            ("a copy onto another source", lambda: dga.stream_copy(w, mu, nu, out=(mu, w, nu)),
             ValueError)):
        expect_raises(call, error, what)

    # times at the archived harness's shape, beside bounds, plain versions and library calls
    K, M, N = DGA_DIAG_SHAPE
    ops = case(DGA_DIAG_SHAPE, torch.bfloat16)
    x, xt, dz, w, mu, nu, g = (ops[k] for k in ("x", "xt", "dz", "w", "mu", "nu", "g"))
    gbuf, outs, kw = torch.empty_like(w), tuple(torch.empty_like(t) for t in (w, mu, nu)), \
        dict(count=5, **adam)
    size, mn = w.element_size(), M * N

    def library_step(lhs):
        dga.adam_epilogue_reference(torch.matmul(lhs, dz), w, mu, nu, **kw)

    step = torch.tensor(float(kw["count"]), device=dev)
    # how far the library's one-pass Adam lands from kernel 9 after one step from one state
    # (another order of the same float32 operations: logged, not asserted)
    ours, theirs = ([ops[k].clone() for k in names] for _ in range(2))
    dga.adam_epilogue_step(g, *ours, **kw)
    library_adam(g, *theirs, step, **adam)
    apart = [steps_apart(a, b) for a, b in zip(theirs, ours)]
    log("  torch._fused_adam_ against adam_epilogue_step, one step at "
        f"{DGA_DIAG_SHAPE[1:]}: " + ", ".join(
            f"{k} differs on {share:.2e} of the elements by at most {worst:.2f} steps"
            for k, (share, worst) in zip(names, apart)))
    del ours, theirs

    full = (size * (6 * mn + K * M + K * N), 2 * K * mn)
    plans = {
        "fused": (lambda: dga.fused_dense_grad_adam(x, dz, w, mu, nu, **kw),
                  lambda: dga.fused_dense_grad_adam_reference(x, dz, w, mu, nu, **kw),
                  lambda: library_step(x.t()), product_bound(*full)),
        "fused_xt": (lambda: dga.fused_dense_grad_adam(xt, dz, w, mu, nu, x_transposed=True,
                                                       **kw),
                     lambda: dga.fused_dense_grad_adam_reference(xt, dz, w, mu, nu,
                                                                 x_transposed=True, **kw),
                     lambda: library_step(xt), product_bound(*full)),
        "dense_grad": (lambda: dga.dense_grad(x, dz, out=gbuf),
                       lambda: dga.dense_grad_reference(x, dz, out=gbuf),
                       lambda: torch.matmul(x.t(), dz),
                       product_bound(size * (mn + K * M + K * N), 2 * K * mn)),
        "stream_copy": (lambda: dga.stream_copy(w, mu, nu, out=outs),
                        lambda: dga.stream_copy_reference(w, mu, nu, out=outs),
                        lambda: [o.copy_(t) for o, t in zip(outs, (w, mu, nu))],
                        bound(size * 6 * mn, 0)),
        "epilogue_bf16": (lambda: dga.adam_epilogue_step(g, w, mu, nu, arithmetic="bfloat16",
                                                         **kw),
                          lambda: dga.adam_epilogue_bf16_reference(g, w, mu, nu, **kw), None,
                          bound(size * 7 * mn, 12 * mn)),
        "epilogue_f32": (lambda: dga.adam_epilogue_step(g, w, mu, nu, **kw),
                         lambda: dga.adam_epilogue_reference(g, w, mu, nu, **kw),
                         lambda: library_adam(g, w, mu, nu, step, **adam),
                         bound(size * 7 * mn, 12 * mn)),
    }
    records = {}
    for key, (kernel, plain, library, (bound_ms, bound_by)) in plans.items():
        records[key] = dict(
            shape=list(DGA_DIAG_SHAPE), max_abs_err=errs[key], ms=median_ms(kernel),
            device_ms=queued_ms(kernel), plain_ms=median_ms(plain, runs=10, warmup=2),
            library_ms=median_ms(library, runs=20, warmup=2) if library else None,
            bound_ms=bound_ms, bound_by=bound_by)
    cuda_core = lambda: dga._launch_dense_grad("cuda_core", x, dz, gbuf)  # noqa: E731
    records["dense_grad"].update(arrangement="wgmma", cuda_core_ms=median_ms(cuda_core, runs=20),
                                 cuda_core_device_ms=queued_ms(cuda_core, runs=20),
                                 **phase_q_tensor_cores(dev))
    big = lambda: dga.fused_dense_grad_adam(x, dz, w, mu, nu, tile="big", **kw)  # noqa: E731
    records["fused"]["big_tile_ms"] = median_ms(big)
    records["fused"]["big_tile_device_ms"] = queued_ms(big)
    assert all(torch.isfinite(t).all() for t in (w, mu, nu))
    for key, r in records.items():
        library = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"  {key} at {DGA_DIAG_SHAPE} bfloat16, median of 100: kernel {r['ms']:.4f} ms "
            f"({r['device_ms']:.4f} ms back to back), plain (median of 10) "
            f"{r['plain_ms']:.4f} ms, library calls (median of 20) {library}, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
    log(f"  fused with 128 x 128 tiles: {records['fused']['big_tile_ms']:.4f} ms "
        f"({records['fused']['big_tile_device_ms']:.4f} ms back to back)")
    r = records["dense_grad"]
    log(f"  dense_grad at {DGA_DIAG_SHAPE}: wgmma {r['ms']:.4f} ms ({r['device_ms']:.4f} back to "
        f"back; {2 * K * M * N / r['ms'] / 1e9:.1f} TFLOP/s), CUDA-core arrangement (median of "
        f"20) {r['cuda_core_ms']:.4f} ms ({r['cuda_core_device_ms']:.4f}): "
        f"{r['cuda_core_ms'] / r['ms']:.1f}x; torch.matmul {r['library_ms']:.4f} ms; bound "
        f"{r['bound_ms']:.5f} ms")
    return records


def phase_q_tensor_cores(dev):
    """Kernel 6's tensor-core arrangement: HGMMA in its SASS, one-hot products
    and small integers exact, the small and the flagship's dense shapes against
    a float64 product over row blocks of M, and the flagship's times beside the
    bound, the CUDA-core arrangement and torch.matmul (a yardstick only this
    script calls). Returns the additions to kernel 6's record."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops import dense_grad_adam as dga
    from trustedai_cl_vae_ad_tpu_torch.probes import r11
    from trustedai_cl_vae_ad_tpu_torch.testing import steps_apart

    bf16 = torch.bfloat16
    hgmma = sass_instructions("dense_grad_wgmma", "HGMMA")
    assert hgmma, "no HGMMA instruction in the SASS of dense_grad_wgmma"
    log(f"  SASS of dense_grad_wgmma: {len(hgmma)} HGMMA instructions, e.g. {hgmma[0]}")

    def counted(fn):  # one launch, under "wgmma"
        want = dict(dga.dense_grad_arrangements, wgmma=dga.dense_grad_arrangements["wgmma"] + 1)
        out = fn()
        torch.cuda.synchronize()
        assert dga.dense_grad_arrangements == want, (dga.dense_grad_arrangements, want)
        return out

    for K, M, N, k, i, j in DGW_ONE_HOT:
        x = torch.zeros((K, M), dtype=bf16, device=dev)
        dz = torch.zeros((K, N), dtype=bf16, device=dev)
        x[k, i], dz[k, j] = 1.0, 1.0
        g = counted(lambda: dga.dense_grad(x, dz))
        assert g.nonzero().tolist() == [[i, j]] and float(g[i, j]) == 1.0, (
            (K, M, N, k, i, j), g.nonzero()[:4].tolist())
    for K, M, N in DGW_SMALL_SHAPES:  # partial sums of integers below 2^11: exact in any order
        gen = torch.Generator(device=dev).manual_seed(K + M + N)
        x = torch.randint(-3, 4, (K, M), generator=gen, device=dev).to(bf16)
        dz = torch.randint(-3, 4, (K, N), generator=gen, device=dev).to(bf16)
        got = counted(lambda: dga.dense_grad(x, dz))
        assert torch.equal(got, (x.double().t() @ dz.double()).to(bf16)), (K, M, N)
    log(f"  one-hot products at {len(DGW_ONE_HOT)} places land where they belong; small "
        f"integer operands exact at {DGW_SMALL_SHAPES}")

    def against_float64(x, dz, got):
        """(share, worst steps) of got against the float64 product rounded once, taken over
        row blocks of M, with the floor K 2^-24 max|g| for sums whose terms cancel."""
        (K, M), N = x.shape, dz.shape[1]
        rows = max(1, DGA_BLOCK_ELEMENTS // N)
        dz64, blocks = dz.double(), [(a, min(a + rows, M)) for a in range(0, M, rows)]
        floor = K * 2.0 ** -24 * max(float((x[:, a:b].double().t() @ dz64).abs().max())
                                     for a, b in blocks)
        differing, worst = 0, 0.0
        for a, b in blocks:
            ref = (x[:, a:b].double().t() @ dz64).float().to(bf16)
            share, steps = steps_apart(got[a:b], ref, floor=floor)
            differing, worst = differing + round(share * ref.numel()), max(worst, steps)
        return differing / (M * N), worst

    flagship = []
    for shape in [*DGW_SMALL_SHAPES, *DGW_FLAGSHIP_SHAPES]:
        torch.cuda.empty_cache()
        K, M, N = shape
        ops = r11.make_operands(K, M, N, dev, torch.Generator(device=dev).manual_seed(K + M + N))
        x, dz = ops["x"], ops["dz"]
        del ops
        got = counted(lambda: dga.dense_grad(x, dz))
        assert torch.equal(got, counted(lambda: dga.dense_grad(x, dz, out=torch.empty_like(got))))
        share, worst = against_float64(x, dz, got)
        assert worst <= 1.0 and share <= 0.01, (shape, share, worst)
        log(f"  {shape} bfloat16 (wgmma): two runs equal; within one step of a float64 product "
            f"rounded once, on {share:.2e} of the elements (worst {worst:.2f} steps)")
        if shape not in DGW_FLAGSHIP_SHAPES:
            continue
        kernel = lambda: dga.dense_grad(x, dz, out=got)  # noqa: E731
        cuda_core = lambda: dga._launch_dense_grad("cuda_core", x, dz, got)  # noqa: E731
        bound_ms, bound_by = product_bound(2 * (M * N + K * M + K * N), 2 * K * M * N)
        rec = dict(shape=list(shape), share_off_float64=share, worst_steps=worst,
                   ms=median_ms(kernel, runs=20), device_ms=queued_ms(kernel, runs=20),
                   cuda_core_ms=median_ms(cuda_core, runs=5, warmup=1),
                   library_ms=median_ms(lambda: torch.matmul(x.t(), dz), runs=20),
                   bound_ms=bound_ms, bound_by=bound_by)
        flagship.append(rec)
        log(f"  dense_grad at {shape}: wgmma {rec['ms']:.4f} ms ({rec['device_ms']:.4f} back to "
            f"back; {2 * K * M * N / rec['ms'] / 1e9:.1f} TFLOP/s), CUDA-core arrangement "
            f"(median of 5) {rec['cuda_core_ms']:.4f} ms, torch.matmul {rec['library_ms']:.4f} "
            f"ms, bound {bound_ms:.5f} ms ({bound_by})")
        del x, dz, got
    torch.cuda.empty_cache()
    return {"sass_hgmma": len(hgmma), "flagship": flagship,
            "ptxas": ptxas_report("dense_grad_wgmma")}


def phase_r(dev):
    """The probes at full width through probes/r11.py::run; returns the launch
    counts of that path, the harnesses' records and the epilogue's times at
    the flagship's dense shapes."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops import dense_grad_adam as dga
    from trustedai_cl_vae_ad_tpu_torch.ops.adam import make_optimizer
    from trustedai_cl_vae_ad_tpu_torch.probes import r11
    from trustedai_cl_vae_ad_tpu_torch.testing import steps_apart

    gib, adam, names = 2.0 ** 30, r11.ADAM, ("w", "mu", "nu")
    for counts in (dga.launches, dga.dense_grad_arrangements):
        for key in counts:
            counts[key] = 0
    expected = dict.fromkeys(dga.launches, 0)
    records = []

    def drive(harness, variant, **job):
        torch.cuda.empty_cache()
        rec, state = r11.run(harness, variant, steps=DGA_STEPS, device=dev, seed=0, **job)
        K, M, N = rec["K"], rec["M"], rec["N"]
        if rec["kernel"]:
            expected[rec["kernel"]] += r11.WARMUP + DGA_STEPS + ("check_shape" in rec)
            # in place, no scratch: a step allocates nothing
            assert rec["temp_gb"] == 0.0, (variant, rec["temp_gb"])
        else:  # torch.matmul writes the (M, N) gradient
            assert rec["temp_gb"] >= M * N * 2 / gib, rec["temp_gb"]
        assert all(bool(torch.isfinite(t).all()) for t in state), (variant, "not finite")
        first = r11.make_operands(K, M, N, dev, torch.Generator(device=dev).manual_seed(0))
        if variant == "dot_only":
            assert bool((state[0] != 0).any())
        elif variant == "copy_only":
            assert all(torch.equal(t, first[k]) for t, k in zip(state, names))
        else:  # in bfloat16 arithmetic b2 rounds to 1 and nu stays, as in the TPU probe
            stays = ("nu",) if variant == "epi_bf16" else ()
            for t, k in zip(state, names):
                assert torch.equal(t, first[k]) == (k in stays), (variant, k, "changed or not")
        records.append(rec)
        check = (f", check at {tuple(rec['check_shape'])} "
                 f"{ {k: round(v, 5) for k, v in rec['max_err_vs_scale'].items()} }"
                 if "check_shape" in rec else "")
        log(f"  {harness} {rec.get('shape', '')} {variant} ({K}, {M}, {N}): "
            f"{rec['event_ms']:.4f} ms a step by CUDA events, {rec['ms']:.4f} by the host clock, "
            f"floor {rec['floor_ms']:.4f} ms, a step allocates {rec['temp_gb']:.3f} GiB{check}")

    for shape_name in ("enc", "dec"):
        for variant in ("torch", "fused"):
            drive("fused", variant, shape_name=shape_name)
    for variant in r11.DIAG_VARIANTS:
        drive("diag", variant)
    drive("fused", "fused", shape=DGA_PORT_LAYOUT, check=False)

    # the whole state after one step at every full-width shape that was driven, against the
    # plain version over row blocks of M (whole, enc's float32 temporaries would be 4.3 GB each)
    def whole_state(label, shape):
        torch.cuda.empty_cache()
        K, M, N = shape
        ops = r11.make_operands(K, M, N, dev, torch.Generator(device=dev).manual_seed(1))
        got = [ops[k].clone() for k in names]
        dga.fused_dense_grad_adam(ops["x"], ops["dz"], *got, count=1, **adam)
        expected["fused"] += 1
        rows = max(1, DGA_BLOCK_ELEMENTS // N)
        worst, differing, diff_max, ref_max = 0.0, 0, [0.0] * 3, [0.0] * 3
        for r0 in range(0, M, rows):
            r1 = min(r0 + rows, M)
            xb = ops["x"][:, r0:r1].contiguous()
            ref = [ops[k][r0:r1] for k in names]  # row blocks of a contiguous matrix: contiguous
            w_old = ref[0].float()
            terms = [None, torch.maximum(ref[1].float().abs(), dga.dense_grad_reference(
                xb, ops["dz"]).float().abs()), None]
            dga.fused_dense_grad_adam_reference(xb, ops["dz"], *ref, count=1, **adam)
            terms[0] = torch.maximum(w_old.abs(), (w_old - ref[0].float()).abs())
            for i in range(3):
                block = got[i][r0:r1]
                share, steps = steps_apart(block, ref[i], terms[i])
                worst, differing = max(worst, steps), differing + round(share * block.numel())
                diff_max[i] = max(diff_max[i],
                                  float((block.float() - ref[i].float()).abs().max()))
                ref_max[i] = max(ref_max[i], float(ref[i].float().abs().max()))
        scale = {k: d / r for k, d, r in zip(names, diff_max, ref_max)}
        assert worst <= 1.0 and differing <= 0.01 * 3 * M * N and all(
            v < 1 / 64 for v in scale.values()), (label, worst, differing, scale)
        log(f"  {label} ({K}, {M}, {N}), one step, all of w, mu, nu against the plain version "
            f"over blocks of {rows} rows: {differing} of {3 * M * N} elements differ, by at "
            f"most {worst:.2f} steps; max error over scale "
            f"{ {k: round(v, 5) for k, v in scale.items()} }")

    for label in ("enc", "dec"):
        whole_state(label, r11.SHAPES[label])
    whole_state("port layout", DGA_PORT_LAYOUT)
    launches = dict(dga.launches)
    assert launches == expected, (launches, expected)
    # dot_only's bf16 product at (768, 12800, 4000) goes to the tensor cores, every launch
    arrangements = dict(dga.dense_grad_arrangements)
    assert arrangements == {"wgmma": expected["dense_grad"], "cuda_core": 0}, arrangements
    log(f"  launches on this path: {launches}; dense_grad by arrangement: {arrangements}")

    # what one pass over the bytes costs: the float32 epilogue on the flagship's two dense
    # kernels, first held bit for bit against its plain version over row blocks (same
    # operations in the same order; at (268800, 4000) its byte offsets pass 2^31), then timed
    # beside the eager adam_lean step and the library's one-pass Adam on tensors of the same
    # shape (other roundings of mu: times side by side, no comparison of values)
    flagship = []
    step = torch.tensor(5.0, device=dev)
    for M, N in ((268800, 4000), (2000, 134400)):
        torch.cuda.empty_cache()
        gen = torch.Generator(device=dev).manual_seed(2)
        ops = r11.make_operands(1, M, N, dev, gen)
        g = r11.make_gradient(M, N, dev, gen)
        state = [ops[k] for k in names]
        got = [t.clone() for t in state]
        dga.adam_epilogue_step(g, *got, count=5, **adam)
        assert not torch.equal(got[0], state[0]), "w did not move"
        rows = max(1, DGA_BLOCK_ELEMENTS // N)
        for r0 in range(0, M, rows):
            ref = [t[r0:r0 + rows] for t in state]  # the plain version steps the block in place
            dga.adam_epilogue_reference(g[r0:r0 + rows], *ref, count=5, **adam)
            for name, a, b in zip(names, got, ref):
                assert torch.equal(a[r0:r0 + rows], b), ((M, N), name, r0, steps_apart(
                    a[r0:r0 + rows], b))
        epilogue = lambda: dga.adam_epilogue_step(g, *state, count=5, **adam)  # noqa: E731
        rec = {"shape": [M, N], "epilogue_ms": median_ms(epilogue, runs=20),
               "epilogue_device_ms": queued_ms(epilogue, runs=20),
               "fused_adam_ms": median_ms(lambda: library_adam(g, *got, step, **adam), runs=20),
               "bound_ms": bound(2 * 7 * M * N, 12 * M * N)[0]}
        param = ops["w"].clone()
        opt = make_optimizer({"w": param}, adam["lr"], torch.bfloat16, "adam_lean")
        rec["adam_lean_step_ms"] = median_ms(lambda: opt.step([g]), runs=10, warmup=2)
        assert all(bool(torch.isfinite(t).all()) for t in (param, *state, *got))
        flagship.append(rec)
        log(f"  one Adam step on a ({M}, {N}) bfloat16 kernel: the streaming epilogue equals "
            f"its plain version bit for bit; {rec['epilogue_ms']:.4f} ms "
            f"({rec['epilogue_device_ms']:.4f} ms back to back; median of 20), "
            f"torch._fused_adam_ (median of 20) {rec['fused_adam_ms']:.4f} ms, ops/adam.py's "
            f"adam_lean step (median of 10) {rec['adam_lean_step_ms']:.4f} ms, bound of one "
            f"pass {rec['bound_ms']:.4f} ms")
        del ops, g, state, got, param, opt
    torch.cuda.empty_cache()
    return {"launches": launches, "dense_grad_arrangements": arrangements, "records": records,
            "flagship_epilogue": flagship}


def cudnn_weight_gradient(x, dy):
    """The call that takes the library's weight gradient of the 3x3, stride-2, SAME
    convolution, (CO, CI, 3, 3), from NHWC x and dy: the yardstick of phase (s); the port
    never calls it. The padding is done here, once, outside what is timed: in the model the
    forward has already made the padded input."""
    import torch

    xpad = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1))
    dy_nchw = dy.permute(0, 3, 1, 2)
    weight = torch.empty((dy.shape[3], x.shape[3], 3, 3), dtype=x.dtype, device=x.device)
    return lambda: torch.ops.aten.convolution_backward(
        dy_nchw, xpad, weight, None, [2, 2], [0, 0], [1, 1], False, [0, 0], 1,
        [False, True, False])[1]


def conv_dw_float64(x, dy, block=CONV_DW_BLOCK):
    """dW (3, 3, CI, CO) in float64: the plain version with float64 sums, taken over blocks
    of ``block`` images."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops.conv_dw import conv_dw_reference

    return sum(conv_dw_reference(x[b0:b0 + block], dy[b0:b0 + block], accumulate=torch.float64)
               for b0 in range(0, x.shape[0], block))


def sass_instructions(library, opcode):
    """The instructions of one opcode (HGMMA, IMMA) in the SASS of a built kernel library
    (cuobjdump)."""
    from trustedai_cl_vae_ad_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_paths[library])],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    return [line.split(";")[0].strip() for line in sass.splitlines() if opcode in line]


def resource_usage(library):
    """Registers, shared memory and stack of each kernel of a built library as cuobjdump reads
    them from the binary (also when an earlier process built it, and no ptxas report is
    at hand)."""
    from trustedai_cl_vae_ad_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "--dump-resource-usage", str(_build.library_paths[library])],
                         capture_output=True, text=True, timeout=120, check=True).stdout
    return [" ".join(line.split()) for line in out.splitlines() if "REG:" in line]


def ptxas_report(library):
    from trustedai_cl_vae_ad_tpu_torch.ops import _build

    return [line.strip() for line in _build.build_log.get(library, "").splitlines()
            if "registers" in line or "spill" in line or "smem" in line]


def conv_dw_close(got, ref64, label):
    """Within 1e-4 of the largest |dW| plus 1e-4 relative of the float64 reference; returns
    (largest error, largest |dW|)."""
    err = (got.double() - ref64).abs()
    scale = float(ref64.abs().max())
    assert bool((err <= 1e-4 * scale + 1e-4 * ref64.abs()).all()), (label, float(err.max()), scale)
    return float(err.max()), scale


def conv_dw_operands(dev, shape, dtype, seed=0):
    import torch

    b, h, w, ci, co = shape
    gen = torch.Generator(device=dev).manual_seed(seed + b + h + w + ci + co)
    x = torch.randn((b, h, w, ci), device=dev, generator=gen).to(dtype)
    dy = torch.randn((b, h // 2, w // 2, co), device=dev, generator=gen).to(dtype)
    return x, dy


def phase_s(dev):
    """The convolution weight-gradient kernels vs their plain version and a float64 reference
    on the card; returns each arrangement's record at the flagship layer the main path runs
    it on (conv1: the CUDA-core kernel, conv2: the tensor cores), the other layer beside it."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.models.cvae import conv2d_same
    from trustedai_cl_vae_ad_tpu_torch.ops import conv_dw as cdw
    from trustedai_cl_vae_ad_tpu_torch.probes import r18
    from trustedai_cl_vae_ad_tpu_torch.testing import shifted

    launches = cdw.launches
    for shape in CONV_DW_SMALL:
        for dtype in (torch.float32, torch.bfloat16):
            x, dy = conv_dw_operands(dev, shape, dtype)
            assert cdw.conv_dw_arrangement(x, dy) == "cuda_core", shape
            got = cdw.conv_dw(x, dy)
            torch.cuda.synchronize()
            assert got.shape == (3, 3, shape[3], shape[4]) and got.dtype == torch.float32
            err, scale = conv_dw_close(got, conv_dw_float64(x, dy), (shape, dtype))
            plain_err, _ = conv_dw_close(cdw.conv_dw_reference(x, dy), conv_dw_float64(x, dy),
                                         (shape, dtype, "plain"))
            assert torch.equal(got, cdw.conv_dw(x, dy)), "two runs differ"
            # the same values one element into an allocation: the staging reads element by
            # element, the sums are taken in the same order
            assert x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
            xs, dys = shifted(x, 1), shifted(dy, 1)
            assert xs.data_ptr() % 16 and dys.data_ptr() % 16
            assert cdw.conv_dw_arrangement(xs, dys) == "cuda_core"
            assert torch.equal(got, cdw.conv_dw(xs, dys)), "a misaligned view gives other bits"
            log(f"  {shape} {str(dtype)[6:]} (cuda_core): max_abs_err {err:.3g} of {scale:.3g} "
                f"against float64 (plain version {plain_err:.3g}); two runs and a view at +1 "
                f"element give equal bits")
    assert cdw.launches == launches + 3 * 2 * len(CONV_DW_SMALL)

    x, dy = conv_dw_operands(dev, CONV_DW_SMALL[0], torch.float32)
    for what, call, error in (
            ("odd H", lambda: cdw.conv_dw(x[:, :7], dy), ValueError),
            ("odd W", lambda: cdw.conv_dw(x[:, :, :11].contiguous(), dy), ValueError),
            ("mixed dtypes", lambda: cdw.conv_dw(x.bfloat16(), dy), TypeError),
            ("a non-contiguous dy", lambda: cdw.conv_dw(
                x, dy.transpose(1, 2).contiguous().transpose(1, 2)), ValueError),
            ("dy on the cpu", lambda: cdw.conv_dw(x, dy.cpu()), ValueError),
            ("a dy of another size", lambda: cdw.conv_dw(x, dy[:, :3].contiguous()), ValueError),
            ("an odd input to the Function", lambda: cdw.conv2d_s2_kernel_dw(
                x[:, :7], torch.zeros(3, 3, 3, 8, device=dev)), ValueError),
            ("a wgmma launch off the rule (CI = 3)",
             lambda: cdw._launch("wgmma", x.bfloat16(), dy.bfloat16()), RuntimeError)):
        expect_raises(call, error, what)

    # both gradients through the Function against autograd of conv2d_same: float32 (TF32 is
    # off) at the check's tolerance, bfloat16 within bfloat16's 8 bits of the float32 result
    for shape in CONV_DW_SMALL[:2] + [(8, 32, 48, 32, 64)]:
        b, h, w, ci, co = shape
        x, dy = conv_dw_operands(dev, shape, torch.float32, seed=1)
        gen = torch.Generator(device=dev).manual_seed(ci)
        weight = torch.randn((3, 3, ci, co), device=dev, generator=gen) * 0.1
        ref_dx, ref_dw = r18.autograd_gradients(x, weight, dy)
        ref_y = conv2d_same(x.permute(0, 3, 1, 2), weight.permute(3, 2, 0, 1), None, 2)
        for dtype, rtol in ((torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -6)):
            xx = x.to(dtype).clone().requires_grad_(True)
            ww = weight.to(dtype).clone().requires_grad_(True)
            before = cdw.launches
            y = cdw.conv2d_s2_kernel_dw(xx, ww)
            (y * dy.to(dtype)).sum().backward()
            torch.cuda.synchronize()
            assert cdw.launches == before + 1 and ww.grad.dtype == dtype
            for name, got, ref in (("y", y.detach(), ref_y.permute(0, 2, 3, 1)),
                                   ("dx", xx.grad, ref_dx),
                                   ("dW", ww.grad, ref_dw)):
                scale = float(ref.abs().max())
                torch.testing.assert_close(got.float(), ref, rtol=rtol, atol=rtol * scale,
                                           msg=lambda m: f"{shape} {dtype} {name}: {m}")
        log(f"  {shape}: forward, dx and dW through the Function agree with autograd of "
            f"conv2d_same in float32 (rtol 1e-4) and bfloat16 (rtol 2^-6)")

    tensor_cores = phase_s_tensor_cores(dev)

    records = {}
    for label, (h, w, ci, co) in r18.FLAGSHIP_SHAPES.items():
        torch.cuda.empty_cache()
        shape = (CONV_DW_BATCH, h, w, ci, co)
        x, dy = conv_dw_operands(dev, shape, torch.bfloat16)
        arrangement = cdw.conv_dw_arrangement(x, dy)
        assert arrangement == ("wgmma" if label == "conv2" else "cuda_core"), (label, arrangement)
        before = dict(cdw.conv_dw_arrangements)
        got = cdw.conv_dw(x, dy)
        torch.cuda.synchronize()
        assert cdw.conv_dw_arrangements[arrangement] == before[arrangement] + 1
        err, scale = conv_dw_close(got, conv_dw_float64(x, dy), shape)
        assert torch.equal(got, cdw.conv_dw(x, dy)), "two runs differ"
        library_call = cudnn_weight_gradient(x, dy)
        library = library_call().float().permute(2, 3, 1, 0)
        library_err = float((library.double() - got.double()).abs().max())
        nbytes = x.element_size() * (x.numel() + dy.numel()) + 4 * got.numel()
        positions = CONV_DW_BATCH * (h // 2) * (w // 2)
        bound_ms, bound_by = product_bound(nbytes, 2 * 9 * ci * co * positions)
        assert abs(bound_ms - r18.kernel_bound(*shape, x.element_size())[0]) < 1e-12
        # dy as the library may hand it over: NCHW memory behind an NHWC view
        dy_nchw = dy.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        records[label] = dict(
            shape=list(shape), arrangement=arrangement, max_abs_err=err,
            ms=median_ms(lambda: cdw.conv_dw(x, dy)),
            device_ms=queued_ms(lambda: cdw.conv_dw(x, dy)),
            plain_ms=median_ms(lambda: cdw.conv_dw_reference(x, dy), runs=5, warmup=1),
            library_ms=median_ms(library_call, runs=20, warmup=2),
            nhwc_copy_ms=median_ms(lambda: dy_nchw.contiguous(), runs=20, warmup=2),
            bound_ms=bound_ms, bound_by=bound_by)
        r = records[label]
        flops = 2 * 9 * ci * co * positions
        log(f"  {label} {shape} bfloat16 ({arrangement}): max_abs_err {err:.3g} of {scale:.3g} "
            f"against float64 over blocks of {CONV_DW_BLOCK} images (cuDNN's bfloat16 result is "
            f"{library_err:.3g} from the kernel's), two runs equal bit for bit")
        if arrangement == "wgmma":  # the CUDA-core kernel on the same operands, beside it
            cuda_core = lambda: cdw._launch("cuda_core", x, dy)  # noqa: E731
            r["cuda_core_max_abs_err"] = conv_dw_close(cuda_core(), conv_dw_float64(x, dy),
                                                       (shape, "cuda_core"))[0]
            r["cuda_core_ms"] = median_ms(cuda_core, runs=20, warmup=2)
            r["cuda_core_device_ms"] = queued_ms(cuda_core, runs=20)
            # one block of 384 threads and 230,400 bytes of shared memory an SM: splits = SMs
            r["splits"] = cdw.build_wgmma().cdw_wgmma_splits(*shape)
            log(f"  {label} the CUDA-core arrangement on the same operands (median of 20): "
                f"{r['cuda_core_ms']:.4f} ms ({r['cuda_core_device_ms']:.4f} ms back to back), "
                f"max_abs_err {r['cuda_core_max_abs_err']:.3g}; the wgmma launch split the "
                f"positions over {r['splits']} blocks on "
                f"{torch.cuda.get_device_properties(dev).multi_processor_count} SMs")
        log(f"  {label} median of 100: kernel {r['ms']:.4f} ms ({r['device_ms']:.4f} ms back to "
            f"back, {flops / r['device_ms'] / 1e9:.1f} TFLOP/s), plain (median of 5) "
            f"{r['plain_ms']:.4f} ms, cuDNN's weight gradient (median of 20) "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}); an NHWC "
            f"copy of dy ({dy.numel() * 2 / 1e6:.0f} MB) {r['nhwc_copy_ms']:.4f} ms")
        del x, dy, dy_nchw, got, library, library_call
    torch.cuda.empty_cache()
    records["conv2"].update(tensor_cores)
    return records


def phase_s_tensor_cores(dev):
    """Kernel 11's tensor-core arrangement at small shapes: HGMMA in its SASS, its ptxas
    report, one-hot products in their place, float64 parity, two runs equal; a view one
    element into an allocation takes the CUDA-core kernel and is held to float64 too.
    Returns the additions to conv2's record."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops import conv_dw as cdw
    from trustedai_cl_vae_ad_tpu_torch.testing import shifted

    hgmma = sass_instructions("conv_dw_wgmma", "HGMMA")
    assert hgmma, "no HGMMA instruction in the SASS of conv_dw_wgmma"
    ptxas = ptxas_report("conv_dw_wgmma")
    log(f"  SASS of conv_dw_wgmma: {len(hgmma)} HGMMA instructions, e.g. {hgmma[0]}")
    for line in ptxas:
        log(f"  ptxas conv_dw_wgmma: {line}")

    def counted(arrangement, fn):  # one launch, under `arrangement`
        want = dict(cdw.conv_dw_arrangements)
        want[arrangement] += 1
        out = fn()
        torch.cuda.synchronize()
        assert cdw.conv_dw_arrangements == want, (cdw.conv_dw_arrangements, want)
        return out

    for (b, h, w, ci, co), xi, di in CONV_DW_ONE_HOT:
        x = torch.zeros((b, h, w, ci), dtype=torch.bfloat16, device=dev)
        dy = torch.zeros((b, h // 2, w // 2, co), dtype=torch.bfloat16, device=dev)
        x[xi], dy[di] = 1.0, 1.0
        got = counted("wgmma", lambda: cdw.conv_dw(x, dy))
        want = [[xi[1] - 2 * di[1], xi[2] - 2 * di[2], xi[3], di[3]]]
        assert got.nonzero().tolist() == want and float(got[tuple(want[0])]) == 1.0, (
            xi, di, got.nonzero()[:4].tolist())
    log(f"  one-hot products at {len(CONV_DW_ONE_HOT)} places land where they belong")
    for shape in CONV_DW_WGMMA_SMALL:
        x, dy = conv_dw_operands(dev, shape, torch.bfloat16)
        got = counted("wgmma", lambda: cdw.conv_dw(x, dy))
        ref64 = conv_dw_float64(x, dy)
        err, scale = conv_dw_close(got, ref64, (shape, "wgmma"))
        assert torch.equal(got, counted("wgmma", lambda: cdw.conv_dw(x, dy))), "two runs differ"
        xs, dys = shifted(x, 1), shifted(dy, 1)
        view_err, _ = conv_dw_close(counted("cuda_core", lambda: cdw.conv_dw(xs, dys)), ref64,
                                    (shape, "a view at +1 element"))
        log(f"  {shape} bfloat16 (wgmma): max_abs_err {err:.3g} of {scale:.3g} against float64, "
            f"two runs equal; a view at +1 element takes the CUDA-core kernel: {view_err:.3g}")
    return {"sass_hgmma": len(hgmma), "ptxas": ptxas}


def phase_t(dev):
    """probes/r18.py's bench at full width; returns the kernel's launches on that path and
    the three variants' records."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops import conv_dw as cdw
    from trustedai_cl_vae_ad_tpu_torch.ops import moments
    from trustedai_cl_vae_ad_tpu_torch.probes import r18

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cdw.launches = 0
    cdw.conv_dw_arrangements.update(wgmma=0, cuda_core=0)
    moments.reset_counts()
    rows = r18.bench(batch=R18_BATCH, steps=R18_STEPS, warmup=R18_WARMUP, device=dev, seed=0)
    launches, arrangements = cdw.launches, dict(cdw.conv_dw_arrangements)
    peak = torch.cuda.max_memory_allocated()
    steps = R18_WARMUP + R18_STEPS
    assert [r["variant"] for r in rows] == [label for label, _ in r18.VARIANTS]
    for row, (label, patch) in zip(rows, r18.VARIANTS):
        assert row["routed"] == list(range(patch)), row
        assert row["launches"] == steps * patch, (label, row["launches"])
        # conv1 (CI = 3) on the CUDA-core kernel, conv2 (32 -> 64, bfloat16) on the tensor cores
        assert row["arrangements"] == {"cuda_core": steps * min(patch, 1),
                                       "wgmma": steps * max(patch - 1, 0)}, (label, row)
        assert row["moments_launches"] == [steps, steps], (label, row["moments_launches"])
        assert row["last_loss"] == row["last_loss"] and abs(row["last_loss"]) != float("inf")
        log(f"  {label}: {row['ms_per_step']:.2f} ms a step by the host clock, "
            f"{row['event_ms']:.2f} by CUDA events, {row['fps']:.1f} frames/s ({R18_STEPS} steps "
            f"after {R18_WARMUP} warm-up, batch {R18_BATCH}); loss after one update "
            f"{row['loss_after_one_step']:.6f}, last {row['last_loss']:.6f}; kernel launches "
            f"{row['launches']} {row['arrangements']}; the Function copied "
            f"{row['copied_bytes_per_step'] / 1e6:.1f} MB a step into NHWC order")
    # two checking steps and the timed run for each variant: 0 + 1 + 2 routed convolutions, of
    # which conv1 (1 + 1) takes the CUDA-core kernel and conv2 (0 + 1) the tensor cores
    assert launches == (2 + steps) * 3, launches
    assert arrangements == {"cuda_core": (2 + steps) * 2, "wgmma": 2 + steps}, arrangements
    assert moments.launches == moments.bwd_launches == (2 + steps) * 3
    assert moments.moments_arrangements["global_forward"] == {"cluster": (2 + steps) * 3,
                                                             "blocks": 0}
    log(f"  kernel launches on this path {launches} {arrangements}; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")
    return {"launches": launches, "arrangements": arrangements, "rows": rows}


def phase_u(dev):
    """Crash-atomic checkpoints of the flagship from the card; returns the seconds of the
    synchronous save, of the blocking part of the asynchronous one, and of the reload."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.config import load_config, save_config, validate_config
    from trustedai_cl_vae_ad_tpu_torch.registry import (
        load_model_from_config,
        load_model_from_directory,
    )
    from trustedai_cl_vae_ad_tpu_torch.train import checkpoint

    torch.cuda.empty_cache()
    config = validate_config(load_config(os.path.join(REPO, "configs", "config.yml")))
    config["training"]["precision"] = "float32"
    model = load_model_from_config(config, seed=0)
    model.compile()
    assert model.optimizer.name == "adam" and model.device.type == "cuda"
    w, h, c = config["data"]["image_size"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    batch = torch.randint(0, 256, (32, w, h, c), dtype=torch.uint8, device="cuda", generator=gen)
    state_bytes = sum(t.numel() * t.element_size() for t in model.params.values()) * 3
    logdir = tempfile.mkdtemp(prefix="chip_smoke_rounds_")
    try:
        save_config(config, os.path.join(logdir, "config.yml"))
        log(f"  state {state_bytes / 1e9:.1f} GB; {shutil.disk_usage(logdir).free / 1e9:.0f} GB "
            f"free under the temporary directory")
        sync_s = []
        for with_moments in (False, True):  # round 1: the weights alone (5.4 GB)
            model.train_step(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.save_model(logdir, include_optimizer=with_moments)
            sync_s.append(time.perf_counter() - t0)
            assert checkpoint.has_optimizer(logdir) == with_moments
        rounds = os.path.join(logdir, checkpoint.ROUNDS_SUBDIR)
        assert sorted(os.listdir(rounds)) == ["00000001", "00000002"], os.listdir(rounds)
        assert os.readlink(os.path.join(logdir, "current")) == os.path.join("rounds", "00000002")
        for sub in ("encoder", "decoder", "optimizer"):
            path = os.path.join(logdir, sub)
            assert os.path.islink(path) and os.path.isdir(path), sub
        assert checkpoint.has_optimizer(logdir)
        want = float(model.test_step(batch)["loss"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reloaded, _ = load_model_from_directory(logdir)
        again = float(reloaded.test_step(batch)["loss"])
        reload_s = time.perf_counter() - t0
        assert abs(again - want) <= 1e-5 * abs(want), (again, want)
        del reloaded
        torch.cuda.empty_cache()

        # one round through the background writer, a training step taken while it writes
        shutil.rmtree(os.path.join(rounds, "00000001"))  # room for the third round's staging
        at_save = {k: v.detach().clone() for k, v in model.params.items()}
        count_at_save = model.optimizer.count
        saver = checkpoint.AsyncSaver()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.save_model(logdir, saver=saver)
        blocking_s = time.perf_counter() - t0
        model.train_step(batch)
        torch.cuda.synchronize()
        step_done_s = time.perf_counter() - t0
        assert checkpoint.resolve_round_dir(logdir).endswith("00000002")  # not committed yet
        saver.wait()
        async_total_s = time.perf_counter() - t0
        saver.close()
        assert sorted(os.listdir(rounds)) == ["00000002", "00000003"], os.listdir(rounds)
        assert checkpoint.resolve_round_dir(logdir).endswith("00000003")
        restored = checkpoint.restore_params(logdir, map_location="cuda")
        moved = 0
        for key, saved in at_save.items():
            assert torch.equal(restored[key], saved), f"{key} is not the state at save"
            moved += int(not torch.equal(model.params[key], saved))
        assert moved > 0 and not torch.equal(
            model.params["encoder.layers.Dense_0.weight"],
            at_save["encoder.layers.Dense_0.weight"]), "the step after the save moved nothing"
        n_tensors = len(at_save)
        del restored, at_save
        # the round's optimizer state is the one at save as well
        flat = torch.load(os.path.join(logdir, "optimizer", "state.pt"), map_location="cpu",
                          weights_only=True, mmap=True)
        assert int(flat["count"]) == count_at_save == model.optimizer.count - 1
        del flat
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    log(f"  two synchronous saves, the weights alone {sync_s[0]:.2f} s and with the moments "
        f"{sync_s[1]:.2f} s (rounds 1 and 2, current and three stable symlinks); reloaded through load_model_from_directory to the same "
        f"validation loss {again:.6f} in {reload_s:.2f} s")
    log(f"  AsyncSaver: save blocked {blocking_s:.2f} s, the training step after it ended at "
        f"{step_done_s:.2f} s, the round was committed at {async_total_s:.2f} s; the reloaded "
        f"weights equal the state at save, and {moved} of {n_tensors} tensors have moved since")
    del model, batch
    torch.cuda.empty_cache()
    return {"sync_save_s": sync_s, "reload_s": reload_s, "async_blocking_s": blocking_s,
            "async_total_s": async_total_s, "state_gb": state_bytes / 1e9}


def persistence_single(tmp, cam_config):
    """Phase (v)'s single stream, as camera_streamer_torch.main_single_stream runs
    ``-m <seed logdir> -c --model-cache-dir <cache> --async-autosave --record-dir <rec>``, with
    a replayed clock. Returns (the model, its config, the record of the run)."""
    import numpy as np
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops import stream_score
    from trustedai_cl_vae_ad_tpu_torch.ops.stream_score import StreamScoreState
    from trustedai_cl_vae_ad_tpu_torch.stream.capture import SyntheticSource
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import (
        RECORD_STREAMS,
        load_engine_from_directory,
        record_frame_artifacts,
    )
    from trustedai_cl_vae_ad_tpu_torch.stream.run import (
        build_engine,
        configure_continual_learning,
        load_serving_model,
        resolve_camera,
        run_stream,
    )
    from trustedai_cl_vae_ad_tpu_torch.train import checkpoint
    from trustedai_cl_vae_ad_tpu_torch.utils.metrics import MetricsWriter

    seed_dir, cache, rec = (os.path.join(tmp, name) for name in ("seed", "cache", "rec"))
    model, config, qparams = load_serving_model(seed_dir, None, "cuda", continual_learning=True)
    assert qparams is None and model.optimizer is None  # the seed logdir holds no moments
    shutil.rmtree(seed_dir)  # disk: at most one round of the cache and one snapshot at a time
    anomaly_settings, cam_info, _fps, _spec = resolve_camera(cam_config)
    metrics = MetricsWriter(os.path.join(cache, "metrics"), use_tensorboard=False)
    engine = build_engine(model, config, anomaly_settings=anomaly_settings, cam_info=cam_info,
                          metrics=metrics, continuous_learning_period_ms=CL_PERIOD_MS,
                          model_cache_dir=cache, autosave_period_s=PERSIST_AUTOSAVE_S,
                          async_autosave=True)
    configure_continual_learning(engine, continual_learning=True, model_dir=None,
                                 log=lambda m: None)
    os.makedirs(rec)
    engine.begin_recording(rec)

    at = {"frame": None}
    saves = []
    save = engine.save_model_to_dir

    def spy(model_dir, saver=None):
        """Clones of the state at each autosave (on the card), then the save, timed."""
        if model_dir == cache:
            saves.clear()
            opt = model.optimizer.state_dict()
            with torch.no_grad():
                saves.append({"frame": at["frame"], "count": opt["count"],
                              "params": {k: v.clone() for k, v in model.params.items()},
                              "mu": {k: v.clone() for k, v in opt["mu"].items()},
                              "nu": {k: v.clone() for k, v in opt["nu"].items()}})
        t0 = time.perf_counter()
        out = save(model_dir, saver=saver)
        if model_dir == cache:
            saves[-1]["s"] = time.perf_counter() - t0
        return out

    engine.save_model_to_dir = spy

    def clock(n):
        at["frame"] = n
        return (n + 1) / CL_FPS

    rows = []
    reset_scorer_counts(stream_score)
    t0 = time.perf_counter()
    summary = run_stream(
        engine, SyntheticSource(n_frames=CL_FRAMES, anomaly_frames=range(40, 44), seed=0),
        on_result=lambda r: rows.append((r.tag, r.cl_stepped, len(engine.anomaly_score_map),
                                         dict(engine.timings))),
        clock=clock, log=lambda m: None)
    run_s = time.perf_counter() - t0  # the loop, the recording snapshot and the drain
    metrics.close()
    launches = scorer_counts(stream_score, CL_FRAMES)
    assert summary["frames"] == CL_FRAMES == len(rows), summary
    stepped = [tag for tag, cl, _n, _t in rows if cl]
    assert stepped == [20, 41, 62] and engine.cl_epochs == 3, stepped
    assert len(saves) == 1 and saves[0]["frame"] == 39 and saves[0]["count"] == 1, [
        (s["frame"], s["count"]) for s in saves]
    assert not engine.recording_flag and engine._async_saver is None

    # the recording: five streams of equal counts, every recorded frame annotated
    (inst,) = os.listdir(rec)
    inst = os.path.join(rec, inst)
    counts = {sub: len(os.listdir(os.path.join(inst, sub))) for sub in RECORD_STREAMS}
    recorded = [tag for (tag, _cl, n, _t), prev in zip(rows, [(0, 0, 0, 0)] + rows) if n > prev[2]]
    assert set(counts.values()) == {len(recorded)} and recorded == [9, 19, 29, 39, 49, 59], (
        counts, recorded)
    with open(os.path.join(inst, "labels.json")) as f:
        labels = json.load(f)
    names = {im["file_name"] for im in labels["images"]}
    assert len(names) == len(labels["annotations"]) == len(recorded)
    assert {list(a)[0] for a in labels["annotations"]} == names
    assert checkpoint.has_optimizer(os.path.join(inst, "model"))  # the synchronous snapshot
    shutil.rmtree(os.path.join(inst, "model"))

    # the cache: one committed round after the drain, the state at the autosave bit for bit
    assert [n for n, _ in checkpoint._complete_rounds(os.path.join(cache, "rounds"))] == [1]
    assert checkpoint.resolve_round_dir(cache).endswith(os.path.join("rounds", "00000001"))
    t0 = time.perf_counter()
    reloaded = load_engine_from_directory(cache, device="cuda", anomaly_settings=anomaly_settings)
    reload_s = time.perf_counter() - t0
    saved = saves[0]
    opt = reloaded.model.optimizer.state_dict()
    assert opt["count"] == saved["count"] and reloaded.cam_info == cam_info
    for key, v in saved["params"].items():
        assert torch.equal(reloaded.model.params[key], v), key
        assert torch.equal(opt["mu"][key], saved["mu"][key]), key
        assert torch.equal(opt["nu"][key], saved["nu"][key]), key
    moved = sum(not torch.equal(model.params[k], v) for k, v in saved["params"].items())
    assert moved > 0, "the CL steps after the autosave moved nothing"

    # the reloaded engine scores a fixed frame as the original does at the saved state
    with torch.no_grad():
        for key, v in saved["params"].items():
            model.params[key].copy_(v)
    del saves[:], saved, opt
    engine.enable_cont_learning = False
    engine.model_cache_dir = None
    maps, scalars = engine.score_state.maps.clone(), engine.score_state.scalars.clone()
    fixed = SyntheticSource(n_frames=1, anomaly_frames=range(1), seed=9).read()
    scored = []
    for e in (engine, reloaded):
        e.score_state = StreamScoreState(maps.clone(), scalars.clone())
        r = e.process_frame(fixed, now=1000.0)
        scored.append((r.score, r.pixel_count, r.norm_err_u8, r.reconstruction_u8))
    (s0, c0, n0, r0), (s1, c1, n1, r1) = scored
    assert (s0 == s1 or (np.isnan(s0) and np.isnan(s1))) and c0 == c1, scored
    assert np.array_equal(n0, n1) and np.array_equal(r0, r1)
    del reloaded
    torch.cuda.empty_cache()

    # one synchronous autosave (the override on a clean model), timed on its frame
    del engine.save_model_to_dir  # the spy: no clones in this timing
    engine.model_cache_dir = cache
    engine.async_autosave = False
    engine.schedule_model_save_override()
    t0 = time.perf_counter()
    engine.process_frame(fixed, now=1001.0)
    sync_s = time.perf_counter() - t0
    assert not engine.model_changed_flag
    assert [n for n, _ in checkpoint._complete_rounds(os.path.join(cache, "rounds"))] == [2]
    shutil.rmtree(cache)

    # the host's share of a recording tick: the five PNGs of host arrays, no device fetch
    scratch = os.path.join(tmp, "png")
    for sub in RECORD_STREAMS:
        os.makedirs(os.path.join(scratch, sub))
    rng = np.random.RandomState(0)
    host = (fixed, rng.randint(0, 256, (engine.height, engine.width), dtype=np.uint8),
            rng.randint(0, 256, (engine.height, engine.width, engine.channels), dtype=np.uint8))
    png_ms = []
    for i in range(5):
        t0 = time.perf_counter()
        record_frame_artifacts(scratch, f"{i}.png", *host, engine.height, engine.width)
        png_ms.append((time.perf_counter() - t0) * 1e3)
    shutil.rmtree(scratch)

    lat = np.array(summary["latencies_ms"])
    tags = [tag for tag, *_ in rows]
    is_rec = np.array([t in recorded for t in tags])
    busy = np.array([t in stepped or t == 39 or t < 2 for t in tags])
    plain = lat[~busy & ~is_rec]
    rec_ms = lat[is_rec & ~busy]
    record_s = np.array([tm["record_s"] for (tag, _c, _n, tm) in rows])
    result = {
        "launches": launches, "async_blocking_s": float(lat[tags.index(39)]) / 1e3,
        "sync_blocking_s": sync_s, "reload_s": reload_s, "run_s": run_s,
        "frame_p50_ms": float(np.percentile(plain, 50)),
        "frame_p95_ms": float(np.percentile(plain, 95)),
        "recording_added_ms": float(np.median(rec_ms) - np.percentile(plain, 50)),
        "record_s_recording_ms": float(np.median(record_s[is_rec & ~busy]) * 1e3),
        "record_s_plain_ms": float(np.median(record_s[~busy & ~is_rec]) * 1e3),
        "cl_frame_ms": [float(lat[tags.index(t)]) for t in stepped],
        "record_host_ms": float(np.median(png_ms)),
    }
    log(f"  {CL_FRAMES} frames at {CL_FPS:g} frames/s on the replayed clock: CL steps in frames "
        f"{stepped}, one async autosave in frame 39 (of the state after the step of frame 20), "
        f"recordings in frames {recorded}; kernel launches {launches}")
    log(f"  the frame that carried the async autosave took {result['async_blocking_s']:.3f} s; "
        f"one synchronous autosave (override) {sync_s:.3f} s; frames without CL, autosave or "
        f"recording p50 {result['frame_p50_ms']:.3f} ms, p95 {result['frame_p95_ms']:.3f} ms; "
        f"recording frames median {float(np.median(rec_ms)):.3f} ms (+"
        f"{result['recording_added_ms']:.3f} ms; timings['record_s'] "
        f"{result['record_s_recording_ms']:.3f} vs {result['record_s_plain_ms']:.3f} ms; "
        f"record_frame_artifacts on host arrays {result['record_host_ms']:.3f} ms); "
        f"frames with a CL step {[round(v, 1) for v in result['cl_frame_ms']]} ms")
    log(f"  the loop with the recording snapshot and the drain {run_s:.2f} s; the cache round "
        f"committed at the drain; load_engine_from_directory {reload_s:.2f} s restored "
        f"parameters and moments equal bit for bit to the state at the autosave, and scored a "
        f"fixed frame with the original's bits (score {s0}, count {c0})")
    del engine
    return model, config, result


def persistence_fleet(tmp, model, config):
    """Phase (v)'s fleet, as camera_streamer_torch.main_all_cameras runs ``--all-cameras -c
    --record-dir <rec>`` with FLEET_STREAMS synthetic cameras (the last dropping every
    DROP_EVERY-th tick), a ring of FLEET_CL_RING ticks and a replayed clock."""
    import numpy as np
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops import stream_score
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import RECORD_STREAMS
    from trustedai_cl_vae_ad_tpu_torch.stream.multicam import MultiCameraEngine
    from trustedai_cl_vae_ad_tpu_torch.stream.run import (
        configure_continual_learning,
        run_all_cameras,
    )
    from trustedai_cl_vae_ad_tpu_torch.train import checkpoint

    rec = os.path.join(tmp, "fleet_rec")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine = MultiCameraEngine(model, config, n_streams=FLEET_STREAMS,
                               continuous_learning_period_ms=CL_PERIOD_MS,
                               cl_ring_ticks=FLEET_CL_RING,
                               model_cache_dir=os.path.join(tmp, "fleet_cache"))
    configure_continual_learning(engine, continual_learning=True, log=lambda m: None)
    os.makedirs(rec)
    names = [f"synthetic{i}" for i in range(FLEET_STREAMS)]
    inst = engine.begin_recording(rec, names=names)
    fixed = torch.full((1, engine.height, engine.width, engine.channels), 0.5, device="cuda")
    watched = ("decoder.layers.ConvTranspose_2.bias", "encoder.layers.Dense_0.weight")

    def snapshot():
        with torch.inference_mode():
            out = engine._forward(engine._serve_params, fixed).clone()
        return out, {k: model.params[k].flatten()[:4096].clone() for k in watched}

    rec0, params0 = snapshot()
    steps = []
    do_step = engine._do_cl_step

    def timed_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = do_step()  # its loss fetch waits for the device
        steps.append((time.perf_counter() - t0, loss))
        return loss

    engine._do_cl_step = timed_step
    reset_scorer_counts(stream_score)
    t0 = time.perf_counter()
    summary = run_all_cameras(engine, fleet_readers(FLEET_STREAMS, FLEET_CL_TICKS), names,
                              clock=lambda n: (n + 1) / CL_FPS, log=lambda m: None)
    run_s = time.perf_counter() - t0  # the ticks, the fleet snapshot and the drain
    launches = scorer_counts(stream_score, FLEET_CL_TICKS)
    peak = torch.cuda.max_memory_allocated()
    assert summary["ticks"] == FLEET_CL_TICKS, summary
    assert len(steps) >= 1 and engine.cl_epochs == len(steps), steps
    assert all(np.isfinite(v) for _s, loss in steps for v in loss.values()), steps
    rec1, params1 = snapshot()
    assert all(not torch.equal(params0[k], params1[k]) for k in watched), "parameters unchanged"
    rec_change = float((rec1 - rec0).abs().max())
    assert rec_change > 1e-4, rec_change
    per_camera = {}
    for name in names:
        counts = {sub: len(os.listdir(os.path.join(inst, name, sub))) for sub in RECORD_STREAMS}
        assert len(set(counts.values())) == 1, (name, counts)
        with open(os.path.join(inst, name, "labels.json")) as f:
            labels = json.load(f)
        assert len(labels["images"]) == len(labels["annotations"]) == counts["frames"] > 0, name
        per_camera[name] = counts["frames"]
    assert checkpoint.has_optimizer(os.path.join(inst, "model"))  # ONE snapshot for the fleet
    step_ms = [round(s * 1e3, 1) for s, _ in steps]
    log(f"  {FLEET_STREAMS} cameras x {FLEET_CL_TICKS} ticks at {CL_FPS:g} ticks/s, ring of "
        f"{FLEET_CL_RING} ticks ({FLEET_CL_RING * FLEET_STREAMS} rows): {len(steps)} fleet CL "
        f"step(s) of {step_ms} ms, losses {[round(l['loss'], 6) for _s, l in steps]}; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB; max |reconstruction change| "
        f"{rec_change:.3g}; recorded frames per camera {sorted(set(per_camera.values()))}; "
        f"tick p50 {summary['p50_ms']:.3f} ms; kernel launches {launches}; the run with the "
        f"fleet snapshot {run_s:.2f} s")
    del engine
    torch.cuda.empty_cache()
    return {"launches": launches, "cl_step_ms": step_ms, "peak_gib": peak / 2**30,
            "tick_p50_ms": summary["p50_ms"], "run_s": run_s}


def phase_v():
    """The live application's persistence, recording and fleet continual learning at the
    flagship: the seed log directory (the weights, saved synchronously), the single stream
    with its async autosave, recording and reload, one synchronous autosave, then the fleet.
    Every save goes to one temporary directory, which ``TCVAE_CKPT_KEEP_ROUNDS=1`` holds to
    one round of the cache and one snapshot at a time."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.config import save_config
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config_path

    torch.cuda.empty_cache()
    keep = os.environ.get("TCVAE_CKPT_KEEP_ROUNDS")
    os.environ["TCVAE_CKPT_KEEP_ROUNDS"] = "1"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_persist_")
    try:
        model, config = load_model_from_config_path(os.path.join(REPO, "configs", "config.yml"),
                                                    seed=0, device="cuda")
        seed_dir = os.path.join(tmp, "seed")
        t0 = time.perf_counter()
        model.save_model(seed_dir)
        save_config(config, os.path.join(seed_dir, "config.yml"))
        seed_s = time.perf_counter() - t0
        log(f"  seed log directory (the weights alone) saved in {seed_s:.2f} s; "
            f"{shutil.disk_usage(tmp).free / 1e9:.0f} GB free under the temporary directory")
        del model
        torch.cuda.empty_cache()
        model, config, single = persistence_single(
            tmp, os.path.join(REPO, "configs", "cam_config.yml"))
        fleet = persistence_fleet(tmp, model, config)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if keep is None:
            os.environ.pop("TCVAE_CKPT_KEEP_ROUNDS", None)
        else:
            os.environ["TCVAE_CKPT_KEEP_ROUNDS"] = keep
    return {"single": single, "fleet": fleet, "seed_save_s": seed_s}


SERVE_IMAGES, SERVE_C1, SERVE_C16, SERVE_CLIENTS, SERVE_RECONSTRUCT = 32, 64, 128, 16, 8
OFFLINE_TRAIN, OFFLINE_EVAL = 512, 256
# (M, K, N) of the two quantized Dense layers at the offline batch (training.batch_size)
OFFLINE_SHAPES = [(256, 268800, 4000), (256, 2000, 134400)]
# a w8a8 frame's eps against the float one's, relative. At random weights eps is almost all
# data term, so this is set from the readings, not from a test's tiny model: served and
# offline frames read below 1e-6 on the H100 (w8a8 moves a reconstruction by about 1e-4,
# phase (o), and its signs do not follow the frame's residual), while a Dense layer dropped
# or garbled moves the reconstructions by tenths and eps by tens of percent. The model's part
# is also checked alone: the w8a8 server's /reconstruct images within one grey level of the
# float forward's.
W8A8_EPS_RTOL = 1e-4


def reset_int8_counts(int8_gemm):
    int8_gemm.launches = 0
    for arrangement in int8_gemm.int8_gemm_arrangements:
        int8_gemm.int8_gemm_arrangements[arrangement] = 0


def plain_int8_partials(quant, int8_gemm, checks):
    """A stand-in for ``quant._int8_partials``: the kernel's chunk products and the plain
    version's, asserted equal (counted in ``checks``); returns the plain version's."""
    import torch

    def partials(x_i8, k_i8):
        got = int8_gemm.int8_gemm_chunked(x_i8, k_i8, quant._I32_SAFE_K)
        ref = int8_gemm.int8_gemm_chunked_reference(x_i8, k_i8, quant._I32_SAFE_K)
        assert torch.equal(got, ref), "the int8 kernel's partials differ from the plain version"
        checks.append(tuple(x_i8.shape))
        return list(ref.unbind(0))
    return partials


def smooth_frames(rng, n, h, w, c):
    """n uint8 frames that compress as camera frames do: a field of 8x8 blocks plus a
    little noise (uniform noise is the worst case of PNG's zlib)."""
    import numpy as np

    coarse = rng.uniform(0, 255, (n, h // 8 + 1, w // 8 + 1, c))
    field = np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2)[:, :h, :w]
    return np.clip(field + rng.normal(0, 6, (n, h, w, c)), 0, 255).astype(np.uint8)


def serve_images(h, w, c, n, seed=0):
    """n distinct frames (``smooth_frames``, so their PNGs stay small) and their PNG
    bytes."""
    import io

    import numpy as np
    from PIL import Image

    frames = smooth_frames(np.random.RandomState(seed), n, h, w, c)
    bodies = []
    for frame in frames:
        buf = io.BytesIO()
        Image.fromarray(frame).save(buf, format="PNG")
        bodies.append(buf.getvalue())
    return frames, bodies


# the load generator of phase (w): a process of its own, so that its threads do not share the
# server's interpreter lock. argv[1] is a JSON spec: url, path, clients, per_client, bodies (PNG
# files); each client thread first reads /healthz untimed (a thread's first urlopen takes
# hundreds of ms), all wait at a barrier, then client c sends per_client requests one after
# another, of bodies (c * per_client + j) mod len(bodies). Prints {"results": [[body, ms,
# answer], ...], "errors": [...]}, answer the eps of /score or the PNG file of /reconstruct.
SERVE_CLIENT = r"""
import json, os, sys, threading, time, urllib.request
spec = json.load(open(sys.argv[1]))
bodies = [open(p, "rb").read() for p in spec["bodies"]]
results, errors, lock = [], [], threading.Lock()
start = threading.Barrier(spec["clients"])
def client(c):
    try:
        with urllib.request.urlopen(spec["url"] + "/healthz", timeout=120) as r:
            r.read()
        start.wait(timeout=120)
        for j in range(spec["per_client"]):
            i = (c * spec["per_client"] + j) % len(bodies)
            req = urllib.request.Request(spec["url"] + spec["path"], data=bodies[i], method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=120) as r:
                body = r.read()
            ms = (time.perf_counter() - t0) * 1e3
            if spec["path"] == "/score":
                answer = json.loads(body)["reconstruction_error"]
            else:
                answer = os.path.join(spec["out_dir"], f"{c}_{j}.png")
                with open(answer, "wb") as f:
                    f.write(body)
            with lock:
                results.append([i, ms, answer])
    except Exception as e:
        errors.append(repr(e))
threads = [threading.Thread(target=client, args=(c,)) for c in range(spec["clients"])]
for t in threads:
    t.start()
for t in threads:
    t.join()
print(json.dumps({"results": results, "errors": errors}))
"""


def drive_server(srv, body_files, out_dir):
    """Phase (w)'s requests against a running server from a client process: SERVE_C1
    /score one at a time, SERVE_C16 from SERVE_CLIENTS threads at once, SERVE_RECONSTRUCT
    /reconstruct. Per run: the clients' latencies, the server's own (decode, queue, batch),
    the batches and their fill from the batcher's counters. Returns (record, score answers
    [(image, eps)], reconstructions [(image, uint8 array)])."""
    import numpy as np
    from PIL import Image

    url = f"http://127.0.0.1:{srv.server_address[1]}"
    batcher, metrics = srv.batcher, srv.metrics

    def counters():
        with batcher._stats_lock:
            return (batcher.batches_dispatched, batcher.items_scored, batcher.batch_errors,
                    dict(batcher.bucket_counts))

    def run(name, path, clients, per_client):
        spec_path = os.path.join(out_dir, f"{name}.json")
        with open(spec_path, "w") as f:
            json.dump({"url": url, "path": path, "clients": clients, "per_client": per_client,
                       "bodies": body_files, "out_dir": out_dir}, f)
        before, server_ms = counters(), len(metrics._lat_ms)
        proc = subprocess.run([sys.executable, "-c", SERVE_CLIENT, spec_path],
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        assert not got["errors"] and len(got["results"]) == clients * per_client, got["errors"]
        after = counters()
        lat = [ms for _i, ms, _a in got["results"]]
        handled = list(metrics._lat_ms)[server_ms:]
        buckets = {k: after[3].get(k, 0) - before[3].get(k, 0) for k in after[3]}
        record[name] = {
            "requests": len(lat), "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "server_p50_ms": float(np.percentile(handled, 50)),
            "server_p95_ms": float(np.percentile(handled, 95)),
            "batches": after[0] - before[0],
            "mean_batch_fill": (after[1] - before[1]) / (after[0] - before[0]),
            "bucket_counts": {k: v for k, v in sorted(buckets.items()) if v}}
        assert after[2] == before[2], "a batch failed"
        return got["results"]

    record = {}
    answers = [(i, a) for i, _ms, a in run("c1", "/score", 1, SERVE_C1)]
    answers += [(i, a) for i, _ms, a in run("c16", "/score", SERVE_CLIENTS,
                                            SERVE_C16 // SERVE_CLIENTS)]
    recs = []
    for i, _ms, png in run("reconstruct", "/reconstruct", 1, SERVE_RECONSTRUCT):
        with Image.open(png) as img:
            recs.append((i, np.asarray(img)))
    return record, answers, recs


def serve_surface(logdir, quantize, body_files, plain_eps, plain_rec, out_dir):
    """One server of ``logdir`` through serve_torch.build_server on the card, driven by
    ``drive_server``; every eps against the plain version: the float forward's eps of the
    same image (float), or the same bucket batch through the w8a8 forward whose int8
    products are the plain version's and the float forward's eps (w8a8); reconstructions of
    both within one grey level of the plain float forward's. Returns the record."""
    import gc
    import threading

    import numpy as np
    import torch

    import serve_torch
    from trustedai_cl_vae_ad_tpu_torch.models.cvae import normalize_image_input
    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm, quant

    gib = 2.0 ** 30
    gc.collect()  # the previous server's handler class holds its batcher in a cycle
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    srv = serve_torch.build_server(logdir, port=0, max_batch=16, device="cuda",
                                   quantize=quantize)
    boot_s = time.perf_counter() - t0
    batcher = srv.batcher
    assert batcher.quantized == quantize and (batcher.model.params is None) == quantize
    dispatched = []  # (bucket batch, eps, host ms of the dispatch) of every batch
    dispatch = batcher._dispatch

    def recording(batch, want_rec):
        t0 = time.perf_counter()
        eps, rec = dispatch(batch, want_rec)  # ends in the host fetch of eps (and rec)
        dispatched.append((batch, eps, (time.perf_counter() - t0) * 1e3))
        return eps, rec

    batcher._dispatch = recording
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_int8_counts(int8_gemm)
        record, answers, recs = drive_server(srv, body_files, out_dir)
        torch.cuda.synchronize()
        launches = dict(int8_gemm.int8_gemm_arrangements)
        assert int8_gemm.launches == sum(launches.values())
        peak = torch.cuda.max_memory_allocated() - base
        assert len(dispatched) == sum(record[run]["batches"] for run in
                                      ("c1", "c16", "reconstruct"))
        # 2 launches a w8a8 batch (the encoder's and the decoder's Dense), all on the tensor
        # cores at the flagship's shapes; none in float
        assert launches == {"mma": 2 * len(dispatched) if quantize else 0, "cuda_core": 0}, (
            launches, len(dispatched))
        # the same dispatch with the server idle, from this thread: what a batch costs when no
        # handler thread competes for the interpreter lock
        quiet = {}
        with batcher._device_context():
            for b in batcher.BUCKETS:
                batch = np.zeros((b, *batcher.hwc), np.uint8)
                times = []
                for _ in range(6):
                    t0 = time.perf_counter()
                    dispatch(batch, False)
                    times.append((time.perf_counter() - t0) * 1e3)
                quiet[b] = float(np.median(times[1:]))
        record["quiet_dispatch_ms_by_bucket"] = quiet
    finally:
        srv.shutdown()
        batcher.close()
        srv.server_close()
        thread.join(timeout=60)
    by_bucket = {}
    for batch, _eps, ms in dispatched:
        by_bucket.setdefault(batch.shape[0], []).append(ms)
    record["dispatch_ms_by_bucket"] = {b: float(np.median(v))
                                       for b, v in sorted(by_bucket.items())}
    worst = 0.0
    if quantize:
        # every batch again, through the same forward with the plain int8 products (asserted
        # equal to the kernel's): equal int32 sums, so equal eps up to float32 rounding
        checks = []
        partials = quant._int8_partials
        quant._int8_partials = plain_int8_partials(quant, int8_gemm, checks)
        try:
            with torch.inference_mode():
                for batch, eps, _ms in dispatched:
                    x = normalize_image_input(torch.from_numpy(batch).to("cuda"))
                    x_hat = batcher._forward(batcher._serve_params, x)
                    ref = ((x - x_hat) ** 2).sum(dim=3).sum(dim=(1, 2)).cpu().numpy()
                    worst = max(worst, float(np.max(np.abs(eps - ref) / ref)))
                    np.testing.assert_allclose(eps, ref, rtol=1e-5)
        finally:
            quant._int8_partials = partials
        assert len(checks) == 2 * len(dispatched), (len(checks), len(dispatched))
        record["w8a8_vs_float_max_rel"] = max(abs(e - plain_eps[i]) / plain_eps[i]
                                              for i, e in answers)
        assert record["w8a8_vs_float_max_rel"] < W8A8_EPS_RTOL, record["w8a8_vs_float_max_rel"]
    else:
        worst = max(abs(e - plain_eps[i]) / plain_eps[i] for i, e in answers)
        assert worst < 1e-5, worst
    rec_gap = 0
    for i, rec in recs:  # rounding at .5 may go either way
        assert rec.shape == plain_rec[i].shape and rec.dtype == np.uint8
        rec_gap = max(rec_gap, int(np.abs(rec.astype(np.int16) - plain_rec[i]).max()))
    assert rec_gap <= 1, rec_gap
    record["reconstruct_max_grey_levels_off_float"] = rec_gap
    record.update(boot_s=boot_s, peak_gib=peak / gib, launches=launches,
                  eps_max_rel_err=worst, batches_checked=len(dispatched))
    label = "w8a8 (int8 sidecar boot)" if quantize else "float"
    c1, c16, rc = record["c1"], record["c16"], record["reconstruct"]
    log(f"  server {label}: booted and warmed in {boot_s:.1f} s; /score at concurrency 1: p50 "
        f"{c1['p50_ms']:.3f} ms p95 {c1['p95_ms']:.3f} ms (in the server p50 "
        f"{c1['server_p50_ms']:.3f} ms); at concurrency {SERVE_CLIENTS}: p50 "
        f"{c16['p50_ms']:.3f} ms p95 {c16['p95_ms']:.3f} ms (in the server p50 "
        f"{c16['server_p50_ms']:.3f} ms), {c16['batches']} batches, mean batch fill "
        f"{c16['mean_batch_fill']:.3f}, buckets {c16['bucket_counts']}; /reconstruct p50 "
        f"{rc['p50_ms']:.3f} ms; a batch's dispatch (upload, forward, fetch), median ms by "
        f"bucket {record['dispatch_ms_by_bucket']}, with the server idle "
        f"{record['quiet_dispatch_ms_by_bucket']}; peak {peak / gib:.2f} GiB above the "
        f"{base / gib:.2f} GiB resident before; int8 launches {launches}; every eps within "
        f"{worst:.3g} (relative) of the plain version's"
        + (f", and within {record['w8a8_vs_float_max_rel']:.3g} of the float forward's "
           f"(allowed {W8A8_EPS_RTOL})" if quantize else "")
        + f"; /reconstruct within {rec_gap} grey level(s) of the float forward's")
    return record


def offline_surface(logdir, eval_dir, out_dir, quantize):
    """do_anomaly_detection_torch.py's main on the card: pass 1 over the model's training
    set, pass 2 over ``eval_dir``; each pass timed (frames/s), its peak memory and its int8
    launches read. Returns (record, data_scale)."""
    import numpy as np
    import torch

    import do_anomaly_detection_torch
    from trustedai_cl_vae_ad_tpu_torch.anomaly import offline
    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm

    gib = 2.0 ** 30
    record = {}

    def timed(name, fn, frames):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_int8_counts(int8_gemm)
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)  # ends in host fetches of its results
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            record[name] = {"s": seconds, "frames_per_s": frames / seconds,
                            "peak_gib": torch.cuda.max_memory_allocated() / gib,
                            "launches": dict(int8_gemm.int8_gemm_arrangements)}
            return result
        return run

    scale_fn, eval_fn = offline.get_data_scale, offline.evaluate_anomalies
    offline.get_data_scale = timed("pass1", scale_fn, OFFLINE_TRAIN)
    offline.evaluate_anomalies = timed("pass2", eval_fn, OFFLINE_EVAL)
    argv = ["-m", logdir, "-d", eval_dir, "-o", out_dir, "--device", "cuda"]
    if quantize:
        argv += ["--quantize", "--histogram-only"]
    try:
        t0 = time.perf_counter()
        scale, results = do_anomaly_detection_torch.main(argv)
        record["cli_s"] = time.perf_counter() - t0
    finally:
        offline.get_data_scale, offline.evaluate_anomalies = scale_fn, eval_fn
    assert scale["z_scores"].shape == (OFFLINE_TRAIN,) and np.isfinite(scale["z_scores"]).all()
    assert results["z_scores"].shape == (OFFLINE_EVAL,)
    assert np.isfinite(results["z_scores"]).all()
    batches = {"pass1": OFFLINE_TRAIN // BATCH, "pass2": OFFLINE_EVAL // BATCH}
    for name, n in batches.items():
        assert record[name]["launches"] == {"mma": 2 * n if quantize else 0, "cuda_core": 0}, (
            name, record[name]["launches"])
    listing = sorted(os.listdir(out_dir))
    if quantize:
        assert listing == ["anomaly_fig.png"], listing
    else:
        assert listing == ["anomaly_fig.png", "anomaly_list.csv", "err", "heatmap", "orig",
                           "overlay", "rec"], listing
        assert len(os.listdir(os.path.join(out_dir, "overlay"))) == OFFLINE_EVAL
    label = "w8a8 (int8 sidecar boot), --histogram-only" if quantize else "float, with artifacts"
    log(f"  offline {label}: pass 1 {OFFLINE_TRAIN} frames in {record['pass1']['s']:.2f} s "
        f"({record['pass1']['frames_per_s']:.1f} frames/s, peak "
        f"{record['pass1']['peak_gib']:.2f} GiB, int8 launches {record['pass1']['launches']}); "
        f"pass 2 {OFFLINE_EVAL} frames in {record['pass2']['s']:.2f} s "
        f"({record['pass2']['frames_per_s']:.1f} frames/s, peak "
        f"{record['pass2']['peak_gib']:.2f} GiB, int8 launches {record['pass2']['launches']}); "
        f"the CLI {record['cli_s']:.1f} s; meu {scale['meu']:.6g} sigma {scale['sigma']:.6g}")
    return record, scale


def offline_batch_check(logdir, train_dir, scale_q):
    """One offline batch of 256 training frames through the w8a8 forward of the int8
    sidecar with the kernel, then with the plain int8 products (asserted equal): eps at rtol
    1e-5, and against the CLI's pass-1 eps of those frames."""
    import numpy as np
    import torch

    from trustedai_cl_vae_ad_tpu_torch.anomaly.offline import _score_fns
    from trustedai_cl_vae_ad_tpu_torch.data.saved_dataset import SavedDataset
    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm, quant

    model, _config = quant.load_int8_serving_model(logdir, device="cuda", log=lambda m: None)
    batch_err, _, place, params = _score_fns(model, quantize=True, score_params=model.qparams)
    x, n = place(next(iter(SavedDataset(train_dir, BATCH)))["image"])
    got = batch_err(params, x)[0].cpu().numpy()
    checks = []
    partials = quant._int8_partials
    quant._int8_partials = plain_int8_partials(quant, int8_gemm, checks)
    try:
        ref = batch_err(params, x)[0].cpu().numpy()
    finally:
        quant._int8_partials = partials
    assert len(checks) == 2 and checks[0][0] == BATCH, checks
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    cli = scale_q["z_scores"][:n].astype(np.float64) * scale_q["sigma"] + scale_q["meu"]
    np.testing.assert_allclose(got, cli, rtol=1e-5)
    err = float(np.max(np.abs(got - ref) / ref))
    log(f"  one offline w8a8 batch of {n}: the kernel's int32 products equal the plain "
        f"version's; eps within {err:.3g} (relative) of the plain forward's and within "
        f"{float(np.max(np.abs(got - cli) / cli)):.3g} of the CLI's pass 1")
    return err


def int8_offline_shapes(dev):
    """Kernel 10 at the offline batch's two shapes: equal to the plain version, timed (the
    rule's mma and the CUDA-core arrangement on the same operands) beside torch._int_mm
    (a call a chunk, the weights as a transposed view) and the bound."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm as ig
    from trustedai_cl_vae_ad_tpu_torch.ops.quant import _I32_SAFE_K

    rows = []
    for m, k, n in OFFLINE_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(m + n)
        x = torch.randint(-127, 128, (m, k), device=dev, generator=gen,
                          dtype=torch.int32).to(torch.int8)
        w = torch.randint(-127, 128, (n, k), device=dev, generator=gen,
                          dtype=torch.int32).to(torch.int8)
        assert ig.int8_gemm_arrangement(x, w, 0, k, _I32_SAFE_K) == "mma", (m, k, n)
        got = ig._launch("mma", x, w, 0, k, _I32_SAFE_K)
        ref = ig.int8_gemm_chunked_reference(x, w, _I32_SAFE_K)
        assert torch.equal(got, ref), (m, k, n)
        mma = lambda: ig._launch("mma", x, w, 0, k, _I32_SAFE_K)  # noqa: E731
        cuda_core = lambda: ig._launch("cuda_core", x, w, 0, k, _I32_SAFE_K)  # noqa: E731
        parts = [(x[:, s:s + _I32_SAFE_K].contiguous(), w[:, s:s + _I32_SAFE_K].contiguous())
                 for s in range(0, k, _I32_SAFE_K)]
        lib = lambda: [torch._int_mm(a, b.t()) for a, b in parts]  # noqa: E731
        assert torch.equal(torch.stack(lib()), got), "torch._int_mm disagrees"
        bound_ms, bound_by = int8_bound(m, k, n)
        row = {"shape": [m, k, n], "chunks": len(parts), "ms": median_ms(mma),
               "device_ms": queued_ms(mma), "cuda_core_device_ms": queued_ms(cuda_core, runs=10),
               "library_ms": median_ms(lib), "library_device_ms": queued_ms(lib),
               "plain_ms": median_ms(lambda: ig.int8_gemm_chunked_reference(x, w, _I32_SAFE_K),
                                     runs=5, warmup=1),
               "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": 0.0}
        rows.append(row)
        log(f"  kernel 10 at ({m}, {k}, {n}), {len(parts)} chunks: mma {row['ms']:.4f} ms "
            f"({row['device_ms']:.4f} b2b, {bound_ms / row['device_ms']:.1%} of the bound), "
            f"cuda_core b2b {row['cuda_core_device_ms']:.4f} ms, torch._int_mm "
            f"{row['library_ms']:.4f} ms ({row['library_device_ms']:.4f} b2b), plain "
            f"{row['plain_ms']:.3f} ms, bound {bound_ms:.5f} ms ({bound_by}); equal bits")
        del x, w, parts, got, ref
    torch.cuda.empty_cache()
    return rows


def phase_w(dev):
    """The scoring surfaces at the flagship: the seeded weights saved to a temporary log
    directory with config.yml (its data section pointing at a synthetic saved dataset) and
    an int8 sidecar; serve_torch.py's server in float and from the sidecar; the offline CLI
    in float with artifacts and with --quantize --histogram-only; kernel 10 at the offline
    batch's shapes."""
    import numpy as np
    import torch

    from trustedai_cl_vae_ad_tpu_torch.config import save_config
    from trustedai_cl_vae_ad_tpu_torch.data.saved_dataset import save_dataset
    from trustedai_cl_vae_ad_tpu_torch.ops import quant
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config_path

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_scoring_")
    out = {}
    try:
        model, config = load_model_from_config_path(os.path.join(REPO, "configs", "config.yml"),
                                                    seed=0, device="cuda")
        h, w, c = config["data"]["image_size"]
        assert int(config["training"]["batch_size"]) == BATCH
        train_dir, eval_dir = os.path.join(tmp, "train_ds"), os.path.join(tmp, "eval_ds")
        t0 = time.perf_counter()
        for path, n, seed in ((train_dir, OFFLINE_TRAIN, 1), (eval_dir, OFFLINE_EVAL, 2)):
            rng = np.random.RandomState(seed)
            save_dataset(path, ({"image": smooth_frames(rng, BATCH, h, w, c),
                                 "filepath": [f"{seed}/{b}/{i}" for i in range(BATCH)]}
                                for b in range(n // BATCH)))
        config["data"] = dict(config["data"], dataset_path=train_dir)
        logdir = os.path.join(tmp, "model")
        model.save_model(logdir, include_optimizer=False)
        save_config(config, os.path.join(logdir, "config.yml"))
        quant.save_quantized_checkpoint(logdir, quant.quantize_params(model.core, model.params))
        log(f"  log directory (weights, config.yml, int8 sidecar) and saved datasets of "
            f"{OFFLINE_TRAIN} + {OFFLINE_EVAL} frames written in {time.perf_counter() - t0:.1f} s")

        frames, bodies = serve_images(h, w, c, SERVE_IMAGES)
        body_files = []
        for i, body in enumerate(bodies):
            body_files.append(os.path.join(tmp, f"request_{i}.png"))
            with open(body_files[-1], "wb") as f:
                f.write(body)
        with torch.inference_mode():  # the plain float forward's eps and reconstruction
            x = torch.from_numpy(frames).to("cuda").to(torch.float32) / 255.0
            x_hat = model.core(x)
            plain_eps = ((x - x_hat) ** 2).sum(dim=3).sum(dim=(1, 2)).cpu().numpy()
            plain_rec = torch.clamp(torch.round(255.0 * x_hat), 0, 255).to(
                torch.int16).cpu().numpy()
            del x, x_hat
        del model
        for quantize in (False, True):
            client_dir = os.path.join(tmp, f"client_{int(quantize)}")
            os.makedirs(client_dir)
            out["serve_w8a8" if quantize else "serve_float"] = serve_surface(
                logdir, quantize, body_files, plain_eps, plain_rec, client_dir)

        out["offline_float"], scale_f = offline_surface(logdir, eval_dir,
                                                        os.path.join(tmp, "out_float"), False)
        out["offline_w8a8"], scale_q = offline_surface(logdir, eval_dir,
                                                       os.path.join(tmp, "out_w8a8"), True)
        eps_f = scale_f["z_scores"].astype(np.float64) * scale_f["sigma"] + scale_f["meu"]
        eps_q = scale_q["z_scores"].astype(np.float64) * scale_q["sigma"] + scale_q["meu"]
        # each frame's w8a8 eps within W8A8_EPS_RTOL of its float eps, so meu is too; and
        # |std(a) - std(b)| <= std(a - b): sigma moves by no more than the frames' differences
        frame_rel = float(np.max(np.abs(eps_q - eps_f) / eps_f))
        assert frame_rel < W8A8_EPS_RTOL, frame_rel
        assert abs(scale_q["meu"] - scale_f["meu"]) <= W8A8_EPS_RTOL * scale_f["meu"]
        sigma_gap = abs(scale_q["sigma"] - scale_f["sigma"])
        assert sigma_gap <= float(np.std(eps_q - eps_f)) + 1e-5 * scale_f["meu"], sigma_gap
        out["offline_w8a8_vs_float"] = {"frame_max_rel": frame_rel, "meu_rel": abs(
            scale_q["meu"] / scale_f["meu"] - 1), "sigma_rel": sigma_gap / scale_f["sigma"]}
        log(f"  offline w8a8 vs float: frames' eps within {frame_rel:.3g} (relative; allowed "
            f"{W8A8_EPS_RTOL}), meu {scale_q['meu']:.6g} vs {scale_f['meu']:.6g}, sigma "
            f"{scale_q['sigma']:.6g} vs {scale_f['sigma']:.6g} (|difference| "
            f"{sigma_gap:.4g} <= std of the frames' differences "
            f"{float(np.std(eps_q - eps_f)):.4g})")
        out["offline_batch_err"] = offline_batch_check(logdir, train_dir, scale_q)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["offline_shapes"] = int8_offline_shapes(dev)
    out["launches_serve"] = out["serve_w8a8"]["launches"]["mma"]
    out["launches_offline"] = sum(out["offline_w8a8"][p]["launches"]["mma"]
                                  for p in ("pass1", "pass2"))
    out["s"] = time.perf_counter() - t_phase
    log(f"  phase (w) ran {out['s']:.1f} s; kernel 10 launches: serve {out['launches_serve']}, "
        f"offline {out['launches_offline']}, all mma")
    return out


# phase (x): the JAX-written log directories of tests/data/jax_logdirs. The card's machine has no
# tensorstore, so the phase reads their copies in the port's layout, which
# tools/convert_logdir_torch.py wrote and Tier-1 holds equal to the direct reads
JAX_LOGDIRS = os.path.join(REPO, "tests", "data", "jax_logdirs")
JAX_FIXTURES = {"global_f32": "global", "single_bf16": "perdim"}  # fixture -> its moments kernel
JAX_SETTINGS = {"anomaly_score_threshold": 2.0, "anomaly_score_method": "zz_count",
                "buffer_record_period_s": 1.0, "anomalous_state_period_s": 0.05}
RAITE_TRAIN, RAITE_VAL, RAITE_EPOCHS = 1024, 64, 3  # 32 training steps an epoch at batch 32


def launch_counts(stream_score, moments, int8_gemm):
    """Every counter of kernels 1, 2, 3 and 10, by the name of its entry in the kernels line."""
    counts = {"stream_score_cluster": stream_score.stream_score_arrangements["cluster"],
              "stream_score": stream_score.stream_score_arrangements["block"],
              "int8_gemm_mma": int8_gemm.int8_gemm_arrangements["mma"],
              "int8_gemm": int8_gemm.int8_gemm_arrangements["cuda_core"]}
    for op, by in moments.moments_arrangements.items():
        kind, direction = op.split("_")
        counts[f"moments_cluster_{kind}_{direction}"] = by["cluster"]
        counts[f"moments_{kind}_{direction}"] = by["blocks"]
    return counts


def reset_launch_counts(stream_score, moments, int8_gemm):
    reset_scorer_counts(stream_score)
    moments.reset_counts()
    reset_int8_counts(int8_gemm)


def moments_check(mo, kind, shape, dtype, dev):
    """One forward and backward of a moments kernel at the path's (B, L) against the plain
    versions (tolerances of phase f); returns the largest error."""
    import torch

    z = moments_operand(dev, shape, dtype, seed=3)
    fwd, bwd = ((mo.global_moments_packed, mo.global_moments_backward) if kind == "global" else
                (mo.perdim_moments_packed, mo.perdim_moments_backward))
    ref_fwd = (mo.global_moments_reference if kind == "global" else mo.perdim_moments_reference)
    ref_bwd = (mo.global_moments_backward_reference if kind == "global"
               else mo.perdim_moments_backward_reference)
    out = fwd(z)
    ref = torch.stack(ref_fwd(z))
    close_moments(out, ref)
    gout = torch.linspace(-1.0, 1.0, out.numel(), device=dev).view_as(out)
    grad, grad_ref = bwd(z, out, gout), ref_bwd(z, out, gout)
    scale = float(grad_ref.float().abs().max())
    torch.testing.assert_close(grad.float(), grad_ref.float(), rtol=1e-4, atol=1e-6 * scale)
    return max(float((out - ref).abs().max()), float((grad.float() - grad_ref.float()).abs().max()))


def flax_leaves(state):
    """A state dict of the core (parameters or one Adam moment) as float32 numpy leaves
    under the JAX package's names, ``<part>/<layer>/<kernel|bias>``."""
    from trustedai_cl_vae_ad_tpu_torch.bridge import params_to_flax

    return {f"{part}/{layer}/{leaf}": value
            for part, layers in params_to_flax(state).items()
            for layer, leaves in layers.items() for leaf, value in leaves.items()}


def jax_logdir_phase(name, dev):
    """One JAX-written fixture on the card: load, eval forward, the live engine, w8a8 from
    the sidecar, one training step; each against the JAX package's stored CPU outputs.
    Returns the kernels' launches on that path and what was measured."""
    import numpy as np
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm, moments, quant, stream_score
    from trustedai_cl_vae_ad_tpu_torch.ops.stream_score import StreamScoreState
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import StreamingEngine
    from trustedai_cl_vae_ad_tpu_torch.testing import compare_train_runs

    logdir = os.path.join(JAX_LOGDIRS, "converted", name)
    with np.load(os.path.join(JAX_LOGDIRS, f"{name}.npz")) as f:
        ref = dict(f)
    bf16 = name.endswith("bf16")
    rec_tol = dict(rtol=1e-2, atol=1e-3) if bf16 else dict(rtol=1e-4, atol=1e-5)
    load_s = []  # the first load of the process pays cuDNN's and the allocator's set-up
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, config = load_model_from_directory(logdir, device=dev, restore_optimizer=True)
        torch.cuda.synchronize()
        load_s.append(time.perf_counter() - t0)
    assert model.device.type == "cuda" and model.optimizer is not None
    assert torch.backends.cudnn.allow_tf32 is False  # float32 means float32 (bf16 runs too)
    x = torch.from_numpy(ref["frames"]).to(dev)
    reset_launch_counts(stream_score, moments, int8_gemm)
    rec = model.call(x).float().cpu().numpy()
    np.testing.assert_allclose(rec, ref["reconstruction"], **rec_tol)
    rec_err = float(np.abs(rec - ref["reconstruction"]).max())

    # the live engine, 8 frames through kernel 1 from the fixture's warm scorer state
    engine = StreamingEngine(model, config, anomaly_settings=JAX_SETTINGS)
    engine.inference_period_ms = 0.0
    maps = np.stack([np.full((32, 48), 0.1, np.float32), np.full((32, 48), 0.0125, np.float32)])
    scalars = np.array([0.0, 1.0, 1.0, 2.0, 1.0, 0.0], np.float32)
    engine.score_state = StreamScoreState(torch.from_numpy(maps).to(dev),
                                          torch.from_numpy(scalars).to(dev))
    results = [engine.process_frame(f, now=float(i), tag=i) for i, f in enumerate(ref["frames"])]
    agreed = True
    for r, score, count in zip(results, ref["scores"], ref["counts"]):
        assert abs(r.pixel_count - count) <= 2, (name, r.tag, r.pixel_count, count)
        agreed = agreed and r.pixel_count == count
        if agreed:
            np.testing.assert_allclose(r.score, score, rtol=1e-4)
    assert agreed, (name, [r.pixel_count for r in results], ref["counts"])

    # w8a8 from the sidecar, through kernel 10 (both Dense layers on the tensor cores)
    r8_err = None
    if "reconstruction_w8a8" in ref:
        qparams = quant.load_quantized_checkpoint(logdir, dev)
        r8 = quant.call_quantized(model.core, qparams, x).float().cpu().numpy()
        r8_err = float(np.abs(r8 - ref["reconstruction_w8a8"]).max())
        assert r8_err <= 2e-4, r8_err

    # one training step from the resumed state, with the JAX step's latent noise
    lr = float(ref["learning_rate"])
    if bf16:  # the JAX package restores its injected rate into the parameters' dtype
        assert float(torch.tensor(model.learning_rate).to(torch.bfloat16)) == lr
    else:
        assert model.learning_rate == lr
    opt = model.optimizer
    moments_before = {kind: flax_leaves(dict(zip(opt.names, getattr(opt, kind))))
                      for kind in ("mu", "nu")}
    loss, _ = model.train_step_and_run(x, eps=torch.from_numpy(ref["step_eps"]).to(dev))
    got = {k: float(v) for k, v in loss.items()}
    want = {k[len("loss/"):]: float(v) for k, v in ref.items() if k.startswith("loss/")}
    compare_train_runs([got], [want], rtol=1e-3 if bf16 else 1e-4, atol=1e-6,
                       label=f"{name} after resume")
    assert opt.count == int(ref["count"]), (opt.count, int(ref["count"]))
    param_err = 0.0
    for key, value in flax_leaves(model.params).items():
        expect = ref[f"params/{key}"]
        if bf16:
            np.testing.assert_allclose(value, expect, rtol=2.0 ** -7, atol=0.5 * lr, err_msg=key)
        else:
            np.testing.assert_allclose(value, expect, rtol=0, atol=0.05 * lr, err_msg=key)
        param_err = max(param_err, float(np.abs(value - expect).max()))
    # the moments after the step, within a share of the step's own change of each leaf
    moment_err = 0.0
    for kind, before in moments_before.items():
        for key, value in flax_leaves(dict(zip(opt.names, getattr(opt, kind)))).items():
            expect = ref[f"{kind}/{key}"]
            change = float(np.abs(expect - before[key]).max())
            assert change > 0, (kind, key)
            err = float(np.abs(value - expect).max())
            assert err <= (0.25 if bf16 else 1e-3) * change, (kind, key, err, change)
            moment_err = max(moment_err, err / change)
    torch.cuda.synchronize()
    launches = launch_counts(stream_score, moments, int8_gemm)
    kind = JAX_FIXTURES[name]
    assert launches["stream_score_cluster"] == len(results) == 8, launches
    assert launches[f"moments_cluster_{kind}_forward"] == 1, launches
    assert launches[f"moments_cluster_{kind}_backward"] == 1, launches
    if r8_err is not None:
        assert launches["int8_gemm_mma"] == 2 and launches["int8_gemm"] == 0, launches

    # each kernel of the path against its plain version at the path's shapes (not counted)
    checks = {}
    state = StreamScoreState(torch.from_numpy(maps).to(dev), torch.from_numpy(scalars).to(dev))
    img = x[0].float() / 255.0
    rec0 = model.call(x[:1])[0].float()
    got_s = stream_score.stream_score_step(state, img, rec0, ALPHA)
    ref_s = stream_score.stream_score_step_reference(state, img, rec0, ALPHA)
    torch.testing.assert_close(got_s[0].maps, ref_s[0].maps, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got_s[1], ref_s[1], rtol=1e-5, atol=1e-6)
    assert abs(float(got_s[3]) - float(ref_s[3])) <= 2
    checks["stream_score_cluster"] = float((got_s[0].maps - ref_s[0].maps).abs().max())
    checks[f"moments_cluster_{kind}"] = moments_check(
        moments, kind, (x.shape[0], model.latent_size), "bfloat16" if bf16 else "float32", dev)
    if r8_err is not None:
        shapes = []
        saved = quant._int8_partials
        quant._int8_partials = plain_int8_partials(quant, int8_gemm, shapes)
        try:
            r8_plain = quant.call_quantized(model.core, qparams, x).float().cpu().numpy()
        finally:
            quant._int8_partials = saved
        # the int8 sums were asserted equal; the convolutions around them may take another
        # cuDNN algorithm in a second forward (phase w holds the same comparison at rtol 1e-5)
        assert len(shapes) == 2, shapes
        np.testing.assert_allclose(r8_plain, r8, rtol=1e-5, atol=1e-6)
        checks["int8_gemm_mma"] = 0.0
    log(f"  {name}: loaded in {load_s[0]:.4f} s, again in {load_s[1]:.4f} s (learning rate "
        f"{model.learning_rate:.9g}, Adam step {model.optimizer.count - 1} before this one); "
        f"eval forward within {rec_err:.3g} "
        f"of JAX's; counts {[int(r.pixel_count) for r in results]} as JAX's "
        f"{[int(c) for c in ref['counts']]}; w8a8 within {r8_err} of JAX's; step loss "
        f"{got['loss']:.6f} (JAX {want['loss']:.6f}), parameters within {param_err:.3g}, "
        f"moments within {moment_err:.3g} of the step's change; "
        f"launches {dict((k, v) for k, v in launches.items() if v)}; kernel vs plain {checks}")
    return {"load_s": load_s, "launches": launches, "rec_err": rec_err, "w8a8_err": r8_err,
            "param_err": param_err, "moment_err": moment_err, "checks": checks}


class EpochClock:
    """A re-iterable stream that notes the wall clock (``time.time``, as the records of
    ``metrics.jsonl`` carry) at the start of each of its iterations: an epoch's clock then
    starts before its first batch is asked for."""

    def __init__(self, stream):
        self.stream, self.starts = stream, []

    def __len__(self):
        return len(self.stream)

    def __iter__(self):
        self.starts.append(time.time())
        return iter(self.stream)


class TimedSource:
    """A re-iterable host source that adds up the seconds its iterations spend producing
    items (decode and batching, in the prefetch thread) and counts its passes."""

    def __init__(self, source):
        self.source, self.seconds, self.passes = source, 0.0, 0

    def __len__(self):
        return len(self.source)

    def __iter__(self):
        self.passes += 1
        it = iter(self.source)
        while True:
            t0 = time.perf_counter()
            item = next(it, None)
            self.seconds += time.perf_counter() - t0
            if item is None:
                return
            yield item


def write_coco_split(root, split, n, h, w, c, rng):
    """n synthetic PNG frames (``smooth_frames``) and a COCO labels.json under
    root/split, written on 8 threads a chunk of 64 frames at a time."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from trustedai_cl_vae_ad_tpu_torch.data.coco import new_coco_skeleton, validate_coco_data

    os.makedirs(os.path.join(root, split, "frames"))
    labels = new_coco_skeleton(f"chip_smoke {split}")
    labels["categories"].append({"id": 1, "name": "person"})
    with ThreadPoolExecutor(8) as pool:
        for lo in range(0, n, 64):
            chunk = smooth_frames(rng, min(64, n - lo), h, w, c)
            names = [f"{lo + i:06d}.png" for i in range(len(chunk))]
            list(pool.map(lambda a: Image.fromarray(a[0]).save(
                os.path.join(root, split, "frames", a[1])), zip(chunk, names)))
            for i, name in enumerate(names, lo):
                labels["images"].append({"id": i, "file_name": name, "width": w, "height": h})
                labels["annotations"].append({"id": i, "image_id": i, "category_id": 1,
                                              "bbox": [10, 20, 30, 40], "area": 1200,
                                              "iscrowd": 0})
    validate_coco_data(labels)
    with open(os.path.join(root, split, "labels.json"), "w") as f:
        json.dump(labels, f)


def raite_phase(dev):
    """configs/raite.yml's model at its own widths on 1024 + 64 synthetic 300x224 PNG
    frames with a COCO labels.json, data.device_cache on, through train_torch.py's main.
    Each epoch is timed whole, its first step included: the first decodes on the host and
    fills the cache, the later ones read the card."""
    import numpy as np
    import torch

    import train_torch
    from trustedai_cl_vae_ad_tpu_torch.config import load_config, save_config
    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm, moments, stream_score
    from trustedai_cl_vae_ad_tpu_torch.train import loop

    config = load_config(os.path.join(REPO, "configs", "raite.yml"))
    h, w, c = config["data"]["image_size"]
    batch = int(config["training"]["batch_size"])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_raite_")
    cwd = os.getcwd()
    captured = {}
    try:
        t0 = time.perf_counter()
        rng = np.random.RandomState(9)
        for split, n in ((config["data"]["train_split"], RAITE_TRAIN),
                         (config["data"]["val_split"], RAITE_VAL)):
            write_coco_split(os.path.join(tmp, "raite"), split, n, h, w, c, rng)
        write_s = time.perf_counter() - t0
        config["data"].update(dataset_path=os.path.join(tmp, "raite"), device_cache=True)
        config["training"]["max_epochs"] = RAITE_EPOCHS
        cfg_path = os.path.join(tmp, "raite.yml")
        save_config(config, cfg_path)

        real_load_data, real_train_model = train_torch.load_data, train_torch.train_model

        def load_data(cfg, device):
            captured["data"] = data = real_load_data(cfg, device=device)
            for split in ("train_full", "val_full"):
                data[split].source = TimedSource(data[split].source)
            data["train"] = captured["clock"] = EpochClock(data["train"])
            return data

        def train_model(cfg, model, data, **kwargs):
            captured["logdir"] = cfg["logdir"]
            return real_train_model(cfg, model, data, log_every=1, **kwargs)

        train_torch.load_data, train_torch.train_model = load_data, train_model
        os.chdir(tmp)  # the stamped logs/fit_<time> directory goes under the temporary one
        reset_launch_counts(stream_score, moments, int8_gemm)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        train_torch.main([cfg_path])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = launch_counts(stream_score, moments, int8_gemm)
        peak = torch.cuda.max_memory_allocated()
    finally:
        os.chdir(cwd)
        train_torch.load_data, train_torch.train_model = real_load_data, real_train_model
    try:
        data, logdir = captured["data"], captured["logdir"]
        train_full, val_full = data["train_full"], data["val_full"]
        assert train_full.cached and val_full.cached, "the device cache did not fill"
        assert all(b["image"].device.type == "cuda" for b in list(train_full))
        cache_bytes = train_full.nbytes + val_full.nbytes
        assert cache_bytes == (RAITE_TRAIN + RAITE_VAL) * h * w * c * 4 == train_full.budget.used
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        train = [r for r in records if "train/loss" in r]
        steps_per_epoch = RAITE_TRAIN // batch
        assert len(train) == RAITE_EPOCHS * steps_per_epoch, len(train)
        assert all(np.isfinite(r["train/loss"]) for r in train)
        # an epoch's time: from the start of its iteration (before its first batch is asked
        # for) to the record of its last step (each record fetches the loss, so it waits
        # for its step); validation is not in it
        starts = captured["clock"].starts
        assert len(starts) == RAITE_EPOCHS, starts
        times = [r["time"] for r in train]
        epochs = [times[e * steps_per_epoch:(e + 1) * steps_per_epoch] for e in range(RAITE_EPOCHS)]
        epoch_s = [ep[-1] - start for ep, start in zip(epochs, starts)]
        first_step_ms = [(ep[0] - start) * 1e3 for ep, start in zip(epochs, starts)]
        gap_ms = [sorted((b - a) * 1e3 for a, b in zip(ep, ep[1:])) for ep in epochs]
        median_gap_ms = [g[len(g) // 2] for g in gap_ms]
        frames_per_s = [RAITE_TRAIN / s for s in epoch_s]
        cached_s = sorted(epoch_s[1:])[len(epoch_s[1:]) // 2]
        val_steps = -(-RAITE_VAL // batch)
        expected = RAITE_EPOCHS * (steps_per_epoch + val_steps)
        assert launches["moments_cluster_global_forward"] == expected, launches
        assert launches["moments_cluster_global_backward"] == RAITE_EPOCHS * steps_per_epoch
        assert loop.load_train_state(logdir)["epochs_completed"] == RAITE_EPOCHS
        # the host made each split's batches once, in the first epoch: the later epochs
        # read the cache on the card
        assert train_full.source.passes == val_full.source.passes == 1, (
            train_full.source.passes, val_full.source.passes)
        decode_s = train_full.source.seconds
        check = moments_check(moments, "global", (batch, int(config["model"]["latent_dimensions"])),
                              "float32", dev)
        log(f"  raite.yml ({h}x{w}x{c}, layers {config['model']['layers']}, latent "
            f"{config['model']['latent_dimensions']}, batch {batch}): {RAITE_TRAIN} + {RAITE_VAL} "
            f"PNG frames and labels.json written in {write_s:.1f} s; train_torch.main ran "
            f"{RAITE_EPOCHS} epochs in {run_s:.1f} s")
        for e in range(RAITE_EPOCHS):
            log(f"    epoch {e} ({'decode, upload and cache fill' if e == 0 else 'from the cache'}"
                f"): {steps_per_epoch} steps in {epoch_s[e]:.4f} s, first step included "
                f"({frames_per_s[e]:.1f} frames/s); its first step {first_step_ms[e]:.2f} ms, "
                f"median gap between steps {median_gap_ms[e]:.2f} ms (slowest "
                f"{gap_ms[e][-1]:.2f})")
        log(f"    first epoch / cached epoch {epoch_s[0] / cached_s:.3f}; the first epoch's "
            f"host decode and batching {decode_s:.3f} s of the prefetch thread "
            f"({RAITE_TRAIN / decode_s:.1f} frames/s, 8 decode threads), the validation "
            f"split's {val_full.source.seconds:.3f} s, neither read again; device cache "
            f"{cache_bytes} bytes; peak {peak / 2**30:.2f} GiB; launches "
            f"{dict((k, v) for k, v in launches.items() if v)}; global moments vs plain "
            f"{check:.3g}")
        return {"launches": launches, "epoch_s": epoch_s, "frames_per_s": frames_per_s,
                "first_step_ms": first_step_ms, "median_gap_ms": median_gap_ms,
                "decode_s": decode_s, "cache_bytes": cache_bytes, "run_s": run_s,
                "peak": peak}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_x(dev):
    """The JAX-written log directories on the card (x1) and configs/raite.yml's COCO-JSON data
    path with the device cache (x2); returns the launches of each path by kernel entry."""
    log(f"  x1 reads {os.path.relpath(os.path.join(JAX_LOGDIRS, 'converted'), REPO)}/<name>: "
        "tools/convert_logdir_torch.py's copies of the JAX-written directories (this machine "
        "reads orbax only through tensorstore, which the card's machine lacks)")
    out = {"x1": {name: jax_logdir_phase(name, dev) for name in JAX_FIXTURES}}
    out["jax_logdir"] = {}
    for res in out["x1"].values():
        for key, n in res["launches"].items():
            out["jax_logdir"][key] = out["jax_logdir"].get(key, 0) + n
    out["x2"] = raite_phase(dev)
    out["raite"] = out["x2"]["launches"]
    return out


Y_VERI_TRAIN, Y_VERI_VAL, Y_EPOCHS = 512, 256, 2  # 2 training steps an epoch at batch 256
Y_VERI_SIZES = [(120, 160), (200, 180), (96, 224), (224, 224), (150, 260), (80, 100)]
Y_VIRAT_VIDEOS = {"VIRAT_S_010204_05_000856_000890": ((240, 320), 24),
                  "VIRAT_S_040103": ((180, 240), 16)}
Y_VIRAT_STRIDE = 4
Y_WARMUP, Y_STEPS = 3, 10
Y_LOSS_RTOL = 0.05  # the two optimizers' losses after the timed steps, relative


def write_veri_split(directory, n, rng):
    """n synthetic crops (``smooth_frames``) in VeRi's layout and names, JPEG and PNG in
    the sizes of Y_VERI_SIZES, written on 8 threads."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    os.makedirs(directory)
    jobs = []
    for i in range(n):
        h, w = Y_VERI_SIZES[i % len(Y_VERI_SIZES)]
        ext = ".png" if i % 4 == 0 else ".jpg"
        jobs.append((smooth_frames(rng, 1, h, w, 3)[0],
                     os.path.join(directory, f"{i % 776:04d}_c{i % 20 + 1:03d}_{i:08d}{ext}")))
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda a: Image.fromarray(a[0]).save(a[1]), jobs))


def write_virat_root(root, rng):
    """Y_VIRAT_VIDEOS as videos under root/videos_original (each a field of blocks that
    drifts), the first with its three annotation files; returns the codec used."""
    import cv2

    os.makedirs(os.path.join(root, "videos_original"))
    os.makedirs(os.path.join(root, "annotations"))
    for name, ((h, w), n) in Y_VIRAT_VIDEOS.items():
        path = os.path.join(root, "videos_original", f"{name}.mp4")
        for codec in ("mp4v", "MJPG"):  # whichever this machine's OpenCV can write
            writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*codec), 10, (w, h))
            if writer.isOpened():
                break
        else:
            raise RuntimeError(f"OpenCV writes neither mp4v nor MJPG into {path}")
        for frame in smooth_frames(rng, n, h, w, 3):
            writer.write(frame)
        writer.release()
    base = os.path.join(root, "annotations", next(iter(Y_VIRAT_VIDEOS)) + ".viratdata.")
    for kind, text in (("events", "1 4 10 5 15 2 10 12 30 40\n"),
                       ("mapping", "1 4 10 5 15 2 1 0 1\n"),
                       ("objects", "1 9 2 10 12 5 6 1\n")):
        with open(base + kind + ".txt", "w") as f:
            f.write(text)
    return codec


def optimizer_bytes(optimizer):
    """Bytes of an optimizer's moments (every tensor of its state but the count)."""
    import torch

    def tensors(x):
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, dict):
            for v in x.values():
                yield from tensors(v)

    state = optimizer.state_dict()
    return sum(t.numel() * t.element_size() for kind in ("mu", "nu") for t in tensors(state[kind]))


def veri_phase(dev):
    """(y1) configs/veri.yml at its own widths with training.optimizer adam_fp8, on frames
    that build_veri_dataset_torch.py made from VeRi-layout crops, through train_torch.py's
    main; then a VIRAT root through build_virat_dataset_torch.py --extract-frames and the
    port's loader."""
    import numpy as np
    import torch

    import build_veri_dataset_torch
    import build_virat_dataset_torch
    import train_torch
    from trustedai_cl_vae_ad_tpu_torch.config import load_config, save_config
    from trustedai_cl_vae_ad_tpu_torch.data.loader import load_data
    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm, moments, stream_score
    from trustedai_cl_vae_ad_tpu_torch.ops.adam8 import AdamFp8, QLeaf
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory
    from trustedai_cl_vae_ad_tpu_torch.train import checkpoint, loop

    config = load_config(os.path.join(REPO, "configs", "veri.yml"))
    h, w, c = config["data"]["image_size"]
    batch = int(config["training"]["batch_size"])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_veri_")
    cwd = os.getcwd()
    captured = {}
    try:
        rng = np.random.RandomState(18)
        t0 = time.perf_counter()
        for split, n in (("image_train", Y_VERI_TRAIN), ("image_test", Y_VERI_VAL)):
            write_veri_split(os.path.join(tmp, "VeRi", split), n, rng)
        write_s = time.perf_counter() - t0
        out = os.path.join(tmp, "datasets", "veri")
        t0 = time.perf_counter()
        assert build_veri_dataset_torch.main([os.path.join(tmp, "VeRi", "image_train"),
                                              os.path.join(tmp, "VeRi", "image_test"),
                                              "-o", out]) == 0
        build_s = time.perf_counter() - t0
        config["data"]["dataset_path"] = out
        config["training"].update(optimizer="adam_fp8", max_epochs=Y_EPOCHS)
        cfg_path = os.path.join(tmp, "veri.yml")
        save_config(config, cfg_path)

        real_load_data, real_train_model = train_torch.load_data, train_torch.train_model

        def wrapped_load_data(cfg, device):
            data = real_load_data(cfg, device=device)
            data["train"] = captured["clock"] = EpochClock(data["train"])
            return data

        def wrapped_train_model(cfg, model, data, **kwargs):
            captured["logdir"], captured["model"] = cfg["logdir"], model
            return real_train_model(cfg, model, data, log_every=1, **kwargs)

        train_torch.load_data, train_torch.train_model = wrapped_load_data, wrapped_train_model
        os.chdir(tmp)  # the stamped logs/fit_<time> directory goes under the temporary one
        reset_launch_counts(stream_score, moments, int8_gemm)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        train_torch.main([cfg_path, "--device", str(dev)])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = launch_counts(stream_score, moments, int8_gemm)
        peak = torch.cuda.max_memory_allocated()
    finally:
        os.chdir(cwd)
        train_torch.load_data, train_torch.train_model = real_load_data, real_train_model
    try:
        model, logdir = captured["model"], captured["logdir"]
        opt = model.optimizer
        assert isinstance(opt, AdamFp8) and opt.name == "adam_fp8", type(opt)
        quantized = [n for n, m in zip(opt.names, opt.mu) if isinstance(m, QLeaf)]
        assert sorted(quantized) == ["decoder.layers.Dense_0.weight",
                                     "encoder.layers.Dense_0.weight"], quantized
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        train = [r for r in records if "train/loss" in r]
        val = [r for r in records if "val/loss" in r]
        steps_per_epoch = Y_VERI_TRAIN // batch
        val_steps = -(-Y_VERI_VAL // batch)
        assert len(train) == Y_EPOCHS * steps_per_epoch and len(val) == Y_EPOCHS, records
        losses = [r["train/loss"] for r in train]
        assert all(np.isfinite(v) for v in losses + [r["val/loss"] for r in val]), records
        assert opt.count == Y_EPOCHS * steps_per_epoch
        starts = captured["clock"].starts
        assert len(starts) == Y_EPOCHS, starts
        times = [r["time"] for r in train]
        epoch_s = [times[(e + 1) * steps_per_epoch - 1] - starts[e] for e in range(Y_EPOCHS)]
        expected = Y_EPOCHS * (steps_per_epoch + val_steps)
        assert launches["moments_cluster_global_forward"] == expected, launches
        assert launches["moments_cluster_global_backward"] == Y_EPOCHS * steps_per_epoch, launches
        assert launches["moments_global_forward"] == launches["moments_global_backward"] == 0
        assert loop.load_train_state(logdir)["epochs_completed"] == Y_EPOCHS
        # the saved adam_fp8 state restores to the trained model's, bit for bit
        saved = checkpoint.restore_optimizer_state(logdir)
        assert set(saved["mu"]["encoder.layers.Dense_0.weight"]) == {"q", "scale", "scale_next"}
        reloaded, _ = load_model_from_directory(logdir, device=dev, restore_optimizer=True)
        for kind in ("mu", "nu"):
            for a, b in zip(getattr(opt, kind), getattr(reloaded.optimizer, kind), strict=True):
                for t, u in (zip(a, b) if isinstance(a, QLeaf) else [(a, b)]):
                    assert t.dtype == u.dtype and torch.equal(t, u)
        assert reloaded.optimizer.count == opt.count
        del reloaded
        check = moments_check(moments, "global", (batch, int(config["model"]["latent_dimensions"])),
                              "float32", dev)
        fp8_bytes = optimizer_bytes(opt)
        log(f"  veri.yml ({h}x{w}x{c}, layers {config['model']['layers']}, latent "
            f"{config['model']['latent_dimensions']}, batch {batch}, adam_fp8): "
            f"{Y_VERI_TRAIN} + {Y_VERI_VAL} crops of {len(Y_VERI_SIZES)} sizes written in "
            f"{write_s:.1f} s; build_veri_dataset_torch.py resized and saved them in {build_s:.2f} s "
            f"({(Y_VERI_TRAIN + Y_VERI_VAL) / build_s:.1f} frames/s); train_torch.main ran "
            f"{Y_EPOCHS} epochs in {run_s:.1f} s")
        log(f"    epochs: {[round(s, 4) for s in epoch_s]} s ({steps_per_epoch} steps each, first "
            f"step included); losses {[round(v, 6) for v in losses]}; validation "
            f"{[round(r['val/loss'], 6) for r in val]}; quantized leaves {quantized}; moments "
            f"{fp8_bytes} bytes; peak {peak / 2**30:.2f} GiB; kernel 2 launches by arrangement "
            f"{ {k: v for k, v in launches.items() if v} }; global moments vs plain {check:.3g}")
        del model, opt
        captured.clear()
        torch.cuda.empty_cache()

        # VIRAT: videos into frame records and a saved dataset, loaded onto the card
        root, vout = os.path.join(tmp, "virat"), os.path.join(tmp, "datasets", "virat")
        codec = write_virat_root(root, rng)
        t0 = time.perf_counter()
        assert build_virat_dataset_torch.main([root, "-o", vout, "--extract-frames",
                                               str(Y_VIRAT_STRIDE)]) == 0
        virat_s = time.perf_counter() - t0
        with open(os.path.join(vout, "index.json")) as f:
            records_n = json.load(f)["num_items"]
        assert records_n == sum(n for _hw, n in Y_VIRAT_VIDEOS.values()), records_n
        vcfg = load_config(os.path.join(REPO, "configs", "virat_cl.yml"))
        vcfg["data"]["dataset_path"] = vout
        vcfg["training"]["batch_size"] = 8
        data = load_data(vcfg, device=dev)
        frames = 0
        for b in data["train"]:
            assert b["image"].device.type == dev.type
            assert tuple(b["image"].shape[1:]) == tuple(vcfg["data"]["image_size"])
            frames += b["image"].shape[0]
        expect = sum(-(-n // Y_VIRAT_STRIDE) for _hw, n in Y_VIRAT_VIDEOS.values())
        assert frames == expect and data["val"] is None, (frames, expect)
        log(f"  VIRAT: {len(Y_VIRAT_VIDEOS)} {codec} videos ({records_n} frames) into frame "
            f"records and every {Y_VIRAT_STRIDE}th frame in {virat_s:.2f} s; {frames} frames "
            f"loaded onto the card at {vcfg['data']['image_size']}")
        return {"launches": launches, "epoch_s": epoch_s, "losses": losses, "build_s": build_s,
                "run_s": run_s, "peak": peak, "moment_bytes": fp8_bytes, "virat_frames": frames}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def time_update(opt, dev):
    """ms of one optimizer update alone, on gradients of 1e-3 (3 calls after 1, synchronized)."""
    import torch

    grads = [torch.full_like(p, 1e-3) for p in opt.params]
    opt.step(grads)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        opt.step(grads)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / 3


def fp8_device_check(dev):
    """adam_fp8 on the card against the same update on the CPU, 3 steps of a big leaf
    (1024x1024) and small ones, bfloat16 and float32: returns the mismatch counts."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops.adam8 import AdamFp8, QLeaf

    gen = torch.Generator().manual_seed(5)
    shapes = {"encoder.layers.Dense_0.weight": (1024, 1024), "encoder.layers.Dense_0.bias": (1024,),
              "decoder.layers.Conv_0.weight": (32, 16, 3, 3)}
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        p0 = {k: (torch.randn(s, generator=gen) * 0.1).to(dtype) for k, s in shapes.items()}
        grads = [{k: (torch.randn(s, generator=gen) * 1e-2 * (1 + 99 * (i == 1))).to(dtype)
                  for k, s in shapes.items()} for i in range(3)]
        runs = {}
        for where in (dev, torch.device("cpu")):
            params = {k: v.clone().to(where) for k, v in p0.items()}
            opt = AdamFp8(params, 1e-3)
            for g in grads:
                opt.step([g[k].to(where) for k in opt.names])
            runs[where.type] = (params, opt)
        (pd, od), (pc, oc) = runs[dev.type], runs["cpu"]
        differ = 0
        for k in shapes:
            differ += int((pd[k].cpu() != pc[k]).sum())
        for kind in ("mu", "nu"):
            for a, b in zip(getattr(od, kind), getattr(oc, kind)):
                for t, u in (zip(a, b) if isinstance(a, QLeaf) else [(a, b)]):
                    differ += int((t.cpu() != u).sum())
        # the bounds of the CPU parity tests: here every bit is expected to agree
        assert differ <= 1e-4 * sum(t.numel() for t in p0.values()), (dtype, differ)
        out[str(dtype).split(".")[-1]] = differ
    return out


def fp8_train_step_phase(dev):
    """(y2) the flagship bfloat16 train + score step at batch 256 with adam_lean, then with
    adam_fp8, from the same seeded weights and inputs: ms a step, peak memory, the moments'
    bytes, each update timed alone, the two runs' losses."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm, moments, stream_score
    from trustedai_cl_vae_ad_tpu_torch.ops.adam8 import AdamFp8, QLeaf
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config
    from trustedai_cl_vae_ad_tpu_torch.train.bench_step import flagship_config, train_score_step

    runs = {}
    for name in ("adam_lean", "adam_fp8"):
        bench = flagship_config()
        bench["training"].update(precision="bfloat16", optimizer=name)
        model = load_model_from_config(bench, seed=0, device=dev)
        model.compile()
        assert model.optimizer.name == name
        if name == "adam_fp8":
            assert isinstance(model.optimizer, AdamFp8)
            assert sum(isinstance(m, QLeaf) for m in model.optimizer.mu) == 2
        hw, c = bench["data"]["image_size"][:2], bench["data"]["image_size"][2]
        x_u8 = torch.randint(0, 256, (BATCH, *hw, c), dtype=torch.uint8, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(0))
        reset_launch_counts(stream_score, moments, int8_gemm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = []
        for _ in range(Y_WARMUP):
            loss, z = train_score_step(model, x_u8, 100.0, 10.0)
            losses.append(loss)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(Y_STEPS):
            loss, z = train_score_step(model, x_u8, 100.0, 10.0)
            losses.append(loss)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / Y_STEPS
        peak = torch.cuda.max_memory_allocated()
        launches = launch_counts(stream_score, moments, int8_gemm)
        losses = [float(v) for v in losses]
        assert all(v == v and abs(v) != float("inf") for v in losses), losses
        assert bool(torch.isfinite(z).all()) and z.shape == (BATCH,)
        steps = Y_WARMUP + Y_STEPS
        assert launches["moments_cluster_global_forward"] == steps, launches
        assert launches["moments_cluster_global_backward"] == steps, launches
        nbytes = optimizer_bytes(model.optimizer)
        update_ms = time_update(model.optimizer, dev)
        runs[name] = {"ms": ms, "peak": peak, "moment_bytes": nbytes, "update_ms": update_ms,
                      "losses": losses, "launches": launches}
        log(f"  {name}: bfloat16 train + score step, batch {BATCH}: {ms:.3f} ms a step "
            f"({BATCH / ms * 1e3:.1f} frames/s; {Y_STEPS} after {Y_WARMUP}, synchronized); "
            f"max_memory_allocated {peak / 2**30:.3f} GiB; moments {nbytes} bytes; the update "
            f"alone {update_ms:.3f} ms; losses {[round(v, 6) for v in losses]}")
        del model, x_u8, loss, z
        torch.cuda.empty_cache()
    lean, fp8 = runs["adam_lean"], runs["adam_fp8"]
    rel = abs(fp8["losses"][-1] - lean["losses"][-1]) / abs(lean["losses"][-1])
    # the first step's loss comes before any update: the same weights, batch and noise
    assert abs(fp8["losses"][0] - lean["losses"][0]) <= 1e-5 * abs(lean["losses"][0]), (
        fp8["losses"][0], lean["losses"][0])
    assert rel <= Y_LOSS_RTOL, (rel, fp8["losses"], lean["losses"])
    assert fp8["peak"] <= lean["peak"], (fp8["peak"], lean["peak"])
    check = fp8_device_check(dev)
    log(f"  adam_fp8 against adam_lean: step {fp8['ms'] / lean['ms']:.3f}x, peak "
        f"{(lean['peak'] - fp8['peak']) / 2**30:.3f} GiB lower, moments "
        f"{lean['moment_bytes'] - fp8['moment_bytes']} bytes fewer, update alone "
        f"{fp8['update_ms']:.3f} against {lean['update_ms']:.3f} ms; last losses within "
        f"{rel:.3g} relative (bound {Y_LOSS_RTOL}); the update on the card against the CPU's: "
        f"{check} elements differ")
    return {"runs": runs, "loss_rel": rel, "device_check": check}


def phase_y(dev):
    """configs/veri.yml on builder-made frames with adam_fp8 (y1), and the flagship's
    bfloat16 step with adam_fp8 beside adam_lean (y2)."""
    return {"y1": veri_phase(dev), "y2": fp8_train_step_phase(dev)}

Z_RANKS = 2
Z_WORKER_TIMEOUT_S = 600
Z_STEPS = 2


def float32_flagship():
    from trustedai_cl_vae_ad_tpu_torch.train.bench_step import flagship_config

    config = flagship_config()
    config["training"]["precision"] = "float32"
    return config


def seeded_frames(dev, config, n=BATCH, seed=0):
    """One seeded batch of uint8 frames at the config's size, drawn on the card (the same
    bits in every process)."""
    import torch

    h, w, c = config["data"]["image_size"]
    return torch.randint(0, 256, (n, h, w, c), dtype=torch.uint8, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(seed))


def timed_steps(model, x, steps):
    """(losses, ms of each step): each step synchronized and timed alone."""
    import torch

    losses, ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model.train_step(x)
        losses.append(float(loss["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def z_cli_run(config_path, extra):
    """train_torch.py's main in this process, in a temporary working directory (its logs,
    a 16 GB checkpoint, are deleted after): the losses and ms of each training step (each
    synchronized and timed alone by a wrapper of VAEModel.train_step), and the launches of
    kernels 1, 2, 3 and 10 in the run."""
    import torch

    import train_torch
    from trustedai_cl_vae_ad_tpu_torch.models.wrapper import VAEModel
    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm, moments, stream_score

    record = []
    original = VAEModel.train_step

    def train_step(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = original(self, *args, **kwargs)
        value = float(loss["loss"])
        torch.cuda.synchronize()
        record.append(((time.perf_counter() - t0) * 1e3, value, self.mesh is not None))
        return loss

    workdir = tempfile.mkdtemp(prefix="chip_smoke_z1_")
    cwd = os.getcwd()
    reset_launch_counts(stream_score, moments, int8_gemm)
    VAEModel.train_step = train_step
    try:
        os.chdir(workdir)
        t0 = time.perf_counter()
        train_torch.main([config_path, *extra])
        seconds = time.perf_counter() - t0
    finally:
        VAEModel.train_step = original
        os.chdir(cwd)
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"ms": [r[0] for r in record], "losses": [r[1] for r in record],
            "on_mesh": [r[2] for r in record], "seconds": seconds,
            "launches": launch_counts(stream_score, moments, int8_gemm)}


def phase_z1(dev):
    """(z1) train_torch.py at flagship width, float32 + adam, 2 training and 1 validation
    batches of 256 synthetic frames: through a process group of one (NCCL) and with
    --no-parallel. The same losses; kernel 2 once forward a step and once backward a
    training step, all on the cluster kernel, both ways."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.config import load_config, save_config, validate_config

    config = validate_config(load_config(os.path.join(REPO, "configs", "config.yml")))
    config["data"] = {"image_size": config["data"]["image_size"], "dataset": "synthetic",
                      "n_train": Z_STEPS * BATCH, "n_val": VAL_STEPS * BATCH,
                      "synthetic_frame_size": [240, 320]}
    config["training"].update(max_epochs=1, precision="float32")
    directory = tempfile.mkdtemp(prefix="chip_smoke_z1cfg_")
    try:
        path = os.path.join(directory, "config.yml")
        save_config(config, path)
        runs = {"parallel": z_cli_run(path, ["--coordinator", f"127.0.0.1:{free_port()}",
                                             "--num-processes", "1", "--process-id", "0"]),
                "no_parallel": z_cli_run(path, ["--no-parallel"])}
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    assert not torch.distributed.is_initialized()
    par, plain = runs["parallel"], runs["no_parallel"]
    assert par["on_mesh"] == [True] * Z_STEPS and plain["on_mesh"] == [False] * Z_STEPS
    for a, b in zip(par["losses"], plain["losses"]):
        assert abs(a - b) <= 1e-5 * abs(b), (par["losses"], plain["losses"])
    for name, run in runs.items():
        launches = run["launches"]
        assert launches["moments_cluster_global_forward"] == Z_STEPS + VAL_STEPS, launches
        assert launches["moments_cluster_global_backward"] == Z_STEPS, launches
        assert launches["moments_global_forward"] == launches["moments_global_backward"] == 0
        log(f"  {name}: train_torch.py, float32 adam, batch {BATCH}, {Z_STEPS} + {VAL_STEPS} "
            f"steps in {run['seconds']:.1f} s of CLI (load, save, figures included); ms a "
            f"step {[round(v, 3) for v in run['ms']]}; losses {run['losses']}; kernel 2 "
            f"{launches['moments_cluster_global_forward']} forward, "
            f"{launches['moments_cluster_global_backward']} backward, all cluster")
    return runs


def param_samples(model):
    """{parameter: a strided sample of at most 4096 of its elements, in float64}, each
    tensor whole: a block split over the model axis is gathered first (every rank of the
    group takes part)."""
    from trustedai_cl_vae_ad_tpu_torch.parallel import tp

    out = {}
    for name, p in model.core.state_dict().items():
        if model.mesh is not None:
            p = tp.full_tensor(p, model.tp_dims.get(name), model.mesh)
        flat = p.detach().reshape(-1)
        out[name] = flat[::max(1, flat.numel() // 4096)][:4096].double().tolist()
    return out


def model_axis_spread(model, x):
    """The replicated parameters' gradients of one step over the model axis, BEFORE the axis
    averages them (``dp.average_replicated``): for each, the largest difference between the
    ranks over the largest magnitude. Taken three times with one fixed eps: twice as the
    model runs (``twice``: the second also against this rank's first, ``repeat``), then with
    ``torch.backends.cudnn.deterministic`` (``deterministic``). Also each run's loss, and a
    checksum of its x_hat, on this rank. The parameters do not move."""
    import torch
    import torch.distributed as dist

    from trustedai_cl_vae_ad_tpu_torch.parallel import dp
    from trustedai_cl_vae_ad_tpu_torch.parallel.mesh import shard_batch

    mesh, opt = model.mesh, model.optimizer
    group = mesh.model_group
    (rows,) = shard_batch(x, mesh)
    eps = torch.randn((rows.shape[0], model.latent_size), device=rows.device,
                      generator=torch.Generator(device=rows.device).manual_seed(7))
    replicated = [k for k in opt.names if model.tp_dims.get(k) is None]

    def run():
        loss, x_hat, grads = dp.loss_and_grads(model.core, opt.params, rows, mesh, eps=eps)
        own = {k: g for k, g in zip(opt.names, grads) if k in replicated}
        return float(loss["loss"].detach()), float(x_hat.detach().double().sum()), own

    def spread(own):
        worst = {}
        for k, g in own.items():
            hi, lo = g.clone(), g.clone()
            dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
            dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
            scale = float(torch.maximum(hi.abs().max(), lo.abs().max()))
            worst[k] = float((hi - lo).max()) / scale if scale else 0.0
        return worst

    result = {}
    first = None
    for mode in ("default", "twice", "deterministic"):
        torch.backends.cudnn.deterministic = mode == "deterministic"
        try:
            loss, checksum, own = run()
        finally:
            torch.backends.cudnn.deterministic = False
        result[mode] = {"loss": loss, "x_hat_sum": checksum, "spread": spread(own)}
        if first is None:
            first = own
        elif mode == "twice":
            result["repeat"] = {k: float((own[k] - first[k]).abs().max()) /
                                (float(first[k].abs().max()) or 1.0) for k in own}
        del own
    return result


def z_worker(rank, world, store, out):
    """One of the (z2), (z3) ranks, in its own process on the one card; writes its figures
    as JSON to ``out``."""
    import gc

    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm, moments, stream_score
    from trustedai_cl_vae_ad_tpu_torch.parallel.collectives import gather_blocks_
    from trustedai_cl_vae_ad_tpu_torch.parallel.mesh import (
        distributed_teardown,
        initialize_distributed,
        make_mesh,
    )
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config

    dev = torch.device("cuda", 0)
    initialize_distributed(f"file://{store}", world, rank, backend="gloo", device=dev)
    result = {}
    # KurtosisSingle at a tiny size on the data axis: kernel 3 on every rank on the
    # gathered z; rank 0 also takes the steps alone, on the whole batch
    tiny = tiny_config("KurtosisSingle")
    tiny["training"]["batch_size"] = 16
    x = seeded_frames(dev, tiny, n=16)
    model = load_model_from_config(tiny, seed=0, device=dev)
    model.compile(mesh=make_mesh(devices=[dev]))
    reset_launch_counts(stream_score, moments, int8_gemm)
    losses, _ = timed_steps(model, x, Z_STEPS)
    result["z2s"] = {"losses": losses, "launches": launch_counts(stream_score, moments,
                                                                 int8_gemm)}
    if rank == 0:
        alone = load_model_from_config(tiny, seed=0, device=dev)
        alone.compile()
        result["z2s"]["alone"] = timed_steps(alone, x, Z_STEPS)[0]
    config = float32_flagship()
    x = seeded_frames(dev, config)
    for part, shape, zero1 in (("z2", (world, 1), True), ("z3", (1, world), False)):
        model = load_model_from_config(config, seed=0, device=dev)
        t0 = time.perf_counter()
        model.compile(mesh=make_mesh(*shape, devices=[dev]), zero1=zero1)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        spread = model_axis_spread(model, x) if part == "z3" else None
        reset_launch_counts(stream_score, moments, int8_gemm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = timed_steps(model, x, Z_STEPS)
        opt = model.optimizer
        collective_ms = {}
        if zero1:
            # the two collectives of a ZeRO-1 step alone: the gradients' sum (one flat
            # buffer of every parameter's size) and the encoder Dense's blocks gathered
            flat = torch.ones(sum(p.numel() for p in opt.params), device=dev)
            weight = model.core.state_dict()["encoder.layers.Dense_0.weight"]
            for name, fn in (("sum_gradients", lambda: torch.distributed.all_reduce(flat)),
                             ("gather_encoder_dense", lambda: gather_blocks_(
                                 weight, 1, model.mesh.data_group))):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                collective_ms[name] = (time.perf_counter() - t1) * 1e3
            del flat, weight
        result[part] = {
            "compile_s": compile_s, "collective_ms": collective_ms,
            "losses": losses, "ms": ms, "peak": torch.cuda.max_memory_allocated(),
            "optimizer": type(opt).__name__,
            "moment_bytes": (opt.moment_bytes() if zero1 else
                             sum(t.numel() * t.element_size() for t in opt.mu + opt.nu)),
            "sharded": opt.sharded() if zero1 else [],
            "tp_shapes": {k: list(model.core.state_dict()[k].shape)
                          for k, d in model.tp_dims.items() if d is not None},
            "spread": spread,
            # every parameter after the steps, the model axis's blocks gathered
            "samples": param_samples(model),
            "launches": launch_counts(stream_score, moments, int8_gemm)}
        del model, opt
        gc.collect()
        torch.cuda.empty_cache()
    distributed_teardown()
    with open(out, "w") as f:
        json.dump(result, f)
    return 0


def phase_z23(dev):
    """(z2) two processes on the one card (gloo carries CUDA tensors; NCCL refuses two ranks
    on one GPU), flagship float32 + adam + ZeRO-1, each rank taking its 128 rows of one seeded
    256-frame batch, 2 steps, against one process with the whole batch; (z3) the same two
    processes as a (data 1, model 2) mesh, 2 steps. Each rank's losses and parameter updates
    are held against the one process's; on the model axis, the replicated gradients of the
    two ranks are held together before the axis averages them."""
    import gc

    import numpy as np
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm, moments, stream_score
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config

    config = float32_flagship()
    model = load_model_from_config(config, seed=0, device=dev)
    model.compile()
    x = seeded_frames(dev, config)
    initial = param_samples(model)
    reset_launch_counts(stream_score, moments, int8_gemm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = timed_steps(model, x, Z_STEPS)
    opt = model.optimizer
    single = {"losses": losses, "ms": ms, "peak": torch.cuda.max_memory_allocated(),
              "moment_bytes": sum(t.numel() * t.element_size() for t in opt.mu + opt.nu),
              "bytes_of": {k: mu.numel() * mu.element_size() * 2
                           for k, mu in zip(opt.names, opt.mu)},
              "samples": param_samples(model)}
    log(f"  one process, float32 adam, batch {BATCH}: losses {losses}; ms a step "
        f"{[round(v, 3) for v in ms]}; moments {single['moment_bytes']} bytes; "
        f"max_memory_allocated {single['peak'] / 2**30:.3f} GiB")
    del model, opt, x
    gc.collect()
    torch.cuda.empty_cache()

    directory = tempfile.mkdtemp(prefix="chip_smoke_z23_")
    try:
        outs = [os.path.join(directory, f"rank{r}.json") for r in range(Z_RANKS)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker",
                                   "--rank", str(r), "--world", str(Z_RANKS), "--store",
                                   os.path.join(directory, "store"), "--out", outs[r]],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(Z_RANKS)]
        try:
            texts = [p.communicate(timeout=Z_WORKER_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, text in zip(procs, texts):
            assert p.returncode == 0, text[-4000:]
        ranks = []
        for path in outs:
            with open(path) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(directory, ignore_errors=True)

    # every rank's steps against one process's: the losses (on the H100 the second step's
    # update moves the loss by 3.3e-5 relative and the ranks read within 2.7e-7 of one
    # process: 1e-6 lies between), and each parameter's update from the common start, on a
    # strided sample, within 0.05 (update_gap)
    checks = {}
    for part in ("z2", "z3"):
        for rank, r in enumerate(ranks):
            losses = r[part]["losses"]
            gaps = {k: update_gap(v, single["samples"][k], initial[k])
                    for k, v in r[part]["samples"].items()}
            worst = max(gaps, key=gaps.get)
            loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, single["losses"]))
            checks[(part, rank)] = (loss_gap, gaps)
            log(f"  {part} rank {rank}: losses {losses} against one process's "
                f"{single['losses']} (largest gap {loss_gap:.3e} relative); parameter updates "
                f"against one process's: largest gap {gaps[worst]:.3e} ({worst}), median "
                f"{float(np.median(list(gaps.values()))):.3e} over {len(gaps)} tensors")
    z3 = [r["z3"] for r in ranks]
    for rank, r in enumerate(z3):
        sp = r["spread"]
        for mode in ("default", "twice", "deterministic"):
            worst = max(sp[mode]["spread"].values())
            log(f"  z3 rank {rank}, one step's replicated gradients before the model axis's "
                f"average, {mode}: loss {sp[mode]['loss']!r}, x_hat sum "
                f"{sp[mode]['x_hat_sum']!r}; largest spread between the ranks {worst:.3e} of "
                f"the gradient's largest magnitude, {sum(v > 0 for v in sp[mode]['spread'].values())}"
                f" of {len(sp[mode]['spread'])} tensors differ")
        log(f"  z3 rank {rank}: the same gradients run twice on this rank: largest difference "
            f"{max(sp['repeat'].values()):.3e}, {sum(v > 0 for v in sp['repeat'].values())} "
            f"tensors differ")
    for (part, rank), (loss_gap, gaps) in checks.items():
        assert loss_gap <= 1e-6, (part, rank, ranks[rank][part]["losses"], single["losses"])
        assert all(v <= 0.05 for v in gaps.values()), (part, rank, gaps)
    for part in ("z2", "z3"):
        # the data axis's loss is the same global loss on every rank
        assert part == "z3" or all(r[part]["losses"] == ranks[0][part]["losses"]
                                   for r in ranks), part
    # the model axis's ranks compute the replicated gradients alike before the average: to
    # the bit with cuDNN's deterministic algorithms (a wrong backward through the split
    # layers' input gives each rank its own). cuDNN's default algorithms differ from run to
    # run on one rank (``repeat``), which is why the axis averages them; those are logged
    for r in z3:
        det = r["spread"]["deterministic"]
        assert all(v == 0 for v in det["spread"].values()), r["spread"]
        assert det["loss"] == z3[0]["spread"]["deterministic"]["loss"], r["spread"]
    z2 = [r["z2"] for r in ranks]
    sharded = {k for k, _ in z2[0]["sharded"]}
    assert {"encoder.layers.Dense_0.weight", "decoder.layers.Dense_0.weight"} <= sharded
    halved = sum(single["bytes_of"][k] for k in sharded) // Z_RANKS
    for r in z2:
        assert r["optimizer"] == "Zero1"
        assert r["moment_bytes"] == single["moment_bytes"] - halved, (r["moment_bytes"], halved)
        assert r["launches"]["moments_cluster_global_forward"] == Z_STEPS, r["launches"]
        assert r["launches"]["moments_cluster_global_backward"] == Z_STEPS, r["launches"]
    z2s = [r["z2s"] for r in ranks]
    for r in z2s:
        assert r["losses"] == z2s[0]["losses"], z2s
        assert r["launches"]["moments_cluster_perdim_forward"] == Z_STEPS, r["launches"]
        assert r["launches"]["moments_cluster_perdim_backward"] == Z_STEPS, r["launches"]
        assert r["launches"]["moments_cluster_global_forward"] == 0, r["launches"]
    for a, b in zip(z2s[0]["losses"], z2s[0]["alone"]):
        assert abs(a - b) <= 1e-4 * abs(b), z2s
    log(f"  tiny KurtosisSingle on (data 2) (gloo): losses {z2s[0]['losses']}, one process "
        f"{z2s[0]['alone']}; kernel 3 on each rank {Z_STEPS} forward, {Z_STEPS} backward")
    for r in z3:
        assert r["tp_shapes"]["encoder.layers.Dense_0.weight"] == [2000, 268800], r["tp_shapes"]
        assert r["launches"]["moments_cluster_global_forward"] == Z_STEPS, r["launches"]
        assert r["launches"]["moments_cluster_global_backward"] == Z_STEPS, r["launches"]
    for rank, (a, b) in enumerate(zip(z2, z3)):
        log(f"  rank {rank}, (data 2, model 1), ZeRO-1 (gloo): compile {a['compile_s']:.1f} s; "
            f"losses {a['losses']}; ms a step {[round(v, 3) for v in a['ms']]}; alone: the "
            f"gradients' sum {a['collective_ms']['sum_gradients']:.1f} ms, the encoder Dense's "
            f"blocks gathered {a['collective_ms']['gather_encoder_dense']:.1f} ms; moments "
            f"{a['moment_bytes']} bytes (one process {single['moment_bytes']}); "
            f"max_memory_allocated {a['peak'] / 2**30:.3f} GiB")
        log(f"  rank {rank}, (data 1, model 2) (gloo): losses {b['losses']}; ms a step "
            f"{[round(v, 3) for v in b['ms']]}; shards {b['tp_shapes']}; max_memory_allocated "
            f"{b['peak'] / 2**30:.3f} GiB")
    return {"single": single, "z2": z2, "z3": z3, "z2s": z2s}


def phase_z4(dev):
    """(z4) get_data_scale over an explicit one-device mesh on the card: 256 frames, float
    and w8a8 (kernel 10), equal to the no-mesh pass."""
    import numpy as np
    import torch

    from trustedai_cl_vae_ad_tpu_torch.anomaly.offline import get_data_scale
    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm, moments, stream_score
    from trustedai_cl_vae_ad_tpu_torch.ops.quant import serving_forward
    from trustedai_cl_vae_ad_tpu_torch.parallel.mesh import make_mesh
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config

    config = float32_flagship()
    model = load_model_from_config(config, seed=0, device=dev)
    data = {"train": [seeded_frames(dev, config, seed=3)]}
    mesh = make_mesh(devices=[dev])
    assert mesh.shape == {"data": 1, "model": 1} and not mesh.distributed
    _, tree = serving_forward(model.core, model.params, quantize=True)
    out = {}
    for quantize in (False, True):
        params = tree if quantize else None
        runs = {}
        for name, m in (("no_mesh", None), ("mesh", mesh)):
            reset_launch_counts(stream_score, moments, int8_gemm)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scale = get_data_scale(model, config, data, mesh=m, quantize=quantize,
                                   score_params=params)
            runs[name] = {"scale": scale, "s": time.perf_counter() - t0,
                          "launches": launch_counts(stream_score, moments, int8_gemm)}
        ref, got = runs["no_mesh"]["scale"], runs["mesh"]["scale"]
        for key in ("meu", "sigma", "min", "max"):
            assert abs(got[key] - ref[key]) <= 1e-5 * abs(ref[key]), (key, got[key], ref[key])
        assert got["z_scores"].shape == (BATCH,)
        np.testing.assert_allclose(got["z_scores"], ref["z_scores"], rtol=1e-4, atol=1e-4)
        mma = runs["mesh"]["launches"]["int8_gemm_mma"]
        assert mma == (2 if quantize else 0), runs["mesh"]["launches"]
        label = "w8a8" if quantize else "float"
        out[label] = {k: {"s": v["s"], "launches": v["launches"]} for k, v in runs.items()}
        log(f"  get_data_scale, {label}, {BATCH} frames: one-device mesh {runs['mesh']['s']:.3f} "
            f"s, no mesh {runs['no_mesh']['s']:.3f} s; meu {got['meu']:.6f} / {ref['meu']:.6f}; "
            f"kernel 10 under the mesh {mma} launches (mma)")
    del model, tree, data
    torch.cuda.empty_cache()
    return out


def phase_z(dev):
    """parallel/ on the card: the training CLI through a process group (z1), data
    parallelism with ZeRO-1 and tensor parallelism over two processes (z2, z3), offline
    scoring over a one-device mesh (z4)."""
    return {"z1": phase_z1(dev), "z23": phase_z23(dev), "z4": phase_z4(dev)}


ZM_STREAMS, ZM_TICKS, ZM_TRACED = 16, 32, 8
ZM_CL_RING, ZM_CL_PERIOD_MS = 4, 1000.0
# the replayed clock of the fleet CL runs: the ring fills in 4 ticks, then a step fires at the
# 4th tick and at the 8th
ZM_CL_NOW = (0.1, 0.2, 0.3, 1.05, 1.1, 1.2, 1.3, 2.1)
ZM_FP8_STEPS = 2
ZM_FP8_UPDATE_GAP = 0.25  # the bfloat16 2-step update against one process's (zm_fp8_ranks)
ZM_DENSE = {"decoder.layers.Dense_0.weight": (134400, 2000),
            "encoder.layers.Dense_0.weight": (4000, 268800)}


def zm_ticks(n_ticks):
    """n_ticks ticks of ZM_STREAMS synthetic 240x320 cameras (the device resize runs), read
    once, so that every run takes the same frames: the last camera drops every
    DROP_EVERY-th tick."""
    readers = fleet_readers(ZM_STREAMS, n_ticks)
    ticks = [[r.read() for r in readers] for _ in range(n_ticks)]
    for r in readers:
        r.release()
    return ticks


def zm_tick_run(model, config, settings, mesh, quantize, ticks):
    """The flagship fleet engine over ``mesh`` (None: no mesh), from a warm scorer state:
    ZM_TICKS ticks, counted, then ZM_TRACED more under torch.profiler for the device time.
    Returns each tick's (score, count) per stream, the tick latencies and the launches."""
    import numpy as np
    import torch

    from profile_stream_torch import analyze_trace
    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm, moments, stream_score
    from trustedai_cl_vae_ad_tpu_torch.stream.multicam import MultiCameraEngine
    from trustedai_cl_vae_ad_tpu_torch.testing import warm_score_state

    engine = MultiCameraEngine(model, config, n_streams=ZM_STREAMS, anomaly_settings=settings,
                               quantize=quantize, mesh=mesh)
    engine.warmup(frame_shape=(240, 320, 3))
    maps, scalars = warm_score_state(engine.height, engine.width)
    engine.maps = torch.from_numpy(np.stack([maps] * ZM_STREAMS)).to(engine.device)
    engine.scalars = torch.from_numpy(np.stack([scalars] * ZM_STREAMS)).to(engine.device)
    reset_launch_counts(stream_score, moments, int8_gemm)
    torch.cuda.synchronize()
    results, lat = [], []
    for i, tick in enumerate(ticks):
        t0 = time.perf_counter()
        out = engine.process_frames(tick, now=i / 20.0)  # the score fetch waits for the device
        lat.append((time.perf_counter() - t0) * 1e3)
        results.append([None if r is None else (r.score, r.pixel_count) for r in out])
    launches = launch_counts(stream_score, moments, int8_gemm)
    trace = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_zm_"), "trace.json")
    try:
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            for i, tick in enumerate(ticks[:ZM_TRACED]):
                with torch.profiler.record_function("tick"):
                    engine.process_frames(tick, now=(len(ticks) + i) / 20.0)
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            traced = analyze_trace(json.load(f)["traceEvents"], ZM_TRACED, "tick")
    finally:
        shutil.rmtree(os.path.dirname(trace), ignore_errors=True)
    blocks = len(engine.block_devices)
    del engine
    torch.cuda.empty_cache()
    kept = sorted(lat[2:])
    return {"results": results, "blocks": blocks, "launches": launches,
            "p50_ms": kept[len(kept) // 2], "p95_ms": kept[int(0.95 * (len(kept) - 1))],
            "device_ms": traced["device_busy_ms_per_frame"],
            "device_sum_ms": traced["device_sum_ms_per_frame"],
            "idle_share": traced["idle_share"]}


def zm_compare(got, ref, rtol):
    """testing.py's rule over each stream's ticks: counts within COUNT_TOL, scores at ``rtol``
    (NaN alike) while the stream's counts agree, stopping at its first differing count.
    Returns the number of scores compared."""
    import math

    from trustedai_cl_vae_ad_tpu_torch.testing import COUNT_TOL

    compared = 0
    for i in range(ZM_STREAMS):
        agreed = True
        for t, (g, r) in enumerate(zip(got, ref)):
            assert (g[i] is None) == (r[i] is None), (t, i)
            if g[i] is None:
                continue
            (gs, gc), (rs, rc) = g[i], r[i]
            assert abs(gc - rc) <= COUNT_TOL, (t, i, gc, rc)
            agreed = agreed and gc == rc
            if not agreed:
                continue
            assert math.isnan(gs) == math.isnan(rs), (t, i, gs, rs)
            if not math.isnan(rs):
                assert abs(gs - rs) <= rtol * abs(rs), (t, i, gs, rs)
                compared += 1
    return compared


def zm_kernels_at_the_blocks(dev):
    """Kernels 1 and 10 at the shapes a block of a two-entry mesh gives them, against their
    plain versions: the batched scorer at K = ZM_STREAMS / 2 frames (4 ticks with a dropped
    frame, from the warm state), the int8 products at M = ZM_STREAMS / 2 rows."""
    import numpy as np
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm as ig
    from trustedai_cl_vae_ad_tpu_torch.ops import stream_score as ss
    from trustedai_cl_vae_ad_tpu_torch.ops.quant import _I32_SAFE_K
    from trustedai_cl_vae_ad_tpu_torch.testing import compare_sequences, warm_score_state

    k, (h, w, c) = ZM_STREAMS // 2, SEQ_SHAPES[0]
    gen = torch.Generator(device=dev).manual_seed(31)
    imgs = torch.rand((4, k, h, w, c), device=dev, generator=gen)
    recs = (imgs + 0.05 * torch.randn(imgs.shape, device=dev, generator=gen)).clamp(0, 1)
    valid = torch.ones((4, k), dtype=torch.bool, device=dev)
    valid[2, 3] = False
    maps0, scalars0 = (torch.from_numpy(np.stack([a] * k)).to(dev)
                       for a in warm_score_state(h, w))
    runs = {}
    for name, fn in (("kernel", ss.stream_score_step_batched),
                     ("plain", ss.stream_score_step_batched_reference)):
        maps, scalars, outs = maps0, scalars0, []
        for t in range(4):
            maps, scalars, norm, sc = fn(maps, scalars, imgs[t], recs[t], ALPHA, valid[t])
            outs.append((maps.cpu().numpy(), scalars.cpu().numpy(), norm.cpu().numpy(),
                         sc.cpu().numpy()))
        runs[name] = outs
    scorer_err = 0.0
    for i in range(k):
        def stream(outs):
            return [(o[0][i], o[1][i], o[2][i], float(o[3][i, 0]), float(o[3][i, 1]))
                    for o in outs]
        scorer_err = max(scorer_err, compare_sequences(stream(runs["kernel"]),
                                                       stream(runs["plain"]), f"block stream {i}"))
    shapes = []
    for kk, n in ((268800, 4000), (2000, 134400)):
        x = torch.randint(-127, 128, (k, kk), device=dev, generator=gen,
                          dtype=torch.int32).to(torch.int8)
        wt = torch.randint(-127, 128, (n, kk), device=dev, generator=gen,
                           dtype=torch.int32).to(torch.int8)
        assert ig.int8_gemm_arrangement(x, wt, 0, kk, _I32_SAFE_K) == "mma"
        got = ig.int8_gemm_chunked(x, wt, _I32_SAFE_K)
        ref = ig.int8_gemm_chunked_reference(x, wt, _I32_SAFE_K)
        assert torch.equal(got, ref), (kk, n)
        shapes.append((k, kk, n))
    log(f"  kernel 1 at a block's K = {k} (224x300x3, 4 ticks, one frame dropped) against its "
        f"plain version: max_abs_err {scorer_err:.3g}; kernel 10 at (M, K, N) {shapes}: equal "
        f"to the plain int8 products")


def zm_fleet_cl(dev, config, settings, ticks):
    """Fleet CL at the flagship over the two-entry mesh against no mesh: K = ZM_STREAMS, a
    ring of ZM_CL_RING ticks, 8 ticks with a step at the 4th and the 8th, each from a fresh
    model of seed 0 (the same weights and generator, so the same latent noise). Returns the
    losses, the strided parameter samples before and after, each step's ms and the peak."""
    import gc

    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm, moments, stream_score
    from trustedai_cl_vae_ad_tpu_torch.parallel.mesh import make_mesh
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config_path
    from trustedai_cl_vae_ad_tpu_torch.stream.multicam import MultiCameraEngine

    runs, initial = {}, None
    for name, mesh in (("none", None), ("two", make_mesh(devices=[dev, dev]))):
        model, _ = load_model_from_config_path(os.path.join(REPO, "configs", "config.yml"),
                                               seed=0, device=dev)
        if initial is None:
            initial = param_samples(model)
        engine = MultiCameraEngine(model, config, n_streams=ZM_STREAMS, anomaly_settings=settings,
                                   cl_ring_ticks=ZM_CL_RING,
                                   continuous_learning_period_ms=ZM_CL_PERIOD_MS, mesh=mesh)
        engine.enable_cont_learning = True
        steps, do_step = [], engine._do_cl_step

        def timed_step(do_step=do_step, steps=steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = do_step()  # its loss fetch waits for the device
            steps.append(((time.perf_counter() - t0) * 1e3, loss))
            return loss

        engine._do_cl_step = timed_step
        reset_launch_counts(stream_score, moments, int8_gemm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for tick, now in zip(ticks, ZM_CL_NOW):
            engine.process_frames(tick, now=now)
        torch.cuda.synchronize()
        assert engine.cl_epochs == len(steps) == 2, steps
        runs[name] = {"losses": [loss["loss"] for _ms, loss in steps],
                      "step_ms": [ms for ms, _loss in steps],
                      "peak": torch.cuda.max_memory_allocated(),
                      "launches": launch_counts(stream_score, moments, int8_gemm),
                      "samples": param_samples(model)}
        # timed_step holds the engine (and its model and moments) through do_step
        del engine, model, steps, do_step, timed_step
        gc.collect()
        torch.cuda.empty_cache()
    return runs, initial


def update_gap(got, ref, start):
    """|d - d_one| / |d_one| of a parameter's update from ``start`` on a strided sample (a
    skipped or wrong update gives about 1; Adam's early steps are +-lr, so rounding moves it
    only where a gradient's sign flips)."""
    import numpy as np

    d = np.asarray(got) - np.asarray(start)
    d_one = np.asarray(ref) - np.asarray(start)
    norm = float(np.linalg.norm(d_one))
    return float(np.linalg.norm(d - d_one)) / norm if norm else float(np.linalg.norm(d))


def fp8_flagship():
    """The flagship in bfloat16 with training.optimizer adam_fp8."""
    from trustedai_cl_vae_ad_tpu_torch.train.bench_step import flagship_config

    config = flagship_config()
    config["training"].update(precision="bfloat16", optimizer="adam_fp8")
    return config


def fp8_leaf_bytes(optimizer):
    """{parameter: {"fp8": bytes of its moments' float8 codes, "other": the rest}} on this
    rank (a ZeRO-1 optimizer's blocks)."""
    from trustedai_cl_vae_ad_tpu_torch.ops.adam8 import QLeaf

    inner = getattr(optimizer, "inner", optimizer)
    out = {}
    for name, mu, nu in zip(inner.names, inner.mu, inner.nu):
        fp8 = other = 0
        for m in (mu, nu):
            if isinstance(m, QLeaf):
                fp8 += m.q.numel()
                other += sum(t.numel() * t.element_size() for t in (m.scale, m.scale_next))
            else:
                other += m.numel() * m.element_size()
        out[name] = {"fp8": fp8, "other": other}
    return out


def fp8_sharded_bits(dev, world):
    """On identical injected gradients (drawn alike on every rank), the flagship's two Dense
    weights in bfloat16, ZM_FP8_STEPS steps of adam_fp8 through ZeRO-1 over (data world) and
    through a (data 1, model world) mesh: whether this rank's blocks of q, scale, scale_next
    and the parameter equal the same blocks of one process's AdamFp8 steps on the whole
    leaf (every rank of the pair takes part: the collectives)."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops.adam import make_optimizer
    from trustedai_cl_vae_ad_tpu_torch.ops.adam8 import AdamFp8, map_moment
    from trustedai_cl_vae_ad_tpu_torch.parallel import tp, zero
    from trustedai_cl_vae_ad_tpu_torch.parallel.collectives import rank_slice
    from trustedai_cl_vae_ad_tpu_torch.parallel.mesh import make_mesh

    meshes = {"zero1": make_mesh(world, 1, devices=[dev]), "model": make_mesh(1, world, devices=[dev])}
    out = {part: {} for part in meshes}
    for name, shape in ZM_DENSE.items():
        gen = torch.Generator(device=dev).manual_seed(11)
        w = (torch.randn(shape, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        grads = [(torch.randn(shape, generator=gen, device=dev) * 1e-3
                  * (1 + 99 * (i == 1))).to(torch.bfloat16) for i in range(ZM_FP8_STEPS)]
        whole = {name: w.clone()}
        ref = AdamFp8(whole, 1e-3)
        for g in grads:
            ref.step([g])
        for part, mesh in meshes.items():
            tp_dims = tp.param_shardings({name: w}, mesh)
            local = {name: tp.shard_tensor(w, tp_dims[name], mesh).clone()}
            if part == "zero1":
                opt = zero.Zero1(local, 1e-3, mesh, name="adam_fp8", tp_dims=tp_dims)
                inner, dim, group = opt.inner, opt.dims[name], mesh.data_group
                block = whole[name]  # the updated blocks are gathered into every rank's whole
            else:
                opt = make_optimizer(local, 1e-3, name="adam_fp8",
                                     regions=zero.block_regions(local, mesh, tp_dims))
                inner, dim, group = opt, tp_dims[name], mesh.model_group
                block = rank_slice(whole[name], dim, group)
            assert dim is not None, (part, name)
            for g in grads:
                opt.step([tp.shard_tensor(g, tp_dims[name], mesh)])
            same = torch.equal(local[name], block)
            for kind in ("mu", "nu"):
                mine = inner.full_moment(kind, name)
                want = map_moment(ref.full_moment(kind, name), name, dim,
                                  lambda t, d: t if d is None else rank_slice(t, d, group))
                same = same and all(torch.equal(mine[f], want[f]) for f in want)
            out[part][name] = same
            del opt, inner, local, block
        del w, grads, whole, ref
        torch.cuda.empty_cache()
    return out


def zm_worker(rank, world, store, out):
    """One of phase (zm)'s two ranks on the one card: the injected-gradient bits, then the
    flagship's bfloat16 adam_fp8 steps with ZeRO-1 and on a model axis; writes its figures
    as JSON to ``out``."""
    import gc

    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm, moments, stream_score
    from trustedai_cl_vae_ad_tpu_torch.parallel.mesh import (
        distributed_teardown,
        initialize_distributed,
        make_mesh,
    )
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config, use_full_float32

    use_full_float32()  # as in the process it is held against
    torch.backends.cudnn.deterministic = True  # as there (zm_fp8_ranks says why)
    dev = torch.device("cuda", 0)
    initialize_distributed(f"file://{store}", world, rank, backend="gloo", device=dev)
    result = {"bits": fp8_sharded_bits(dev, world)}
    config = fp8_flagship()
    x = seeded_frames(dev, config)
    for part, shape, zero1 in (("zero1", (world, 1), True), ("model", (1, world), False)):
        model = load_model_from_config(config, seed=0, device=dev)
        model.compile(mesh=make_mesh(*shape, devices=[dev]), zero1=zero1)
        reset_launch_counts(stream_score, moments, int8_gemm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = timed_steps(model, x, ZM_FP8_STEPS)
        opt = model.optimizer
        result[part] = {
            "losses": losses, "ms": ms, "peak": torch.cuda.max_memory_allocated(),
            "optimizer": type(opt).__name__, "bytes": fp8_leaf_bytes(opt),
            "zero1_dims": dict(opt.sharded()) if zero1 else {},
            "tp_dims": {k: d for k, d in model.tp_dims.items() if d is not None},
            "samples": param_samples(model),
            "launches": launch_counts(stream_score, moments, int8_gemm)}
        del model, opt
        gc.collect()
        torch.cuda.empty_cache()
    distributed_teardown()
    with open(out, "w") as f:
        json.dump(result, f)
    return 0


def zm_fp8_ranks(dev):
    """adam_fp8 on two gloo ranks of the one card against one process: the flagship in
    bfloat16, ZM_FP8_STEPS steps of one seeded 256-frame batch with ZeRO-1 (data 2) and on a
    (data 1, model 2) mesh, through the (z2)/(z3) worker harness."""
    import gc

    import numpy as np
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops.adam8 import AdamFp8
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config

    config = fp8_flagship()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    # cuDNN's default algorithms give other bits from run to run (phase z3): the one process
    # and the ranks run deterministic ones, so that a model axis's replicated layers compute
    # what the one process computes, and only the mesh's sums differ
    torch.backends.cudnn.deterministic = True
    try:
        model = load_model_from_config(config, seed=0, device=dev)
        model.compile()
        assert isinstance(model.optimizer, AdamFp8)
        x = seeded_frames(dev, config)
        initial = param_samples(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = timed_steps(model, x, ZM_FP8_STEPS)
    finally:
        torch.backends.cudnn.deterministic = False
    single = {"losses": losses, "ms": ms, "peak": torch.cuda.max_memory_allocated(),
              "resident_before": resident, "bytes": fp8_leaf_bytes(model.optimizer),
              "samples": param_samples(model)}
    log(f"  one process, bfloat16 adam_fp8, batch {BATCH}, cudnn.deterministic: losses {losses}; "
        f"ms a step {[round(v, 3) for v in ms]}; max_memory_allocated "
        f"{single['peak'] / 2**30:.3f} GiB ({resident / 2**30:.3f} GiB allocated before)")
    del model, x
    gc.collect()
    torch.cuda.empty_cache()

    directory = tempfile.mkdtemp(prefix="chip_smoke_zm_")
    try:
        outs = [os.path.join(directory, f"rank{r}.json") for r in range(Z_RANKS)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker",
                                   "--job", "zm", "--rank", str(r), "--world", str(Z_RANKS),
                                   "--store", os.path.join(directory, "store"), "--out", outs[r]],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(Z_RANKS)]
        try:
            texts = [p.communicate(timeout=Z_WORKER_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, text in zip(procs, texts):
            assert p.returncode == 0, text[-4000:]
        ranks = []
        for path in outs:
            with open(path) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(directory, ignore_errors=True)

    for rank, r in enumerate(ranks):
        log(f"  rank {rank}, injected gradients, {ZM_FP8_STEPS} steps: this rank's blocks of q, "
            f"scale, scale_next and the parameter equal one process's AdamFp8: {r['bits']}")
    checks = {}
    for part in ("zero1", "model"):
        for rank, r in enumerate(ranks):
            got = r[part]
            loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], single["losses"]))
            gaps = {k: update_gap(v, single["samples"][k], initial[k])
                    for k, v in got["samples"].items()}
            worst = max(gaps, key=gaps.get)
            checks[(part, rank)] = (loss_gap, gaps)
            split = got["zero1_dims"] if part == "zero1" else got["tp_dims"]
            log(f"  {part} rank {rank} ({got['optimizer']}): losses {got['losses']} against one "
                f"process's {single['losses']} (largest gap {loss_gap:.3e} relative); parameter "
                f"updates: largest gap {gaps[worst]:.3e} ({worst}), median "
                f"{float(np.median(list(gaps.values()))):.3e} over {len(gaps)} tensors; ms a "
                f"step {[round(v, 3) for v in got['ms']]}; max_memory_allocated "
                f"{got['peak'] / 2**30:.3f} GiB; split {split}; float8 bytes of the split "
                f"leaves {sum(got['bytes'][k]['fp8'] for k in split)} (one process "
                f"{sum(single['bytes'][k]['fp8'] for k in split)})")
    for r in ranks:
        assert all(v for part in r["bits"].values() for v in part.values()), r["bits"]
    # the optimizer's bits on the same gradients are checked above. In bfloat16, Adam's first
    # two steps move an entry by about +-lr, and the gradients' extra bfloat16 rounding on a
    # mesh (each rank's partial sum, then their sum) flips the sign of near-zero gradients:
    # on an H100 (80GB HBM3, 700 W) the 2-step update gaps read 0.088 (ZeRO-1) and 0.179 (the
    # model axis) with default and with deterministic cuDNN alike, where float32 reads 0.0075
    # (z2). A skipped or wrong update gives about 1; the bound for this bfloat16 run is 0.25
    for (part, rank), (loss_gap, gaps) in checks.items():
        assert loss_gap <= 1e-6, (part, rank, ranks[rank][part]["losses"], single["losses"])
        assert all(v <= ZM_FP8_UPDATE_GAP for v in gaps.values()), (part, rank, gaps)
    assert all(r["zero1"]["losses"] == ranks[0]["zero1"]["losses"] for r in ranks)
    for r in ranks:
        z, m = r["zero1"], r["model"]
        assert z["optimizer"] == "Zero1" and m["optimizer"] == "AdamFp8"
        assert set(ZM_DENSE) <= set(z["zero1_dims"]) and set(ZM_DENSE) <= set(m["tp_dims"])
        for name, want in single["bytes"].items():
            if name in z["zero1_dims"]:  # the codes and the scales' columns both halved
                assert z["bytes"][name] == {"fp8": want["fp8"] // 2,
                                            "other": want["other"] // 2}, name
            else:
                assert z["bytes"][name] == want, name
            if name in m["tp_dims"]:  # the codes halved; a scale row is whole on each rank
                assert m["bytes"][name]["fp8"] == want["fp8"] // 2, name
        for part in (z, m):
            assert part["launches"]["moments_cluster_global_forward"] == ZM_FP8_STEPS
            assert part["launches"]["moments_cluster_global_backward"] == ZM_FP8_STEPS


def phase_zm(dev):
    """The multi-camera engine on a device mesh and adam_fp8 on two ranks: (zm1) the
    flagship fleet's tick in float and w8a8 with no mesh, a one-entry and a two-entry mesh
    of the one card; (zm2) kernels 1 and 10 at a block's shapes; (zm3) fleet CL over the
    two-entry mesh against no mesh; (zm4) adam_fp8 with ZeRO-1 and on a model axis."""
    import gc

    import torch

    from trustedai_cl_vae_ad_tpu_torch.parallel.mesh import make_mesh
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config_path
    from trustedai_cl_vae_ad_tpu_torch.stream.run import resolve_camera

    torch.cuda.empty_cache()
    model, config = load_model_from_config_path(os.path.join(REPO, "configs", "config.yml"),
                                                seed=0, device=dev)
    settings = resolve_camera(os.path.join(REPO, "configs", "cam_config.yml"))[0]
    ticks = zm_ticks(ZM_TICKS)
    meshes = {"none": None, "one": make_mesh(devices=[dev]), "two": make_mesh(devices=[dev, dev])}
    mesh_launches = {}

    def add(counts):  # the launches of a run over a mesh, summed
        for kernel, n in counts.items():
            mesh_launches[kernel] = mesh_launches.get(kernel, 0) + n

    ticks_out = {}
    for quantize, label in ((False, "float"), (True, "w8a8")):
        runs = {name: zm_tick_run(model, config, settings, mesh, quantize, ticks)
                for name, mesh in meshes.items()}
        rtol = W8A8_EPS_RTOL if quantize else 1e-5
        for name in ("one", "two"):
            run = runs[name]
            d = run["blocks"]
            assert d == {"one": 1, "two": 2}[name]
            n = run["launches"]
            # kernel 1: one batched launch a block a tick; kernel 10: two a block a w8a8 tick
            assert n["stream_score_cluster"] == d * ZM_TICKS and n["stream_score"] == 0, n
            assert n["int8_gemm_mma"] == (2 * d * ZM_TICKS if quantize else 0), n
            assert n["int8_gemm"] == 0, n
            run["compared"] = zm_compare(run["results"], runs["none"]["results"], rtol)
            assert run["compared"] > 0
            add(n)
        for name, run in runs.items():
            log(f"  {label}, mesh {name} ({run['blocks']} block(s) of "
                f"{ZM_STREAMS // run['blocks']}): tick p50 {run['p50_ms']:.3f} ms p95 "
                f"{run['p95_ms']:.3f} ms; device busy {run['device_ms']:.3f} ms a tick (kernels "
                f"{run['device_sum_ms']:.3f} ms), idle {run['idle_share']:.1%}; launches "
                f"kernel 1 {run['launches']['stream_score_cluster']}, kernel 10 "
                f"{run['launches']['int8_gemm_mma']}"
                + (f"; {run['compared']} scores against no mesh's within {rtol:g}"
                   if name != "none" else ""))
        ticks_out[label] = {name: {k: v for k, v in run.items() if k != "results"}
                            for name, run in runs.items()}
    del model
    gc.collect()
    torch.cuda.empty_cache()

    zm_kernels_at_the_blocks(dev)

    cl, initial = zm_fleet_cl(dev, config, settings, ticks)
    none, two = cl["none"], cl["two"]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(two["losses"], none["losses"]))
    gaps = {k: update_gap(v, none["samples"][k], initial[k]) for k, v in two["samples"].items()}
    worst = max(gaps, key=gaps.get)
    add(two["launches"])
    log(f"  fleet CL, {ZM_STREAMS} cameras, ring of {ZM_CL_RING} ticks ({ZM_CL_RING * ZM_STREAMS}"
        f" rows), 2 steps: losses two-entry mesh {two['losses']}, no mesh {none['losses']} "
        f"(largest gap {loss_gap:.3e} relative); parameter updates: largest gap "
        f"{gaps[worst]:.3e} ({worst}); step ms mesh {[round(v, 1) for v in two['step_ms']]}, no "
        f"mesh {[round(v, 1) for v in none['step_ms']]}; max_memory_allocated mesh "
        f"{two['peak'] / 2**30:.2f} GiB, no mesh {none['peak'] / 2**30:.2f} GiB")
    assert loss_gap <= 1e-6, (two["losses"], none["losses"])
    assert all(v <= 0.05 for v in gaps.values()), gaps
    assert two["launches"]["stream_score_cluster"] == 2 * len(ZM_CL_NOW), two["launches"]

    zm_fp8_ranks(dev)
    return {"ticks": ticks_out, "launches": mesh_launches}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--phases", default=None,
                        help="comma-separated subset of c..z to run after the build (for "
                             "finding a fault); the final line is then not printed")
    parser.add_argument("--worker", action="store_true",
                        help="(internal) run one rank of phase (z)'s or (zm)'s two-process "
                             "runs")
    parser.add_argument("--job", choices=("z", "zm"), default="z",
                        help="(internal) which phase's ranks --worker runs")
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--world", type=int, default=Z_RANKS)
    parser.add_argument("--store", default=None)
    parser.add_argument("--out", default=None)
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
    if args.worker:
        worker = zm_worker if args.job == "zm" else z_worker
        return worker(args.rank, args.world, args.store, args.out)
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

    from trustedai_cl_vae_ad_tpu_torch.ops import (
        _build,
        conv_dw,
        dense_grad_adam,
        int8_gemm,
        moments,
        stream_score,
    )

    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:  # one nvcc for each source, started together
        list(pool.map(lambda build: build(),
                      (stream_score.build, stream_score.build_cluster, moments.build,
                       moments.build_blocks, int8_gemm.build, int8_gemm.build_mma, dense_grad_adam.build,
                       dense_grad_adam.build_wgmma, conv_dw.build, conv_dw.build_wgmma)))
    log(f"  stream_score, stream_score_cluster, moments_cluster, moments, int8_gemm, int8_gemm_mma, "
        f"dense_grad_adam, dense_grad_wgmma, conv_dw and conv_dw_wgmma built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    for kernel in ("stream_score", "stream_score_cluster", "moments_cluster", "moments", "int8_gemm",
                   "int8_gemm_mma", "dense_grad_adam", "dense_grad_wgmma", "conv_dw",
                   "conv_dw_wgmma"):
        for line in _build.build_log.get(kernel, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {kernel}: {line.strip()}")

    dev = torch.device("cuda")
    out = {}

    def run(phase, title, fn):
        if only is None or phase in only:
            t0 = time.perf_counter()
            log(f"[{phase}] {title}")
            out[phase] = fn()
            log(f"  ({time.perf_counter() - t0:.1f} s)")

    run("c", "stream-scorer kernels vs plain version on the card", lambda: phase_c(dev))
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
    run("m", "int8 GEMM kernel vs plain version on the card", lambda: phase_m(dev))
    run("n", "batched stream-scorer kernels vs plain batched version", lambda: phase_n(dev))
    run("o", "tiny multi-camera engine: cuda vs cpu, float and w8a8; the int8 sidecar", phase_o)
    run("p", "flagship int8 serving and the multi-camera tick", phase_p)
    run("q", "dense-update kernels vs plain versions on the card", lambda: phase_q(dev))
    run("r", "the dense-update probes at full width", lambda: phase_r(dev))
    run("s", "convolution weight-gradient kernel vs plain version on the card",
        lambda: phase_s(dev))
    run("t", "the convolution weight-gradient probe through the flagship train step",
        lambda: phase_t(dev))
    run("u", "crash-atomic checkpoint rounds and the background saver", lambda: phase_u(dev))
    run("v", "the live application's persistence, recording and fleet CL at the flagship",
        phase_v)
    run("w", "the scoring surfaces at the flagship: serve_torch.py and the offline CLI",
        lambda: phase_w(dev))
    run("x", "JAX-written log directories on the card; configs/raite.yml on COCO-JSON frames "
        "with the device cache", lambda: phase_x(dev))
    run("y", "the dataset builders and configs/veri.yml with adam_fp8; the flagship's bf16 step "
        "with adam_fp8 beside adam_lean", lambda: phase_y(dev))
    run("z", "parallel/: train_torch.py through a process group, two processes with ZeRO-1 "
        "and with a model axis, offline scoring over a mesh", lambda: phase_z(dev))
    run("zm", "the multi-camera engine on a device mesh; adam_fp8 with ZeRO-1 and on a model "
        "axis over two processes", lambda: phase_zm(dev))
    log(f"all phases in {time.perf_counter() - t_start:.1f} s")
    if only is not None:
        print(f"partial run (phases {sorted(out)}): no result line")
        return 0

    # launches of each kernel on the path that runs it, counted from zero
    # just before that path: (e) for the scorer by arrangement (and (l)'s CL stream and
    # (p)'s w8a8 ticks and frames and (v)'s persistence stream and fleet CL ticks beside it),
    # (h) for the global moments,
    # (k) with KurtosisSingle for the per-dimension moments, (p)'s w8a8
    # multi-camera run for the int8 GEMM's tensor-core arrangement (and the scorer's
    # batched launches; the single-stream w8a8 run's beside it), (o)'s tiny w8a8
    # multi-camera run for its CUDA-core arrangement (the flagship's beside it),
    # (r) for the six dense-update kernels, (t) for the convolution weight gradient: its
    # CUDA-core kernel with conv1's times, its tensor-core kernel with conv2's (and the
    # CUDA-core kernel's on the same operands beside them); (w)'s w8a8 server and w8a8
    # offline CLI for the int8 GEMM's launches_serve and launches_offline, with its times at
    # the offline batch's shapes; (x)'s two paths are added to each entry below
    global_launches, perdim_launches = out["h"]["arrangements"], out["k"][0]["arrangements"]
    _, _, fleet_int8 = out["p"]["launches"]
    frame_int8 = out["p"]["frame_int8_arrangements"]

    def scorer_entry(kernel, arrangement):
        # (p) runs float, then w8a8, then from the int8 boot: [1] is the w8a8 run
        return dict(kernel, launches=out["e"][0][arrangement],
                    launches_cl_stream=out["l"][arrangement],
                    launches_fleet_ticks=out["p"]["tick_scorer"][1][arrangement],
                    launches_frames=out["p"]["frame_scorer"][1][arrangement],
                    launches_persistence=out["v"]["single"]["launches"][arrangement],
                    launches_fleet_cl_ticks=out["v"]["fleet"]["launches"][arrangement],
                    batched=out["n"][arrangement], **out["c"][arrangement])
    tiny_int8 = out["o"]["int8_arrangements"]
    kernels = [
        scorer_entry(STREAM_CLUSTER_KERNEL, "cluster"),
        scorer_entry(STREAM_KERNEL, "block"),
        dict(INT8_MMA_KERNEL, launches=fleet_int8["mma"], launches_frames=frame_int8["mma"],
             launches_serve=out["w"]["launches_serve"],
             launches_offline=out["w"]["launches_offline"],
             offline_shapes=out["w"]["offline_shapes"], **out["m"]["mma"]),
        dict(INT8_KERNEL, launches=tiny_int8["cuda_core"], launches_fleet_ticks=fleet_int8[
            "cuda_core"], launches_frames=frame_int8["cuda_core"], **out["m"]["cuda_core"]),
        *moments_entries("global", out["f"], global_launches),
        *moments_entries("perdim", out["i"], perdim_launches),
        *(dict(source, name=name, replaces=replaces, launches=out["r"]["launches"][counter],
               **out["q"][counter]) for name, (counter, replaces, source) in DGA_KERNELS.items()),
        dict(CONV_DW_KERNEL, launches=out["t"]["arrangements"]["cuda_core"],
             **out["s"]["conv1"]),
        dict(CONV_DW_WGMMA_KERNEL, launches=out["t"]["arrangements"]["wgmma"],
             **out["s"]["conv2"]),
    ]
    # (x)'s two paths, each counted from zero: the JAX-written directories' load, forward,
    # engine, w8a8 and training step; raite.yml's training on COCO-JSON frames
    for entry in kernels:
        entry["launches_jax_logdir"] = out["x"]["jax_logdir"].get(entry["name"], 0)
        entry["launches_raite"] = out["x"]["raite"].get(entry["name"], 0)
    # (y)'s two paths, each counted from zero: veri.yml's training on builder-made frames with
    # adam_fp8, and the flagship's 13 bf16 train + score steps with adam_fp8
    for entry in kernels:
        entry["launches_veri"] = out["y"]["y1"]["launches"].get(entry["name"], 0)
        entry["launches_fp8_step"] = out["y"]["y2"]["runs"]["adam_fp8"]["launches"].get(
            entry["name"], 0)
    # (z)'s paths, each counted from zero: the training CLI through a process group of one
    # (z1), the two ranks of the ZeRO-1 and the model-axis runs summed (z2, z3), offline
    # scoring over a one-device mesh in w8a8 (z4)
    z = out["z"]
    for entry in kernels:
        kernel = entry["name"]
        entry["launches_parallel_cli"] = z["z1"]["parallel"]["launches"].get(kernel, 0)
        entry["launches_zero1_ranks"] = sum(r["launches"].get(kernel, 0)
                                            for r in z["z23"]["z2"])
        entry["launches_tiny_single_ranks"] = sum(r["launches"].get(kernel, 0)
                                                  for r in z["z23"]["z2s"])
        entry["launches_model_axis_ranks"] = sum(r["launches"].get(kernel, 0)
                                                 for r in z["z23"]["z3"])
        entry["launches_offline_mesh"] = z["z4"]["w8a8"]["mesh"]["launches"].get(kernel, 0)
    # (zm)'s runs over a mesh, each counted from zero and summed: the fleet's ticks over the
    # one-entry and the two-entry mesh in float and w8a8, and fleet CL over the two-entry mesh
    for entry in kernels:
        entry["launches_multicam_mesh"] = out["zm"]["launches"].get(entry["name"], 0)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
