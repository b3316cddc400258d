"""PyTorch/CUDA port of the Kurtosis-CVAE anomaly-detection framework.

The JAX package ``trustedai_cl_vae_ad_tpu`` beside this one is the reference
the port is held against; this package imports torch and never jax. Ported
so far: the live-stream scoring path (model forward, device resize, the
stream-scorer CUDA kernel, the single-stream engine), the training path of
the three model types (losses, the moments CUDA kernels, Adam, the training
loop, checkpoints), continual learning in the live engine, int8 serving (the
int8 GEMM CUDA kernel, the quantized sidecar of a log directory) and the
multi-camera engine's scoring tick. ROADMAP.md lists what is still to come.

Layer map:
  config & registry   -> .config / .registry (+ .bridge for flax weights and moments)
  model core          -> .models.cvae, .models.kurtosis_global, .models.kurtosis_single,
                         .models.kl_gaussian, .models.batch_stats, .models.wrapper
  ops                 -> .ops.convt, .ops.quant, .ops.int8_gemm, .ops.stream_score,
                         .ops.moments (+ csrc/), .ops.adam, .ops.adam8
  data                -> .data.loader, .data.saved_dataset, .data.ingest, .data.builders
  training            -> .train.loop, .train.checkpoint, .train.bench_step, .utils.metrics
  several devices     -> .parallel.mesh, .parallel.collectives, .parallel.dp, .parallel.zero,
                         .parallel.tp
  live stream         -> .stream.engine, .stream.multicam, .stream.run
"""

from trustedai_cl_vae_ad_tpu_torch.registry import (  # noqa: F401
    import_vae_based_on_type,
    load_model_from_config,
    load_model_from_config_path,
    load_model_from_directory,
)
