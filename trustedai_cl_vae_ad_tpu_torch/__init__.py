"""PyTorch/CUDA port of the Kurtosis-CVAE anomaly-detection framework.

The JAX package ``trustedai_cl_vae_ad_tpu`` beside this one is the reference
the port is held against; this package imports torch and never jax. Ported
so far: the live-stream scoring path (model forward, device resize, the
stream-scorer CUDA kernel, the single-stream engine). ROADMAP.md lists what
is still to come.

Layer map:
  config & registry   -> .config / .registry (+ .bridge for flax weights)
  model core          -> .models.cvae, .models.wrapper
  ops                 -> .ops.convt, .ops.quant, .ops.stream_score (+ csrc/)
  data                -> .data.ingest (device resize)
  live stream         -> .stream.engine, .stream.run
"""

from trustedai_cl_vae_ad_tpu_torch.registry import (  # noqa: F401
    import_vae_based_on_type,
    load_model_from_config,
    load_model_from_config_path,
)
