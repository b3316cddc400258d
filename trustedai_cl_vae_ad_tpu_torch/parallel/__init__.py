"""Data parallelism, ZeRO-1 and tensor parallelism on ``torch.distributed``.

Counterpart of ``trustedai_cl_vae_ad_tpu/parallel/``. The JAX package writes
one SPMD program over a device mesh and lets GSPMD derive the collectives;
here each rank is one process with one device, and the collectives are
explicit: ``mesh`` (the (data, model) grid and its process groups),
``collectives`` (the autograd-aware gathers and sums that make the losses'
batch statistics global), ``dp`` (the train, eval and forward steps), ``zero``
(ZeRO-1 moments) and ``tp`` (column-sharded Dense layers).
"""
