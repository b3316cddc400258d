"""Forward selection for the serving and scoring paths.

Only the float branch of ``trustedai_cl_vae_ad_tpu/ops/quant.py::
serving_forward`` is ported; the int8 path is ROADMAP queue 1 item 13.
"""

from __future__ import annotations


def serving_forward(core, params: dict, quantize: bool = False):
    """``(forward_fn, serve_params)`` with ``forward_fn(params, x)`` the eval
    forward of ``core`` (x: NHWC batch). The float forward runs the module
    on the parameters it holds; ``params`` is passed through unchanged, as the
    int8 branch will pass its quantized tree."""
    if quantize:
        raise NotImplementedError(
            "int8 serving is not ported yet (ROADMAP.md queue 1 item 13)")
    return (lambda _p, x: core(x)), params
