"""The JAX-written log directories that the port reads, and what the JAX
package computes from them.

``python tests/torch_jax_logdir_fixtures.py`` (JAX on the CPU) writes, under
``tests/data/jax_logdirs/``:

  * ``global_f32/``: KurtosisGlobal, float32 parameters, ``adam``; two
    training steps taken, then the learning rate dialled from the config's
    1e-3 to 2.5e-4; ``train_state.json``; a ``w8a8`` ``quantized/`` sidecar
    with both Dense layers in int8 (``min_elems`` 0; their contractions, 768
    and 16, are multiples of 16, so the int8 GEMM's tensor-core arrangement
    takes them);
  * ``single_bf16/``: KurtosisSingle, bfloat16 parameters, ``adam_lean``,
    the same two steps and learning rate;
  * beside each, ``<name>.npz``: the JAX package's outputs from that
    directory, restored with ``restore_optimizer=True``: the input frames,
    the eval reconstructions, the live engine's scores and counts on them
    from a warm scorer state, the ``w8a8`` reconstructions (``global_f32``),
    and one training step on the frames: its latent noise, its loss dict, and
    the parameters, the Adam moments and the step count after it;
  * ``converted/<name>/``: each directory in the port's own layout, written
    by ``tools/convert_logdir_torch.py`` (a machine without tensorstore reads
    those with torch alone).

The frames and every seed come from numpy. ``tests/test_torch_jax_logdir.py``
restores each committed directory with the JAX package and recomputes its
``.npz`` (``jax_outputs``), so the fixtures cannot drift from the package.
"""

import json
import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DATA = os.path.join(HERE, "data", "jax_logdirs")
LEARNING_RATE = 2.5e-4
N_FRAMES = 8
SETTINGS = {"anomaly_score_threshold": 2.0, "anomaly_score_method": "zz_count",
            "buffer_record_period_s": 1.0, "anomalous_state_period_s": 0.05}


def fixture_config(name: str) -> dict:
    """The config of fixture ``name``: the tests' tiny model (32x48x3,
    layers [4, 8], latent 16, decoder_dense_filters 4)."""
    model_type, precision = {"global_f32": ("KurtosisGlobal", None),
                             "single_bf16": ("KurtosisSingle", "bfloat16")}[name]
    training = {"batch_size": N_FRAMES, "beta": 1e-6, "learning_rate": 1e-3, "max_epochs": 1}
    if precision:
        training["precision"] = precision
    return {
        "data": {"image_size": [32, 48, 3]},
        "loss": {"kurtosis": 1.8, "w_kl_divergence": 0.0, "w_kurtosis": 1e-2,
                 "w_mse": 1.0, "w_skew": 5e-3, "w_z_l1_reg": 1e-3},
        "model": {"type": model_type, "decoder_dense_filters": 4, "latent_dimensions": 16,
                  "layers": [4, 8]},
        "training": training,
    }


def frames(seed: int = 7) -> np.ndarray:
    """(N_FRAMES, 32, 48, 3) uint8: a static scene with sensor noise and a
    bright block in the last-but-one frame."""
    rng = np.random.RandomState(seed)
    scene = rng.uniform(60, 190, (32, 48, 3))
    out = np.clip(scene + rng.normal(0, 6, (N_FRAMES, 32, 48, 3)), 0, 255)
    out[N_FRAMES - 2, 12:20, 18:30] = 255
    return out.astype(np.uint8)


def warm_state():
    """(maps, scalars) of a scorer that has seen a quiet stream (as
    ``trustedai_cl_vae_ad_tpu_torch.testing.warm_score_state``)."""
    maps = np.stack([np.full((32, 48), 0.1, np.float32), np.full((32, 48), 0.0125, np.float32)])
    return maps, np.array([0.0, 1.0, 1.0, 2.0, 1.0, 0.0], np.float32)


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


def write_logdir(name: str, logdir: str) -> None:
    """Fixture ``name`` saved by the JAX package into ``logdir`` (replaced)."""
    import yaml

    from trustedai_cl_vae_ad_tpu.models.wrapper import VAEModel
    from trustedai_cl_vae_ad_tpu.ops import quant
    from trustedai_cl_vae_ad_tpu.registry import build_core_from_config
    from trustedai_cl_vae_ad_tpu.train.loop import save_train_state

    config = fixture_config(name)
    if os.path.isdir(logdir):
        shutil.rmtree(logdir)
    os.makedirs(logdir)
    with open(os.path.join(logdir, "config.yml"), "w") as f:
        yaml.safe_dump(config, f)
    model = VAEModel(build_core_from_config(config), seed=3)
    model.compile()
    rng = np.random.RandomState(11)
    for _ in range(2):  # moments that are not zero
        model.train_step(rng.randint(0, 256, (N_FRAMES, 32, 48, 3)).astype(np.uint8))
    model.set_learning_rate(LEARNING_RATE)
    model.save_model(logdir)
    save_train_state(logdir, epochs_completed=1, step=2, beta=0.98e-6)
    if name == "global_f32":
        quant.save_quantized_checkpoint(
            logdir, quant.quantize_params(model.core, model.params, min_elems=0))


def jax_outputs(name: str, logdir: str) -> dict:
    """What the JAX package computes from the log directory, as numpy."""
    import jax
    import jax.numpy as jnp

    from torch_port_helpers import next_jax_eps
    from trustedai_cl_vae_ad_tpu.ops import quant
    from trustedai_cl_vae_ad_tpu.ops.stream_score import StreamScoreState
    from trustedai_cl_vae_ad_tpu.registry import load_model_from_directory
    from trustedai_cl_vae_ad_tpu.stream.engine import StreamingEngine

    x = frames()
    out = {"frames": x}
    model, config = load_model_from_directory(logdir, restore_optimizer=True)
    out["learning_rate"] = np.float64(model.learning_rate)
    out["reconstruction"] = np.asarray(model.call(x), np.float32)
    engine = StreamingEngine(model, config, anomaly_settings=SETTINGS)
    engine.inference_period_ms = 0.0
    maps, scalars = warm_state()
    engine.score_state = StreamScoreState(jnp.asarray(maps), jnp.asarray(scalars))
    results = [engine.process_frame(f, now=float(i), tag=i) for i, f in enumerate(x)]
    out["scores"] = np.array([r.score for r in results], np.float64)
    out["counts"] = np.array([r.pixel_count for r in results], np.float64)
    if os.path.isdir(os.path.join(logdir, quant.QUANTIZED_SUBDIR)):
        qparams = quant.load_quantized_checkpoint(logdir)
        out["reconstruction_w8a8"] = np.asarray(
            quant.call_quantized(model.core, qparams, jnp.asarray(x)), np.float32)
    out["step_eps"] = next_jax_eps(model, N_FRAMES)
    loss, _ = model.train_step_and_run(x)
    for key, value in loss.items():
        out[f"loss/{key}"] = np.float64(np.asarray(value, np.float32))
    for key, value in _flat(jax.device_get(model.params)).items():
        out[f"params/{key}"] = value.astype(np.float32)  # bfloat16 widens exactly
    inner = jax.device_get(model.opt_state.inner_state[0])
    out["count"] = np.int64(inner.count)
    for kind in ("mu", "nu"):
        for key, value in _flat(getattr(inner, kind)).items():
            out[f"{kind}/{key}"] = value.astype(np.float32)
    return out


def main() -> int:
    sys.path.insert(0, HERE)
    sys.path.insert(0, REPO)
    os.makedirs(DATA, exist_ok=True)
    for name in ("global_f32", "single_bf16"):
        logdir = os.path.join(DATA, name)
        write_logdir(name, logdir)
        np.savez_compressed(os.path.join(DATA, f"{name}.npz"), **jax_outputs(name, logdir))
        converted = os.path.join(DATA, "converted", name)
        if os.path.isdir(converted):
            shutil.rmtree(converted)
        sys.path.insert(0, os.path.join(REPO, "tools"))
        import convert_logdir_torch

        convert_logdir_torch.main([logdir, converted])
        print(json.dumps({"fixture": name, "logdir": logdir, "converted": converted}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
