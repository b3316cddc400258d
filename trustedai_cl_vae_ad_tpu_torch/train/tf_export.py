"""Export a log directory of the port to the reference's TF SavedModel layout.

The counterpart of ``trustedai_cl_vae_ad_tpu/train/tf_export.py`` and the
inverse of ``train/tf_import.py``: builds Keras twins of the reference
architecture (abstract_cvae.py:22-92), sets the port's weights into them, and
writes the reference's log-directory layout: ``encoder/`` and ``decoder/``
SavedModels beside ``config.yml``. A model trained by the port can then be
served or analyzed by the reference's TensorFlow tooling, or read back by
either package's importer.

The weights cross by ``bridge.params_to_flax``, whose layouts are Keras's
(Conv2D HWIO; Conv2DTranspose (kh, kw, out, in); Dense (in, out)), as float32
(a bfloat16 model exports as float32, as the JAX package's export does).

TensorFlow is needed at export time and is imported inside
``export_tf_checkpoint`` only; without it the export raises before anything is
written. Importing TensorFlow 2.21 loads jax by itself where jax is installed:
that is TensorFlow's import, not the port's, and this module imports neither.
"""

from __future__ import annotations

import os
from typing import List, Tuple


def build_reference_models(config: dict):
    """Keras encoder and decoder of the reference's architecture: stride-2 3x3
    SAME relu convolutions -> flatten -> [dense] -> dense(2 * latent); dense(relu)
    -> reshape -> stride-2 3x3 SAME relu Conv2DTranspose stack -> the stride-1
    output Conv2DTranspose."""
    import keras

    size = config["data"]["image_size"]
    latent = int(config["model"]["latent_dimensions"])
    layers_cfg = list(config["model"]["layers"])
    edf = config["model"].get("encoder_dense_filters")

    enc_layers = [keras.layers.InputLayer(tuple(size))]
    for f in layers_cfg:
        enc_layers.append(
            keras.layers.Conv2D(f, 3, strides=(2, 2), padding="same", activation="relu")
        )
    enc_layers.append(keras.layers.Flatten())
    if edf:
        enc_layers.append(keras.layers.Dense(int(edf)))
    enc_layers.append(keras.layers.Dense(2 * latent))
    encoder = keras.Sequential(enc_layers, name="encoder")

    n = len(layers_cfg)
    dw, dh = size[0] // 2**n, size[1] // 2**n
    ddf = int(config["model"]["decoder_dense_filters"])
    dec_layers = [
        keras.layers.InputLayer((latent,)),
        keras.layers.Dense(dw * dh * ddf, activation="relu"),
        keras.layers.Reshape((dw, dh, ddf)),
    ]
    for f in reversed(layers_cfg):
        dec_layers.append(
            keras.layers.Conv2DTranspose(f, 3, strides=2, padding="same", activation="relu")
        )
    dec_layers.append(keras.layers.Conv2DTranspose(size[2], 3, strides=1, padding="same"))
    decoder = keras.Sequential(dec_layers, name="decoder")
    return encoder, decoder


def ordered_weights(flax_part: dict, layer_names: List[str]) -> list:
    """One part of a flax-layout tree ({layer: {kernel, bias}}) in Keras's
    ``set_weights`` order: [kernel, bias] a weighted layer, in network order,
    each as float32."""
    import numpy as np

    out = []
    for name in layer_names:
        layer = flax_part[name]
        out.append(np.asarray(layer["kernel"], np.float32))
        out.append(np.asarray(layer["bias"], np.float32))
    return out


def export_tf_checkpoint(log_dir: str, out_dir: str, device="cuda") -> Tuple[str, str]:
    """Write the model of ``log_dir`` (loaded on ``device``) to ``out_dir`` in the
    reference's SavedModel layout; returns (encoder path, decoder path)."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise RuntimeError(
            "export_tf_checkpoint requires tensorflow to build the SavedModels"
        ) from e

    from trustedai_cl_vae_ad_tpu_torch.bridge import params_to_flax
    from trustedai_cl_vae_ad_tpu_torch.config import load_config, save_config
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory
    from trustedai_cl_vae_ad_tpu_torch.train.tf_import import (
        decoder_layer_names,
        encoder_layer_names,
    )

    model, config = load_model_from_directory(log_dir, device=device)
    params = params_to_flax(model.params)

    encoder, decoder = build_reference_models(config)
    encoder.set_weights(ordered_weights(params["encoder"], encoder_layer_names(config)))
    decoder.set_weights(ordered_weights(params["decoder"], decoder_layer_names(config)))

    os.makedirs(out_dir, exist_ok=True)
    enc_path = os.path.join(out_dir, "encoder")
    dec_path = os.path.join(out_dir, "decoder")
    tf.saved_model.save(encoder, enc_path)
    tf.saved_model.save(decoder, dec_path)
    save_config(load_config(os.path.join(log_dir, "config.yml")),
                os.path.join(out_dir, "config.yml"))
    return enc_path, dec_path
