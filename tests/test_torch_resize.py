"""The port's device resize vs jax.image.resize(method="linear", antialias=True),
the resize the JAX stream engine runs on frames that are not at model size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustedai_cl_vae_ad_tpu_torch.data.ingest import resize_images


@pytest.mark.parametrize("src,dst", [
    ((240, 320), (224, 300)),  # SyntheticSource default -> flagship (down, mild)
    ((40, 64), (32, 48)),      # the engine tests' frames -> tiny model
    ((100, 150), (224, 300)),  # upsampling
    ((37, 53), (30, 45)),      # odd sizes
])
def test_resize_matches_jax(src, dst):
    rng = np.random.RandomState(src[0])
    x = rng.randint(0, 256, (2, *src, 3)).astype(np.float32) / 255.0
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 3), method="linear",
                                      antialias=True))
    got = resize_images(torch.from_numpy(x), dst).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_resize_is_identity_at_model_size():
    x = torch.rand(1, 12, 16, 3)
    assert resize_images(x, (12, 16)) is x
