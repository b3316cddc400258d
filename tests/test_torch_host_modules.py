"""The port's host-side modules against their JAX-package originals: the
config reader, the CDF thresholds, the frame sources and the CLI's
--warmup parser."""

import glob
import os
import re

import numpy as np
import pytest
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yml")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_config_matches_jax_reader(path):
    from trustedai_cl_vae_ad_tpu.config import load_config as jax_load
    from trustedai_cl_vae_ad_tpu_torch.config import load_config

    with open(path) as f:
        expected = yaml.safe_load(f)
    assert load_config(path) == jax_load(path) == expected


_GOOD = {"data": {"image_size": [32, 48, 3]}, "loss": {},
         "model": {"latent_dimensions": 8, "layers": [4], "decoder_dense_filters": 4},
         "training": {}}


def _without(section, key=None):
    cfg = {k: dict(v) for k, v in _GOOD.items()}
    if key is None:
        del cfg[section]
    else:
        del cfg[section][key]
    return cfg


@pytest.mark.parametrize("config", [
    _without("loss"), _without("model", "latent_dimensions"), _without("model", "layers"),
    _without("model", "decoder_dense_filters"), _without("data", "image_size"),
    dict(_GOOD, data={"image_size": [32, 48]}),
], ids=["no-loss", "no-latent", "no-layers", "no-ddf", "no-image-size", "image-size-2d"])
def test_validate_config_rejects_what_jax_rejects(config):
    from trustedai_cl_vae_ad_tpu.config import validate_config as jax_validate
    from trustedai_cl_vae_ad_tpu_torch.config import validate_config

    with pytest.raises(ValueError) as jax_err:
        jax_validate(config)
    with pytest.raises(ValueError, match=re.escape(str(jax_err.value))):
        validate_config(config)
    assert validate_config(_GOOD) is _GOOD


def test_load_model_from_config_path_validates(tmp_path):
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config_path

    bad = tmp_path / "bad.yml"
    bad.write_text(yaml.safe_dump(_without("model", "layers")))
    with pytest.raises(ValueError, match="layers"):
        load_model_from_config_path(str(bad))
    with pytest.raises(FileNotFoundError):
        load_model_from_config_path(str(tmp_path / "missing.yml"))


@pytest.mark.parametrize("robust", [True, False], ids=["robust", "raw"])
@pytest.mark.parametrize("quantile", [0.5, 0.9, 0.995, 1.0])
def test_cdf_threshold_matches_jax(robust, quantile):
    from trustedai_cl_vae_ad_tpu.anomaly import cdf as jcdf
    from trustedai_cl_vae_ad_tpu_torch.anomaly import cdf as tcdf

    x = np.random.RandomState(7).standard_t(3, 500)
    j, t = jcdf.CDFObject(x), tcdf.CDFObject(x)
    np.testing.assert_array_equal(t.cdf, j.cdf)
    np.testing.assert_array_equal(t.bin_edges, j.bin_edges)
    assert t.meu == j.meu
    probe = np.linspace(-8, 8, 33)
    np.testing.assert_array_equal(t.get_prob_by_value(probe), j.get_prob_by_value(probe))
    assert t.get_prob_by_value(-100.0) == j.get_prob_by_value(-100.0) == 0.0
    assert t.get_value_by_prob(quantile) == j.get_value_by_prob(quantile)
    assert (tcdf.threshold_from_cdf(t, quantile, robust=robust)
            == jcdf.threshold_from_cdf(j, quantile, robust=robust))


@pytest.mark.parametrize("p", [1e-6, 0.01, 0.3, 0.5, 0.9, 0.99, 1 - 1e-6])
def test_normal_ppf_matches_jax(p):
    from trustedai_cl_vae_ad_tpu.anomaly.cdf import normal_ppf as jax_ppf
    from trustedai_cl_vae_ad_tpu_torch.anomaly.cdf import normal_ppf

    assert normal_ppf(p) == jax_ppf(p)


@pytest.mark.parametrize("kwargs", [
    {},
    {"width": 64, "height": 40, "n_frames": 6, "anomaly_frames": range(2, 4), "motion": 0.0,
     "seed": 5},
], ids=["default", "small-with-anomaly"])
def test_synthetic_source_matches_jax(kwargs):
    from trustedai_cl_vae_ad_tpu.stream.capture import SyntheticSource as JaxSource
    from trustedai_cl_vae_ad_tpu_torch.stream.capture import SyntheticSource

    kwargs = dict({"n_frames": 3}, **kwargs)
    got, ref = list(SyntheticSource(**kwargs)), list(JaxSource(**kwargs))
    assert len(got) == len(ref) == kwargs["n_frames"]
    for g, r in zip(got, ref):
        assert g.dtype == np.uint8 and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def test_directory_source_matches_jax(tmp_path):
    from PIL import Image

    from trustedai_cl_vae_ad_tpu.stream.capture import DirectorySource as JaxDir
    from trustedai_cl_vae_ad_tpu_torch.stream.capture import (
        DirectorySource,
        SyntheticSource,
        make_source,
    )

    for i, frame in enumerate(SyntheticSource(width=24, height=16, n_frames=3)):
        Image.fromarray(frame).save(tmp_path / f"f{i:02d}.png")
    (tmp_path / "notes.txt").write_text("not a frame")
    src = make_source(str(tmp_path))
    assert isinstance(src, DirectorySource)
    got, ref = list(src), list(JaxDir(str(tmp_path)))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert isinstance(make_source("synthetic"), SyntheticSource)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="no frames"):
        DirectorySource(str(empty))


@pytest.mark.parametrize("value", [None, "native", "1080x1920", "240X320", "12"])
def test_parse_warmup_spec_matches_jax_cli(value):
    from camera_streamer import parse_warmup_spec as jax_parse
    from trustedai_cl_vae_ad_tpu_torch.stream.run import parse_warmup_spec

    class UsageError(Exception):
        pass

    def error(msg):
        raise UsageError(msg)

    try:
        expected = jax_parse(value, error)
    except UsageError as e:
        with pytest.raises(UsageError, match=re.escape(str(e))):
            parse_warmup_spec(value, error)
    else:
        assert parse_warmup_spec(value, error) == expected
