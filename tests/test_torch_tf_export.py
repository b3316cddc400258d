"""The port exports its log directories to the reference's TF SavedModel layout
(``train/tf_export.py``, ``tools/export_tf_checkpoint_torch.py``) as the JAX
package's exporter does.

``tests/test_tf_import.py::test_export_then_import_roundtrip`` carries over, and
the port's export is held to the JAX package's on the same weights (the JAX
model's seeded init through ``bridge.py``): the SavedModels' variables, read by
``train/tf_import.read_savedmodel_variables``, are equal bit for bit; a
bfloat16 model exports as float32, as the JAX exporter casts; both packages' importers read the port's
export back bit for bit; the TF serving signatures match the port's forward
within the reference's MSE of 1e-5; and without TensorFlow both exporters raise
the same error before writing anything.
"""

import copy
import os
import sys

import jax
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import paired_models
from trustedai_cl_vae_ad_tpu_torch.bridge import params_from_flax
from trustedai_cl_vae_ad_tpu_torch.train import tf_export
from trustedai_cl_vae_ad_tpu_torch.train import tf_import as port_tf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY_MSE = 1e-5
CONFIG = {
    "data": {"image_size": [20, 24, 3]},
    "loss": {"kurtosis": 1.8, "w_kl_divergence": 0.0, "w_kurtosis": 1e-4, "w_mse": 1.0,
             "w_skew": 0.0, "w_z_l1_reg": 0.0},
    "model": {"type": "KurtosisGlobal", "latent_dimensions": 6, "layers": [4, 8],
              "decoder_dense_filters": 4},
    "training": {"batch_size": 4, "beta": 1e-6, "learning_rate": 1e-3, "max_epochs": 1},
}


def _config(precision=None):
    config = copy.deepcopy(CONFIG)
    if precision:
        config["training"]["precision"] = precision
    return config


@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


@pytest.fixture(scope="module")
def exports(tf, tmp_path_factory):
    """{precision: record} made on first use. float32: the same seeded weights saved
    as a JAX and as a port log directory, each exported by its own package;
    bfloat16: the port's seeded model and its export only."""
    from trustedai_cl_vae_ad_tpu.config import save_config as jax_save_config
    from trustedai_cl_vae_ad_tpu.train.tf_export import export_tf_checkpoint as jax_export
    from trustedai_cl_vae_ad_tpu_torch.config import save_config
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config

    made = {}

    def get(precision):
        if precision not in made:
            config = _config(None if precision == "float32" else precision)
            root = tmp_path_factory.mktemp(f"export_{precision}")
            if precision == "float32":
                jmodel, tmodel = paired_models(copy.deepcopy(config), compile=False)
            else:
                jmodel, tmodel = None, load_model_from_config(copy.deepcopy(config), device="cpu")
            jax_dir, port_dir = str(root / "jax_run"), str(root / "port_run")
            tmodel.save_model(port_dir, include_optimizer=False)
            save_config(copy.deepcopy(config), os.path.join(port_dir, "config.yml"))
            jax_out, port_out = str(root / "jax_export"), str(root / "port_export")
            tf_export.export_tf_checkpoint(port_dir, port_out, device="cpu")
            if precision == "float32":  # the JAX export beside it (bfloat16 is port-only)
                jmodel.save_model(jax_dir, include_optimizer=False)
                jax_save_config(copy.deepcopy(config), os.path.join(jax_dir, "config.yml"))
                jax_export(jax_dir, jax_out)
            made[precision] = {"config": config, "jmodel": jmodel, "tmodel": tmodel,
                               "port_dir": port_dir, "jax_out": jax_out, "port_out": port_out}
        return made[precision]

    return get


def _bits(t):
    return t.contiguous().view({torch.bfloat16: torch.int16, torch.float32: torch.int32}[t.dtype])


def _assert_states_equal(got, ref):
    """Same keys, dtypes and shapes, and every tensor bit for bit."""
    assert set(got) == set(ref)
    for key, t in ref.items():
        assert got[key].dtype == t.dtype, (key, got[key].dtype, t.dtype)
        assert got[key].shape == t.shape, key
        assert torch.equal(_bits(got[key]), _bits(t)), key


def _port_state(model):
    return {k: v.detach().clone() for k, v in model.params.items()}


def _serve(tf, directory, part, value):
    loaded = tf.saved_model.load(os.path.join(directory, part))
    fn = loaded.signatures.get("serving_default") or next(iter(loaded.signatures.values()))
    return list(fn(tf.constant(value)).values())[0].numpy()


def test_export_then_import_roundtrip(tf, exports):
    """The port's model -> TF SavedModels -> the port's importer is lossless, and the
    exported models reproduce the port's forward within an MSE of 1e-5 (the
    reference-tooling interop contract both ways)."""
    rec = exports("float32")
    out, model = rec["port_out"], rec["tmodel"]
    for name in ("encoder", "decoder", "config.yml"):
        assert os.path.exists(os.path.join(out, name)), name

    x = np.random.RandomState(3).random((2, 20, 24, 3)).astype(np.float32)
    tf_latent = _serve(tf, out, "encoder", x)
    ours_latent = torch.cat(model.encode(x), dim=1).numpy()
    assert float(np.mean((tf_latent - ours_latent) ** 2)) < PARITY_MSE
    z = ours_latent[:, :6]
    tf_rec = _serve(tf, out, "decoder", z)
    ours_rec = model.decode(z, apply_sigmoid=False).numpy()
    assert float(np.mean((tf_rec - ours_rec) ** 2)) < PARITY_MSE

    back, _cfg = port_tf.import_tf_checkpoint(out, device="cpu")
    _assert_states_equal(_port_state(back), _port_state(model))


def test_port_export_equals_jax_export(exports):
    """Both packages' exports of the same weights hold the same variables under the
    same keys, bit for bit."""
    rec = exports("float32")
    for part in ("encoder", "decoder"):
        got = port_tf.read_savedmodel_variables(os.path.join(rec["port_out"], part))
        ref = port_tf.read_savedmodel_variables(os.path.join(rec["jax_out"], part))
        weights = {k: v for k, v in ref.items() if "VARIABLE_VALUE" in k and "_layers" in k}
        assert weights, sorted(ref)
        for key, arr in weights.items():
            assert key in got, key
            assert got[key].dtype == arr.dtype == np.float32, (key, got[key].dtype)
            np.testing.assert_array_equal(got[key].view(np.int32), arr.view(np.int32),
                                          err_msg=key)
    with open(os.path.join(rec["port_out"], "config.yml")) as f1, \
            open(os.path.join(rec["jax_out"], "config.yml")) as f2:
        import yaml

        assert yaml.safe_load(f1) == yaml.safe_load(f2) == rec["config"]


@pytest.mark.parametrize("package", ["port", "jax"])
def test_both_importers_read_the_port_export(exports, package):
    """The port's export imports back bit for bit into either package."""
    from trustedai_cl_vae_ad_tpu.train.tf_import import import_tf_checkpoint as jax_import

    rec = exports("float32")
    if package == "port":
        back, _ = port_tf.import_tf_checkpoint(rec["port_out"], device="cpu")
        got = _port_state(back)
    else:
        back, _ = jax_import(rec["port_out"])
        got = params_from_flax(jax.device_get(back.params))
    _assert_states_equal(got, _port_state(rec["tmodel"]))


def test_bf16_model_exports_as_float32(exports):
    """A bfloat16 model's SavedModels hold float32 variables equal to its weights
    widened. Widening is exact, so the importer restores the bfloat16 weights bit for
    bit under the exported config (precision bfloat16), and their float32 widening
    under a float32 config."""
    rec = exports("bfloat16")
    state = _port_state(rec["tmodel"])
    assert all(t.dtype == torch.bfloat16 for t in state.values())
    layers = port_tf.extract_weighted_layers(
        port_tf.read_savedmodel_variables(os.path.join(rec["port_out"], "decoder")))
    assert all(a.dtype == np.float32 for layer in layers for a in layer.values())
    assert layers[0]["bias"].tolist() == state["decoder.layers.Dense_0.bias"].float().tolist()
    back, config = port_tf.import_tf_checkpoint(rec["port_out"], device="cpu")
    assert config["training"]["precision"] == "bfloat16"
    _assert_states_equal(_port_state(back), state)
    widened, _ = port_tf.import_tf_checkpoint(rec["port_out"], config=_config(), device="cpu")
    _assert_states_equal(_port_state(widened), {k: v.float() for k, v in state.items()})


def test_without_tensorflow_the_error_equals_the_jax_one(tmp_path, monkeypatch):
    """Where tensorflow does not import, both exporters raise the same RuntimeError
    before they read or write anything."""
    from trustedai_cl_vae_ad_tpu.train.tf_export import export_tf_checkpoint as jax_export

    monkeypatch.setitem(sys.modules, "tensorflow", None)  # import tensorflow -> ImportError
    errors = []
    for export in (jax_export, lambda d, o: tf_export.export_tf_checkpoint(d, o, device="cpu")):
        out = tmp_path / f"out{len(errors)}"
        with pytest.raises(RuntimeError) as e:
            export(str(tmp_path / "no_such_logdir"), str(out))
        errors.append(str(e.value))
        assert not out.exists()
    assert errors[0] == errors[1] == (
        "export_tf_checkpoint requires tensorflow to build the SavedModels")


def test_cli(exports, tmp_path, capsys, monkeypatch):
    """tools/export_tf_checkpoint_torch.py prints the JAX tool's line and exits 0; without
    tensorflow it exits 1 with the exporter's error and writes nothing."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import export_tf_checkpoint_torch
    finally:
        sys.path.pop(0)

    rec = exports("float32")
    out = tmp_path / "cli_export"
    assert export_tf_checkpoint_torch.main([rec["port_dir"], str(out), "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == (
        f"Exported TF SavedModels: {out / 'encoder'}, {out / 'decoder'}")
    back, _ = port_tf.import_tf_checkpoint(str(out), device="cpu")
    _assert_states_equal(_port_state(back), _port_state(rec["tmodel"]))

    monkeypatch.setitem(sys.modules, "tensorflow", None)
    missing = tmp_path / "no_tf"
    assert export_tf_checkpoint_torch.main([rec["port_dir"], str(missing), "--device", "cpu"]) == 1
    assert "requires tensorflow" in capsys.readouterr().err
    assert not missing.exists()
