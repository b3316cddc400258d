"""The port imports the reference's TF SavedModels (``train/tf_import.py``,
``tools/import_tf_checkpoint_torch.py``) as the JAX package does.

Each case of ``tests/test_tf_import.py`` runs on both packages, and the port
is held against the JAX package on the same directories: the imported state
dict equals ``bridge.params_from_flax`` of the JAX import bit for bit, in
float32 and in bfloat16 (a float32 SavedModel cast by torch must give
``ml_dtypes``'s bits), in Keras 3's key layout (``tf.saved_model.save`` here)
and in the reference's Keras 2 layout (``testing.write_reference_logdir``,
which TF 2.16+ no longer writes). Forwards match TF's serving within an MSE
of 1e-5, the reference's parity target. ``testing.write_tf_bundle``'s
output, CRCs included, is read by TF's own reader.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from trustedai_cl_vae_ad_tpu_torch import testing
from trustedai_cl_vae_ad_tpu_torch.bridge import params_from_flax, params_to_flax
from trustedai_cl_vae_ad_tpu_torch.train import tf_import as port_tf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("port", "jax")
PARITY_MSE = 1e-5

CONFIG = {
    "data": {"image_size": [20, 24, 3]},
    "loss": {"kurtosis": 1.8, "w_kl_divergence": 0.0, "w_kurtosis": 1e-4,
             "w_mse": 1.0, "w_skew": 0.0, "w_z_l1_reg": 0.0},
    "model": {"type": "KurtosisGlobal", "latent_dimensions": 6,
              "layers": [4, 8], "decoder_dense_filters": 4},
    "training": {"batch_size": 4, "beta": 1e-6, "learning_rate": 1e-3,
                 "max_epochs": 1},
}


def _config(precision=None, edf=None):
    config = copy.deepcopy(CONFIG)
    if precision:
        config["training"]["precision"] = precision
    if edf:
        config["model"]["encoder_dense_filters"] = edf
    return config


@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


def _build_tf_twins(config, seed=0):
    """Keras encoder and decoder of the reference's architecture
    (abstract_cvae.py:22-92) with seeded random weights."""
    import keras

    size = config["data"]["image_size"]
    latent = config["model"]["latent_dimensions"]
    layers_cfg = config["model"]["layers"]
    edf = config["model"].get("encoder_dense_filters")

    enc_layers = [keras.layers.InputLayer(tuple(size))]
    for f in layers_cfg:
        enc_layers.append(keras.layers.Conv2D(f, 3, strides=(2, 2), padding="same",
                                              activation="relu"))
    enc_layers.append(keras.layers.Flatten())
    if edf:
        enc_layers.append(keras.layers.Dense(int(edf)))
    enc_layers.append(keras.layers.Dense(2 * latent))
    encoder = keras.Sequential(enc_layers, name="encoder")

    n = len(layers_cfg)
    dw, dh = size[0] // 2**n, size[1] // 2**n
    ddf = config["model"]["decoder_dense_filters"]
    dec_layers = [keras.layers.InputLayer((latent,)),
                  keras.layers.Dense(dw * dh * ddf, activation="relu"),
                  keras.layers.Reshape((dw, dh, ddf))]
    for f in reversed(layers_cfg):
        dec_layers.append(keras.layers.Conv2DTranspose(f, 3, strides=2, padding="same",
                                                       activation="relu"))
    dec_layers.append(keras.layers.Conv2DTranspose(size[2], 3, strides=1, padding="same"))
    decoder = keras.Sequential(dec_layers, name="decoder")

    rng = np.random.RandomState(seed)
    for model in (encoder, decoder):
        model.set_weights([rng.normal(0, 0.2, w.shape).astype(np.float32)
                           for w in model.get_weights()])
    return encoder, decoder


@pytest.fixture(scope="module")
def savedmodels(tf, tmp_path_factory):
    """{name: (directory, encoder, decoder, config)} of reference log
    directories written by TF (Keras 3 keys), made on first use."""
    made = {}

    def get(name):
        if name not in made:
            config = {"f32": _config(), "bf16": _config("bfloat16"), "edf": _config(edf=5)}[name]
            d = tmp_path_factory.mktemp(f"ref_{name}")
            encoder, decoder = _build_tf_twins(config, seed=len(made))
            tf.saved_model.save(encoder, str(d / "encoder"))
            tf.saved_model.save(decoder, str(d / "decoder"))
            (d / "config.yml").write_text(yaml.safe_dump(config))
            made[name] = (str(d), encoder, decoder, config)
        return made[name]

    return get


def _seeded_flax(config, seed=0):
    """Seeded float32 weights of ``config``'s model in flax's layouts, from numpy."""
    from trustedai_cl_vae_ad_tpu_torch.registry import build_core_from_config

    rng = np.random.RandomState(seed)
    shapes = {k: tuple(t.shape) for k, t in build_core_from_config(config).state_dict().items()}
    state = {k: torch.from_numpy(rng.normal(0, 0.2, s).astype(np.float32))
             for k, s in shapes.items()}
    return params_to_flax(state)


@pytest.fixture(scope="module")
def keras2_dirs(tmp_path_factory):
    """{precision: directory} of reference log directories in Keras 2 keys,
    written by ``testing.write_reference_logdir``."""
    out = {}
    for precision in ("float32", "bfloat16"):
        config = _config(precision if precision != "float32" else None)
        d = str(tmp_path_factory.mktemp(f"keras2_{precision}"))
        testing.write_reference_logdir(d, config, _seeded_flax(config, seed=3))
        out[precision] = d
    return out


def _jax_import(ref_dir, config=None):
    from trustedai_cl_vae_ad_tpu.train.tf_import import import_tf_checkpoint

    return import_tf_checkpoint(ref_dir, config=config)


def _import(package, ref_dir, config=None):
    if package == "port":
        return port_tf.import_tf_checkpoint(ref_dir, config=config, device="cpu")
    return _jax_import(ref_dir, config=config)


def _state(package, model):
    """The model's parameters as the port's state dict of CPU tensors."""
    if package == "port":
        return {k: v.detach().clone() for k, v in model.params.items()}
    return params_from_flax(jax.device_get(model.params))


def _bits(t):
    return t.contiguous().view({torch.bfloat16: torch.int16, torch.float32: torch.int32}[t.dtype])


def _assert_states_equal(got, ref):
    """Same keys, dtypes and shapes, and every tensor bit for bit."""
    assert set(got) == set(ref)
    for key, t in ref.items():
        assert got[key].dtype == t.dtype, (key, got[key].dtype, t.dtype)
        assert got[key].shape == t.shape, key
        assert torch.equal(_bits(got[key]), _bits(t)), key


def _latent(package, model, x):
    mean, logvar = model.encode(x)
    if package == "port":
        return torch.cat([mean, logvar], dim=1).float().numpy()
    return np.concatenate([np.asarray(mean), np.asarray(logvar)], axis=1)


def _decode(package, model, z):
    out = model.decode(z, apply_sigmoid=False)
    return out.float().numpy() if package == "port" else np.asarray(out)


# -- the cases of tests/test_tf_import.py, on both packages ------------------------------

@pytest.mark.parametrize("package", PACKAGES)
def test_bundle_reader_matches_tf(tf, savedmodels, package):
    """Both readers return the tensors of tf.train.load_checkpoint, byte for byte."""
    d, _, _, _ = savedmodels("f32")
    if package == "port":
        read = port_tf.read_tf_bundle
    else:
        from trustedai_cl_vae_ad_tpu.train.tf_import import read_tf_bundle as read
    prefix = os.path.join(d, "encoder", "variables", "variables")
    ours = read(prefix)
    reader = tf.train.load_checkpoint(prefix)
    keys = [k for k in reader.get_variable_to_shape_map() if "VARIABLE_VALUE" in k]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(reader.get_tensor(k)))


@pytest.mark.parametrize("package", PACKAGES)
def test_forward_matches_tf(tf, savedmodels, package):
    """The imported weights give TF's encoder and decoder outputs within an
    MSE of 1e-5, and the reconstruction through both stages."""
    d, encoder, decoder, _ = savedmodels("f32")
    model, _ = _import(package, d)
    x = np.random.RandomState(1).random((3, 20, 24, 3)).astype(np.float32)
    tf_latent = encoder(tf.constant(x)).numpy()
    ours = _latent(package, model, x)
    assert float(np.mean((tf_latent - ours) ** 2)) < PARITY_MSE
    z = tf_latent[:, :6]
    tf_rec = decoder(tf.constant(z)).numpy()
    ours_rec = _decode(package, model, z)
    assert tf_rec.shape == ours_rec.shape
    assert float(np.mean((tf_rec - ours_rec) ** 2)) < PARITY_MSE
    tf_full = decoder(encoder(tf.constant(x))[:, :6]).numpy()
    assert float(np.mean((tf_full - _decode(package, model, ours[:, :6])) ** 2)) < PARITY_MSE


@pytest.mark.parametrize("package", PACKAGES)
def test_roundtrip_through_the_packages_checkpoint(tf, savedmodels, package, tmp_path):
    """Import, save in the package's own layout, load_model_from_directory:
    the same parameters and TF's latent within 1e-5."""
    d, encoder, _, _ = savedmodels("f32")
    model, config = _import(package, d)
    out = str(tmp_path / "converted")
    os.makedirs(out)
    model.save_model(out, include_optimizer=False)
    if package == "port":
        from trustedai_cl_vae_ad_tpu_torch.config import save_config
        from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory

        save_config(config, os.path.join(out, "config.yml"))
        reloaded, _ = load_model_from_directory(out, device="cpu")
    else:
        from trustedai_cl_vae_ad_tpu.config import save_config
        from trustedai_cl_vae_ad_tpu.registry import load_model_from_directory

        save_config(config, os.path.join(out, "config.yml"))
        reloaded, _ = load_model_from_directory(out)
    _assert_states_equal(_state(package, reloaded), _state(package, model))
    x = np.random.RandomState(2).random((2, 20, 24, 3)).astype(np.float32)
    tf_latent = encoder(tf.constant(x)).numpy()
    assert float(np.mean((tf_latent - _latent(package, reloaded, x)) ** 2)) < PARITY_MSE


def _without_a_bias(directory, config):
    """A Keras 2 reference directory whose encoder's last Dense lacks its bias."""
    testing.write_reference_logdir(directory, config, _seeded_flax(config))
    prefix = os.path.join(directory, "encoder", "variables", "variables")
    tensors = port_tf.read_tf_bundle(prefix)
    last = len(port_tf.encoder_layer_names(config)) - 1
    tensors = {k: np.array(v) for k, v in tensors.items()
               if k != f"layer_with_weights-{last}/bias/.ATTRIBUTES/VARIABLE_VALUE"}
    for name in os.listdir(os.path.dirname(prefix)):
        os.remove(os.path.join(os.path.dirname(prefix), name))
    testing.write_tf_bundle(prefix, tensors)


@pytest.mark.parametrize("fault", ["shape", "layer_count", "missing_bias"])
def test_mismatches_are_rejected_alike(keras2_dirs, tmp_path, fault):
    """A config that does not fit the checkpoint fails loudly, naming the
    layer, with the JAX package's message: a shape (both shapes named), the
    number of weighted layers, a missing kernel or bias."""
    d = keras2_dirs["float32"]
    bad = _config()
    if fault == "shape":
        bad["model"]["latent_dimensions"] = 9
        match = "shape"
    elif fault == "layer_count":
        bad["model"]["layers"] = [4]
        match = "weighted layers"
    else:
        d = str(tmp_path / "no_bias")
        _without_a_bias(d, bad)
        match = "missing bias"
    with pytest.raises(ValueError, match=match) as port_err:
        port_tf.import_tf_checkpoint(d, config=bad, device="cpu")
    with pytest.raises(ValueError) as jax_err:
        _jax_import(d, config=bad)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("package", PACKAGES)
def test_jax_export_then_import(tf, tmp_path, package):
    """The JAX exporter's SavedModels import bit for bit into either package:
    the port's state equals bridge.params_from_flax of the exported params."""
    from trustedai_cl_vae_ad_tpu.config import save_config
    from trustedai_cl_vae_ad_tpu.registry import load_model_from_config
    from trustedai_cl_vae_ad_tpu.train.tf_export import export_tf_checkpoint

    model = load_model_from_config(_config())
    ours = tmp_path / "ours"
    ours.mkdir()
    model.save_model(str(ours), include_optimizer=False)
    save_config(_config(), str(ours / "config.yml"))
    exported = tmp_path / "exported"
    export_tf_checkpoint(str(ours), str(exported))
    back, _ = _import(package, str(exported))
    _assert_states_equal(_state(package, back), params_from_flax(jax.device_get(model.params)))


# -- the port against the JAX package --------------------------------------------------

@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["keras3", "keras2"])
def test_port_import_equals_jax_import(request, layout, precision):
    """The same directory through both importers gives the same state dict,
    bit for bit: Keras 3 keys from TF's own writer, the reference's Keras 2
    keys from testing.write_reference_logdir; float32 weights kept or cast to
    bfloat16 (torch's cast equals ml_dtypes')."""
    if layout == "keras3":
        request.getfixturevalue("tf")
        d = request.getfixturevalue("savedmodels")("f32" if precision == "float32" else "bf16")[0]
    else:
        d = request.getfixturevalue("keras2_dirs")[precision]
    model, config = port_tf.import_tf_checkpoint(d, device="cpu")
    want = torch.float32 if precision == "float32" else torch.bfloat16
    assert all(t.dtype == want for t in model.params.values())
    jmodel, _ = _jax_import(d)
    _assert_states_equal(_state("port", model), _state("jax", jmodel))
    with open(os.path.join(d, "config.yml")) as f:
        assert config == yaml.safe_load(f)


def test_encoder_dense_filters(tf, savedmodels):
    """An encoder with a hidden Dense (encoder_dense_filters): Dense_0 then
    Dense_1, bit for bit with the JAX import and within 1e-5 of TF."""
    d, encoder, _, _ = savedmodels("edf")
    model, _ = port_tf.import_tf_checkpoint(d, device="cpu")
    assert tuple(model.params["encoder.layers.Dense_0.weight"].shape) == (5, 6 * 5 * 8)
    _assert_states_equal(_state("port", model), _state("jax", _jax_import(d)[0]))
    x = np.random.RandomState(4).random((2, 20, 24, 3)).astype(np.float32)
    tf_latent = encoder(tf.constant(x)).numpy()
    assert float(np.mean((tf_latent - _latent("port", model, x)) ** 2)) < PARITY_MSE


# -- the writers: CRC-32C and TensorBundles that TF's reader takes ----------------------

def _crc32c_bytewise(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
    return crc ^ 0xFFFFFFFF


def test_crc32c_matches_the_bytewise_definition():
    """The chunked numpy CRC-32C equals the bit-at-a-time definition, at the
    check value and at lengths around its chunk and word boundaries, with
    the chunks joined over several levels."""
    assert testing.crc32c(b"123456789") == 0xE3069283
    assert testing.crc32c(b"") == 0
    rng = np.random.RandomState(0)
    for n in (1, 3, 4, 5, 255, 256, 257, 1023, 4099, 70001):
        data = rng.randint(0, 256, n).astype(np.uint8)
        assert testing.crc32c(data) == _crc32c_bytewise(data.tobytes()), n
    masked = testing.masked_crc32c(b"123456789")
    assert masked == ((((0xE3069283 >> 15) | (0xE3069283 << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


def test_tf_reads_write_tf_bundle(tf, tmp_path):
    """TF's reader takes the writer's bundle, over several data blocks, every
    dtype the importer reads, scalars and empty tensors, with each block's
    and each tensor's CRC checked: a flipped byte of a tensor is data loss
    to TF."""
    import ml_dtypes

    rng = np.random.RandomState(0)
    tensors = {"a/x": rng.randn(3, 4).astype(np.float32),
               "b": rng.randn(7).astype(ml_dtypes.bfloat16),
               "c": np.arange(-5, 5, dtype=np.int8), "d": rng.randn(2, 2),
               "e": np.arange(6, dtype=np.int64).reshape(2, 3), "f": np.float32(3.5).reshape(()),
               "g": np.zeros((0, 3), np.float32), "h": rng.randn(4).astype(np.float16)}
    tensors.update({f"many/{i:03d}": rng.randn(i % 5 + 1).astype(np.float32) for i in range(40)})
    prefix = str(tmp_path / "variables" / "variables")
    testing.write_tf_bundle(prefix, tensors, block_size=256)
    reader = tf.train.load_checkpoint(prefix)
    assert set(reader.get_variable_to_shape_map()) == set(tensors)
    ours = port_tf.read_tf_bundle(prefix)
    for key, want in tensors.items():
        got = np.asarray(reader.get_tensor(key))
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), key
        assert ours[key].dtype == want.dtype and ours[key].tobytes() == want.tobytes(), key
    data_file = prefix + ".data-00000-of-00001"
    with open(data_file, "r+b") as f:
        f.seek(5)
        byte = f.read(1)
        f.seek(5)
        f.write(bytes([byte[0] ^ 0xFF]))
    reader = tf.train.load_checkpoint(prefix)
    with pytest.raises(Exception, match="(?i)checksum|data ?loss|crc"):
        reader.get_tensor("a/x")


def test_unreadable_bundle_is_an_error_with_no_fallback(keras2_dirs, tmp_path):
    """An index that does not parse raises ValueError naming the file and the
    fault; TensorFlow is not asked instead."""
    import shutil

    d = str(tmp_path / "broken")
    shutil.copytree(keras2_dirs["float32"], d)
    index = os.path.join(d, "decoder", "variables", "variables.index")
    with open(index, "r+b") as f:
        f.seek(-8, os.SEEK_END)
        f.write(b"\x00" * 8)
    with pytest.raises(ValueError, match="variables.index: cannot read the TensorBundle: "
                                         "not a TF bundle index"):
        port_tf.import_tf_checkpoint(d, device="cpu")


_ONE_COPY = r"""
import sys
import ml_dtypes, numpy as np
from trustedai_cl_vae_ad_tpu_torch.bridge import _tensor


def status(field):
    with open("/proc/self/status") as f:
        return next(int(line.split()[1]) * 1024 for line in f if line.startswith(field + ":"))


dtype = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}[sys.argv[1]]
a = np.empty(1 << 26, dtype)
for i in range(0, a.size, 1 << 16):  # filled in pieces: no temporary of the leaf's size
    a[i:i + (1 << 16)] = np.arange(i, i + (1 << 16), dtype=np.float32)
a = a.reshape(1 << 13, 1 << 13).T
a.setflags(write=False)
base = status("VmRSS")
assert status("VmHWM") < base + a.nbytes // 4, "the high-water mark is above the resident set"
t = _tensor(a)
grew = status("VmHWM") - base
want = np.ascontiguousarray(a)
got = t.view(__import__("torch").int16).numpy() if sys.argv[1] == "bfloat16" else t.numpy()
assert t.is_contiguous() and got.tobytes() == want.view(got.dtype).tobytes()
print(grew / a.nbytes)
"""


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_copies_a_leaf_once(dtype):
    """bridge._tensor makes one C-order copy of a transposed, read-only leaf,
    bit for bit: the process's high-water mark grows by one leaf's bytes (it
    grew by two before), in a fresh process whose high-water mark is its
    resident set."""
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "-c", _ONE_COPY, dtype], capture_output=True,
                          text=True, timeout=120, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    assert float(proc.stdout.strip().splitlines()[-1]) < 1.25


# -- the CLI ------------------------------------------------------------------------------

@pytest.mark.parametrize("verify", [False, True])
def test_cli(request, tmp_path, capsys, verify):
    """tools/import_tf_checkpoint_torch.py --device cpu: the directory it
    writes loads with load_model_from_directory to the imported weights;
    --verify runs TF's serving signatures against the port (1e-5)."""
    import sys

    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import import_tf_checkpoint_torch as cli
    finally:
        sys.path.pop(0)
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory

    if verify:
        request.getfixturevalue("tf")
        d = request.getfixturevalue("savedmodels")("f32")[0]
    else:
        d = request.getfixturevalue("keras2_dirs")["float32"]
    out = str(tmp_path / "out")
    argv = [d, out, "--device", "cpu"] + (["--verify"] if verify else [])
    assert cli.main(argv) == 0
    printed = capsys.readouterr().out
    assert "Imported TF checkpoint" in printed
    assert ("parity OK" in printed) == verify
    reloaded, config = load_model_from_directory(out, device="cpu")
    imported, _ = port_tf.import_tf_checkpoint(d, device="cpu")
    _assert_states_equal(_state("port", reloaded), _state("port", imported))
    assert not os.path.exists(os.path.join(out, "optimizer"))
