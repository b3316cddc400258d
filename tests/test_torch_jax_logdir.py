"""The port reads the JAX package's log directories: orbax subtrees through
``train/orbax_read.py``, the rounds by the JAX package's rules, the Adam state
of ``inject_hyperparams`` with its learning rate, the ``quantized/`` sidecar
and its staleness verdict, and ``tools/convert_logdir_torch.py``'s copies.

Tolerances: parameters and Adam moments read bit for bit. Against the JAX
package's outputs from the same directory: float32 eval reconstructions at
rtol 1e-4 / atol 1e-5, ``w8a8`` at atol 2e-4 (an activation can cross a .5
boundary of its int8 rounding), the scorer by ``testing.compare``'s rules
(counts within 2, scores at rtol 1e-4 while counts agree); one training step's
loss dict at rtol 1e-4 / atol 1e-6 in float32 (``tests/test_torch_train_step.py``),
the parameters after it within 5% of the step's size (0.05 lr) and the Adam
moments within 1e-3 of the step's own change of each leaf; in bfloat16 the
loss dict at rtol 1e-3 / atol 1e-6, the parameters within one bfloat16 step
(relative 2^-7) plus half an Adam step (0.5 lr) and the moments within a
quarter of the step's change, since XLA and PyTorch round the bfloat16
convolutions' outputs apart by a step. Those bounds fail a step that was
skipped, taken at another rate or from moments that were not restored."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

import torch_jax_logdir_fixtures as fx
from torch_port_helpers import np_to_torch_exact, tiny_config
from trustedai_cl_vae_ad_tpu_torch.bridge import params_from_flax, params_to_flax, qparams_to_flax
from trustedai_cl_vae_ad_tpu_torch.train import checkpoint as ckpt
from trustedai_cl_vae_ad_tpu_torch.train import orbax_read

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = ("global_f32", "single_bf16")
STATES = ("current", "newest_after_killed_commit", "flat_legacy")


def _expected(name):
    with np.load(os.path.join(fx.DATA, f"{name}.npz")) as f:
        return dict(f)


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


def _jax_model(logdir, restore_optimizer=True):
    from trustedai_cl_vae_ad_tpu.registry import load_model_from_directory

    return load_model_from_directory(logdir, restore_optimizer=restore_optimizer)[0]


def _port_model(logdir, restore_optimizer=True):
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory

    return load_model_from_directory(logdir, device="cpu", restore_optimizer=restore_optimizer)


def _assert_model_equals_jax(tmodel, jmodel):
    """Parameters and Adam state of the port's model equal the JAX model's
    bit for bit (the port's layouts, the JAX dtypes)."""
    ref = params_from_flax(jax.device_get(jmodel.params))
    jtree = jax.device_get(jmodel.params)
    for key, t in tmodel.params.items():
        part, _layers, layer, leaf = key.split(".")
        arr = jtree[part][layer]["kernel" if leaf == "weight" else "bias"]
        assert t.dtype == (torch.bfloat16 if arr.dtype.name == "bfloat16" else torch.float32)
        assert torch.equal(t, ref[key]), key
    if jmodel.opt_state is None:
        assert tmodel.optimizer is None
        return
    inner = jax.device_get(jmodel.opt_state.inner_state[0])
    assert tmodel.optimizer.count == int(inner.count)
    for kind in ("mu", "nu"):
        ref_m = params_from_flax(getattr(inner, kind))
        jdt = _flat(getattr(inner, kind))
        for name, t in zip(tmodel.optimizer.names, getattr(tmodel.optimizer, kind)):
            part, _layers, layer, leaf = name.split(".")
            src = jdt[f"{part}/{layer}/{'kernel' if leaf == 'weight' else 'bias'}"]
            assert t.dtype == (torch.bfloat16 if src.dtype.name == "bfloat16" else torch.float32)
            assert torch.equal(t, ref_m[name]), (kind, name)


# -- the committed fixtures -----------------------------------------------------------

@pytest.mark.parametrize("name", FIXTURES)
def test_committed_fixture_recomputes_with_jax(name):
    """The JAX package, restoring the committed directory, computes the
    committed outputs (so the fixtures cannot rot): bit for bit where the
    arithmetic is the same, else at rtol 1e-6."""
    got = fx.jax_outputs(name, os.path.join(fx.DATA, name))
    ref = _expected(name)
    assert set(got) == set(ref)
    for key, value in ref.items():
        np.testing.assert_allclose(np.asarray(got[key], np.float64), value.astype(np.float64),
                                   rtol=1e-6, atol=1e-9, err_msg=key)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_loads_bit_for_bit(name):
    logdir = os.path.join(fx.DATA, name)
    tmodel, config = _port_model(logdir)
    _assert_model_equals_jax(tmodel, _jax_model(logdir))
    assert config == fx.fixture_config(name)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_scores_and_steps_like_jax(name):
    """The eval forward, the live engine's scores, the w8a8 forward from the
    JAX sidecar and one training step, against the JAX package's outputs."""
    from trustedai_cl_vae_ad_tpu_torch.ops import quant
    from trustedai_cl_vae_ad_tpu_torch.ops.stream_score import StreamScoreState
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import StreamingEngine

    logdir = os.path.join(fx.DATA, name)
    ref = _expected(name)
    bf16 = name.endswith("bf16")
    model, config = _port_model(logdir)
    x = torch.from_numpy(ref["frames"])
    rec = model.call(x).float().numpy()
    np.testing.assert_allclose(rec, ref["reconstruction"], rtol=1e-2 if bf16 else 1e-4,
                               atol=1e-3 if bf16 else 1e-5)
    engine = StreamingEngine(model, config, anomaly_settings=fx.SETTINGS)
    engine.inference_period_ms = 0.0
    maps, scalars = fx.warm_state()
    engine.score_state = StreamScoreState(torch.from_numpy(maps), torch.from_numpy(scalars))
    results = [engine.process_frame(f, now=float(i), tag=i) for i, f in enumerate(ref["frames"])]
    agreed = True
    for r, score, count in zip(results, ref["scores"], ref["counts"]):
        assert abs(r.pixel_count - count) <= 2
        agreed = agreed and r.pixel_count == count
        if agreed:
            np.testing.assert_allclose(r.score, score, rtol=1e-4)
    assert agreed
    if "reconstruction_w8a8" in ref:
        qparams = quant.load_quantized_checkpoint(logdir, "cpu")
        assert qparams["encoder"]["Dense_0"]["kernel_i8"].dtype == torch.int8
        assert qparams["decoder"]["Dense_0"]["kernel_i8"].dtype == torch.int8
        r8 = quant.call_quantized(model.core, qparams, x).float().numpy()
        np.testing.assert_allclose(r8, ref["reconstruction_w8a8"], rtol=0, atol=2e-4)
    lr = float(ref["learning_rate"])
    if bf16:  # the JAX package restores its injected rate into the parameters' dtype
        assert float(torch.tensor(model.learning_rate).to(torch.bfloat16)) == lr
    else:
        assert model.learning_rate == lr == float(np.float32(fx.LEARNING_RATE))
    opt = model.optimizer
    before = {kind: _flat(params_to_flax({n: t.clone()
                                          for n, t in zip(opt.names, getattr(opt, kind))}))
              for kind in ("mu", "nu")}
    loss, _ = model.train_step_and_run(x, eps=torch.from_numpy(ref["step_eps"]))
    assert {f"loss/{k}" for k in loss} == {k for k in ref if k.startswith("loss/")}
    for key, value in loss.items():
        np.testing.assert_allclose(float(value), ref[f"loss/{key}"], rtol=1e-3 if bf16 else 1e-4,
                                   atol=1e-6, err_msg=key)
    assert opt.count == int(ref["count"]) == 3
    for key, value in _flat(params_to_flax(model.params)).items():
        expect = ref[f"params/{key}"]
        if bf16:
            np.testing.assert_allclose(value, expect, rtol=2.0 ** -7, atol=0.5 * fx.LEARNING_RATE,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(value, expect, rtol=0, atol=0.05 * fx.LEARNING_RATE,
                                       err_msg=key)
    for kind in ("mu", "nu"):
        after = _flat(params_to_flax(dict(zip(opt.names, getattr(opt, kind)))))
        for key, value in after.items():
            expect = ref[f"{kind}/{key}"]
            change = np.abs(expect - before[kind][key]).max()
            assert change > 0, (kind, key)
            np.testing.assert_allclose(value, expect, rtol=0,
                                       atol=(0.25 if bf16 else 1e-3) * change,
                                       err_msg=f"{kind}/{key}")


@pytest.mark.parametrize("name", FIXTURES)
def test_converted_copy_equals_direct_read(name, monkeypatch, tmp_path):
    """The committed converted copy, and a fresh conversion, read with
    tensorstore blocked, give the direct read's tensors bit for bit, the
    learning rate and the sidecar."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import convert_logdir_torch

    from trustedai_cl_vae_ad_tpu_torch.ops import quant

    logdir = os.path.join(fx.DATA, name)
    direct = ckpt.restore_params(logdir)
    direct_opt = ckpt.restore_optimizer_state(logdir)
    direct_q = quant.load_quantized_checkpoint(logdir, "cpu") \
        if quant.has_quantized_checkpoint(logdir) else None
    fresh = tmp_path / "converted"
    convert_logdir_torch.main([logdir, str(fresh)])
    monkeypatch.setitem(sys.modules, "tensorstore", None)  # `import tensorstore` now raises
    with pytest.raises(ImportError):
        orbax_read.read_subtree(os.path.join(logdir, "encoder"))
    for copy in (os.path.join(fx.DATA, "converted", name), str(fresh)):
        got = ckpt.restore_params(copy)
        assert set(got) == set(direct)
        for key, t in direct.items():
            assert got[key].dtype == t.dtype and torch.equal(got[key], t), (copy, key)
        opt = ckpt.restore_optimizer_state(copy)
        assert opt["count"] == direct_opt["count"]
        assert opt["learning_rate"] == direct_opt["learning_rate"]
        for kind in ("mu", "nu"):
            for key, t in direct_opt[kind].items():
                assert opt[kind][key].dtype == t.dtype and torch.equal(opt[kind][key], t)
        with open(os.path.join(copy, "train_state.json")) as f:
            assert json.load(f) == {"epochs_completed": 1, "step": 2, "beta": 0.98e-6}
        if direct_q is None:
            assert not os.path.exists(os.path.join(copy, "quantized"))
            continue
        assert quant.quantized_staleness(copy) is None
        q = quant.load_quantized_checkpoint(copy, "cpu")
        for part, layers in direct_q.items():
            for layer, leaves in layers.items():
                for leaf, t in leaves.items():
                    assert torch.equal(q[part][layer][leaf], t), (part, layer, leaf)
    with pytest.raises(ValueError, match="source directory"):
        convert_logdir_torch.convert(logdir, os.path.join(logdir, "inside"))


def test_orbax_read_gives_the_inject_hyperparams_tree():
    tree = orbax_read.read_subtree(os.path.join(fx.DATA, "global_f32", "optimizer"))
    assert set(tree) == {"count", "hyperparams", "inner_state"}
    assert set(tree["hyperparams"]) == {"b1", "b2", "eps", "eps_root", "learning_rate"}
    assert set(tree["inner_state"]) == {"0"}
    assert set(tree["inner_state"]["0"]) == {"count", "mu", "nu"}
    assert int(tree["count"]) == int(tree["inner_state"]["0"]["count"]) == 2
    assert tree["hyperparams"]["learning_rate"] == np.float32(fx.LEARNING_RATE)
    enc = orbax_read.read_subtree(os.path.join(fx.DATA, "single_bf16", "encoder"))
    assert enc["Dense_0"]["kernel"].dtype.name == "bfloat16"
    lean = orbax_read.read_subtree(os.path.join(fx.DATA, "single_bf16", "optimizer"))
    assert set(lean["hyperparams"]) == {"learning_rate"}  # adam_lean injects the rate alone


def test_a_directory_of_neither_layout_names_both(tmp_path):
    logdir = tmp_path / "log"
    (logdir / "encoder").mkdir(parents=True)
    (logdir / "decoder").mkdir()
    with pytest.raises(FileNotFoundError, match=r"params\.pt.*_METADATA"):
        ckpt.restore_params(str(logdir))
    with pytest.raises(FileNotFoundError, match="_METADATA"):
        orbax_read.read_subtree(str(logdir / "encoder"))


# -- JAX saves in tmp_path, the port loads ------------------------------------------------

def _jax_save(logdir, config, seed, quantize=False):
    from trustedai_cl_vae_ad_tpu.models.wrapper import VAEModel
    from trustedai_cl_vae_ad_tpu.ops import quant as jquant
    from trustedai_cl_vae_ad_tpu.registry import build_core_from_config

    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "config.yml"), "w") as f:
        yaml.safe_dump(config, f)
    model = VAEModel(build_core_from_config(config), seed=seed)
    model.compile()
    model.train_step(np.random.RandomState(seed).randint(0, 256, (4, 32, 48, 3)).astype(np.uint8))
    model.set_learning_rate(2.5e-4)
    model.save_model(logdir)
    if quantize:
        jquant.save_quantized_checkpoint(
            logdir, jquant.quantize_params(model.core, model.params, min_elems=0))
    return model


def _round_state(logdir, config, state):
    """A JAX-written directory in ``state``; returns the model whose weights
    restoring must give."""
    first = _jax_save(logdir, config, seed=1, quantize=True)
    if state == "current":
        return first
    if state == "newest_after_killed_commit":
        # a second round committed by rename, then the kill: `current` and the
        # stable names were never made (as after a first save killed there)
        second = _jax_save(logdir, config, seed=2)
        for name in ("current", "encoder", "decoder", "optimizer"):
            os.remove(os.path.join(logdir, name))
        return second
    # the flat layout of JAX saves from before the rounds: real subtrees
    rnd = os.path.join(logdir, "rounds", "00000001")
    for name in ("current", "encoder", "decoder", "optimizer"):
        os.remove(os.path.join(logdir, name))
    for sub in ("encoder", "decoder", "optimizer"):
        shutil.move(os.path.join(rnd, sub), os.path.join(logdir, sub))
    shutil.rmtree(os.path.join(logdir, "rounds"))
    return first


@pytest.mark.parametrize("optimizer", ["adam", "adam_lean"])
@pytest.mark.parametrize("state", STATES)
def test_jax_round_states_load_bit_for_bit(tmp_path, state, optimizer):
    from trustedai_cl_vae_ad_tpu.ops import quant as jquant
    from trustedai_cl_vae_ad_tpu_torch.ops import quant

    config = tiny_config(latent=16, precision="bfloat16" if optimizer == "adam_lean" else None)
    config["training"]["optimizer"] = optimizer
    logdir = str(tmp_path / "log")
    _round_state(logdir, config, state)
    from trustedai_cl_vae_ad_tpu.train.checkpoint import resolve_round_dir as jax_resolve

    assert ckpt.resolve_round_dir(logdir) == jax_resolve(logdir)
    tmodel, _ = _port_model(logdir)
    jmodel = _jax_model(logdir)
    _assert_model_equals_jax(tmodel, jmodel)
    assert float(np.float32(tmodel.learning_rate)) == float(np.float32(2.5e-4))
    jq = jax.device_get(jquant.load_quantized_checkpoint(logdir))
    tq = quant.load_quantized_checkpoint(logdir, "cpu")
    assert tq["encoder"]["Dense_0"]["kernel_i8"].dtype == torch.int8
    back = _flat(qparams_to_flax(tq))
    for key, ref in _flat(jq).items():
        part, layer, leaf = key.split("/")
        stored = tq[part][layer]["weight" if leaf == "kernel" else leaf]
        assert stored.dtype == np_to_torch_exact(ref).dtype, key
        np.testing.assert_array_equal(back[key], np.asarray(ref).astype(back[key].dtype),
                                      err_msg=key)


def test_adam_fp8_is_refused_by_name(tmp_path):
    config = tiny_config(latent=16, precision="bfloat16")
    config["training"]["optimizer"] = "adam_fp8"
    logdir = str(tmp_path / "log")
    jmodel = _jax_save(logdir, config, seed=4)
    with pytest.raises(NotImplementedError, match="item 16"):
        _port_model(logdir, restore_optimizer=True)
    tmodel, _ = _port_model(logdir, restore_optimizer=False)
    assert tmodel.optimizer is None
    jmodel.opt_state = None
    _assert_model_equals_jax(tmodel, jmodel)


def _staleness_codes(logdir):
    from trustedai_cl_vae_ad_tpu.ops import quant as jquant
    from trustedai_cl_vae_ad_tpu_torch.ops import quant

    ref, got = jquant.quantized_staleness(logdir), quant.quantized_staleness(logdir)
    return (None if ref is None else ref[0]), (None if got is None else got[0])


def test_quantized_staleness_gives_the_jax_verdict(tmp_path):
    """Fresh, stale (the float checkpoint saved again after quantizing) and
    rebuilt (quantized again): the JAX package's verdict on each directory;
    then a JAX sidecar killed between its two renames heals in the port as
    in the JAX package."""
    from trustedai_cl_vae_ad_tpu.ops import quant as jquant
    from trustedai_cl_vae_ad_tpu_torch.ops import quant

    config = tiny_config(latent=16)
    logdir = str(tmp_path / "log")
    model = _jax_save(logdir, config, seed=5, quantize=True)
    assert _staleness_codes(logdir) == (None, None)
    model.save_model(logdir)
    assert _staleness_codes(logdir) == ("provenance_mismatch", "provenance_mismatch")
    jquant.save_quantized_checkpoint(logdir, jquant.quantize_params(
        model.core, model.params, min_elems=0))
    assert _staleness_codes(logdir) == (None, None)
    # without provenance the commit stamps decide: the float round is newer
    os.remove(os.path.join(logdir, "quantized", "float_provenance.json"))
    model.save_model(logdir)
    assert _staleness_codes(logdir) == ("commit_older", "commit_older")
    # a save killed between its two renames: only the complete staging copy is left
    ref = quant.load_quantized_checkpoint(logdir, "cpu")
    qdir = os.path.join(logdir, "quantized")
    os.rename(qdir, qdir + ".staging")
    with open(os.path.join(qdir + ".staging", "float_provenance.json"), "w") as f:
        json.dump({"float_checkpoint": jquant.float_checkpoint_stamp(logdir)}, f)
    assert quant.has_quantized_checkpoint(logdir) and os.path.isdir(qdir)
    assert _staleness_codes(logdir) == (None, None)
    got = quant.load_quantized_checkpoint(logdir, "cpu")
    assert torch.equal(got["encoder"]["Dense_0"]["kernel_i8"],
                       ref["encoder"]["Dense_0"]["kernel_i8"])


# -- the learning rate across a save and a resume ------------------------------------------

def test_learning_rate_survives_a_port_save_and_resume(tmp_path):
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config

    config = tiny_config(latent=16)
    config["training"]["learning_rate"] = 1e-4
    model = load_model_from_config(config, device="cpu")
    model.compile()
    model.set_learning_rate(2.5e-4)
    logdir = str(tmp_path / "log")
    with open(os.path.join(tmp_path, "config.yml"), "w") as f:
        yaml.safe_dump(config, f)
    os.makedirs(logdir)
    shutil.copy(os.path.join(tmp_path, "config.yml"), logdir)
    model.save_model(logdir)
    flat = torch.load(os.path.join(logdir, "optimizer", "state.pt"), weights_only=True)
    assert flat["learning_rate"].dtype == torch.float32
    resumed, _ = _port_model(logdir)
    assert resumed.learning_rate == float(np.float32(2.5e-4))
    # a state.pt written before the rate was saved keeps the compiled rate
    del flat["learning_rate"]
    torch.save(flat, os.path.join(logdir, "optimizer", "state.pt"))
    assert _port_model(logdir)[0].learning_rate == 1e-4


def test_learning_rate_from_a_jax_save_reaches_the_engines_and_the_loop(tmp_path):
    """After a resume from a JAX directory the live engine and the fleet
    engine run at the saved rate, a CLI rate still replaces it, and
    ``train_model``'s per-epoch schedule sets its own, as in the JAX package."""
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import load_engine_from_directory
    from trustedai_cl_vae_ad_tpu_torch.stream.multicam import MultiCameraEngine
    from trustedai_cl_vae_ad_tpu_torch.stream.run import configure_continual_learning
    from trustedai_cl_vae_ad_tpu_torch.train.loop import lr_schedule_fn

    logdir = os.path.join(fx.DATA, "global_f32")
    rate = float(np.float32(fx.LEARNING_RATE))
    engine = load_engine_from_directory(logdir, device="cpu")
    assert engine.model.learning_rate == rate == _jax_model(logdir).learning_rate
    configure_continual_learning(engine, continual_learning=True)
    assert engine.model.learning_rate == rate
    configure_continual_learning(engine, continual_learning=True, learning_rate=5e-4)
    assert engine.model.learning_rate == 5e-4
    model, config = _port_model(logdir)
    fleet = MultiCameraEngine(model, config, n_streams=2)
    assert fleet.model.learning_rate == rate
    from trustedai_cl_vae_ad_tpu.train.loop import lr_schedule_fn as jax_lr_schedule_fn

    config = dict(config, training=dict(config["training"], lr_schedule="reference"))
    for epoch in range(12):
        assert lr_schedule_fn(config)(epoch) == jax_lr_schedule_fn(config)(epoch)


def test_train_state_json_is_shared_with_the_jax_loop(tmp_path):
    from trustedai_cl_vae_ad_tpu.train import loop as jloop
    from trustedai_cl_vae_ad_tpu_torch.train import loop

    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    os.makedirs(a)
    os.makedirs(b)
    jloop.save_train_state(a, epochs_completed=3, step=17, beta=1.5e-6)
    loop.save_train_state(b, epochs_completed=3, step=17, beta=1.5e-6)
    for d in (a, b):
        with open(os.path.join(d, loop.TRAIN_STATE_FILE)) as f:
            assert set(json.load(f)) == {"epochs_completed", "step", "beta"}
        assert loop.load_train_state(d) == jloop.load_train_state(d)
    assert loop.load_train_state(os.path.join(fx.DATA, "global_f32")) == jloop.load_train_state(
        os.path.join(fx.DATA, "global_f32"))


# -- the entry points take a JAX log directory -------------------------------------------

def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *args], capture_output=True, text=True, timeout=240,
                          cwd=cwd, env=env)


def test_entry_points_take_a_jax_logdir(tmp_path):
    """``camera_streamer_torch.py -m <jax logdir> -c``, the int8 boot from the
    JAX sidecar, ``tools/quantize_checkpoint_torch.py`` on a copy of a JAX
    directory, and ``train_torch.py --resume <jax logdir>``."""
    logdir = os.path.join(fx.DATA, "global_f32")
    streamer = os.path.join(REPO, "camera_streamer_torch.py")
    proc = _run([streamer, "-m", logdir, "--device", "cpu", "--source", "synthetic",
                 "--max-frames", "6", "-c"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    proc = _run([streamer, "-m", logdir, "--device", "cpu", "--source", "synthetic",
                 "--max-frames", "4", "--quantize"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "int8 boot" in proc.stdout
    copy = str(tmp_path / "copy")
    shutil.copytree(logdir, copy, symlinks=True)
    proc = _run([os.path.join(REPO, "tools", "quantize_checkpoint_torch.py"), "-m", copy,
                 "--min-elems", "0", "--device", "cpu"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    from trustedai_cl_vae_ad_tpu_torch.ops import quant

    assert os.path.isfile(os.path.join(copy, "quantized", quant.QUANTIZED_FILE))
    assert quant.quantized_staleness(copy) is None
    config = fx.fixture_config("global_f32")
    config["data"].update(dataset="synthetic", n_train=8, n_val=8)
    cfg_path = tmp_path / "resume.yml"
    cfg_path.write_text(yaml.safe_dump(config))
    proc = _run([os.path.join(REPO, "train_torch.py"), str(cfg_path), "--device", "cpu",
                 "--resume", logdir, "--dry-run"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Resume state: 1 epochs done, step 2" in proc.stdout


# -- flagship width (not in Tier-1) ----------------------------------------------------------

def _pattern(shape, salt, rows=None):
    """Deterministic float32 values, exact in float32, of a leaf (or of its first-axis
    ``rows`` slice): no 5 GB original has to stay in memory to check the read."""
    start, stop = (0, shape[0]) if rows is None else rows
    inner = int(np.prod(shape[1:]))
    i = np.arange(start * inner, stop * inner, dtype=np.uint64)
    v = ((i * np.uint64(2654435761) + np.uint64(salt)) % np.uint64(1 << 24)).astype(np.float32)
    return (v / np.float32(1 << 24) - np.float32(0.5)).reshape((stop - start,) + tuple(shape[1:]))


@pytest.mark.slow
def test_flagship_width_jax_logdir_reads_bit_for_bit(tmp_path):
    """``configs/config.yml``'s parameter trees at full width (1.34 G float32 values, 5.4 GB)
    saved by the JAX package's ``save_checkpoint`` (orbax), read through ``orbax_read`` bit for
    bit: orbax splits the 268800x4000 encoder Dense into chunks, and the read must join them.
    The shapes come from the port's model built on the meta device (nothing is allocated or
    traced); the values are a pattern checked block by block."""
    from trustedai_cl_vae_ad_tpu.train.checkpoint import save_checkpoint
    from trustedai_cl_vae_ad_tpu_torch.config import load_config
    from trustedai_cl_vae_ad_tpu_torch.registry import build_core_from_config

    core = build_core_from_config(load_config(os.path.join(REPO, "configs", "config.yml")))
    shapes = {}
    for key, t in core.state_dict().items():
        part, _layers, layer, leaf = key.split(".")
        shape = tuple(t.shape)
        if leaf == "weight":
            perm = (1, 0) if layer.startswith("Dense_") else (2, 3, 1, 0)
            shape = tuple(shape[i] for i in perm)
        shapes[(part, layer, "kernel" if leaf == "weight" else "bias")] = shape
    assert shapes[("encoder", "Dense_0", "kernel")] == (268800, 4000)
    salts = {key: n for n, key in enumerate(sorted(shapes))}
    params = {"encoder": {}, "decoder": {}}
    for (part, layer, leaf), shape in shapes.items():
        params[part].setdefault(layer, {})[leaf] = _pattern(shape, salts[(part, layer, leaf)])
    logdir = str(tmp_path / "flagship")
    save_checkpoint(logdir, params)
    del params
    for part in ("encoder", "decoder"):
        tree = orbax_read.read_subtree(os.path.join(ckpt.resolve_round_dir(logdir), part))
        assert set(tree) == {layer for p, layer, _ in shapes if p == part}
        for layer, leaves in tree.items():
            for leaf, got in leaves.items():
                shape = shapes[(part, layer, leaf)]
                assert got.dtype == np.float32 and got.shape == shape
                block = 8192
                for r0 in range(0, shape[0], block):
                    rows = (r0, min(r0 + block, shape[0]))
                    ref = _pattern(shape, salts[(part, layer, leaf)], rows)
                    assert np.array_equal(got[rows[0]:rows[1]].view(np.uint32),
                                          ref.view(np.uint32)), (part, layer, leaf, rows)
        del tree
