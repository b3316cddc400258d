"""The port's Qt shells (``camera_streamer_qt_torch.py``,
``decoder_generator_qt_torch.py``) driven through the PyQt5 stub
(``tests/qt_stub.py``), case for case as ``tests/test_qt_shells.py`` drives the
JAX package's, and their headless CLIs as ``tests/test_integration.py`` runs the
JAX ones.

Both packages' windows load the same seeded weights (the JAX model's init
through ``bridge.py``) and read the same synthetic frames. Where a window
produces a number, the JAX window's stands beside it: scores by
``testing.py``'s rule (counts within 2, scores at rtol 1e-4 up to the first
frame whose counts differ: a fresh scorer's first count is float32 rounding
noise in both packages), the maps behind the error pane within one grey level
and the panes' pixels equal wherever those maps are, decoded images within 1e-5
before rounding, and the encoded latents of ``--histogram`` at rtol 1e-5.
"""

import copy
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import yaml
from PIL import Image

from tests import qt_stub

qt_stub.install()

import camera_streamer_qt  # noqa: E402
import camera_streamer_qt_torch  # noqa: E402
import decoder_generator_qt  # noqa: E402
import decoder_generator_qt_torch  # noqa: E402
from tests.torch_port_helpers import paired_models  # noqa: E402
from trustedai_cl_vae_ad_tpu_torch.testing import COUNT_TOL, SCORE_RTOL  # noqa: E402

assert camera_streamer_qt_torch.HAVE_QT and decoder_generator_qt_torch.HAVE_QT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = {
    "data": {"dataset": "synthetic", "image_size": [16, 16, 3], "n_train": 8, "n_val": 4},
    "loss": {"kurtosis": 1.8, "w_kl_divergence": 0.0, "w_kurtosis": 1e-4, "w_mse": 1.0,
             "w_skew": 0.0, "w_z_l1_reg": 0.0},
    "model": {"type": "KurtosisSingle", "decoder_dense_filters": 4, "latent_dimensions": 4,
              "layers": [4]},
    "training": {"batch_size": 4, "beta": 1e-6, "learning_rate": 1e-3, "max_epochs": 1},
}
SETTINGS = {"anomaly_score_threshold": 2.0, "anomaly_score_method": "zz_count",
            "buffer_record_period_s": 1.0, "anomalous_state_period_s": 0.05}
WINDOWS = {"port": camera_streamer_qt_torch, "jax": camera_streamer_qt}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The same seeded weights saved as a JAX and as a port log directory. The
    windows' CL metrics go to metrics.jsonl only: importing TensorBoard's writer
    (which imports TensorFlow here) would cost each worker ~11 s and is not what
    these cases hold."""
    from trustedai_cl_vae_ad_tpu.config import save_config as jax_save_config
    from trustedai_cl_vae_ad_tpu.utils import metrics as jax_metrics
    from trustedai_cl_vae_ad_tpu_torch.config import save_config
    from trustedai_cl_vae_ad_tpu_torch.utils import metrics

    patch = pytest.MonkeyPatch()
    for module in (metrics, jax_metrics):
        patch.setattr(module, "_try_tensorboard", lambda logdir: None)
    root = tmp_path_factory.mktemp("qt_models")
    jmodel, tmodel = paired_models(copy.deepcopy(CONFIG), compile=False)
    dirs = {"jax": str(root / "jax"), "port": str(root / "port")}
    jmodel.save_model(dirs["jax"], include_optimizer=False)
    jax_save_config(copy.deepcopy(CONFIG), os.path.join(dirs["jax"], "config.yml"))
    tmodel.save_model(dirs["port"], include_optimizer=False)
    save_config(copy.deepcopy(CONFIG), os.path.join(dirs["port"], "config.yml"))
    yield {"dirs": dirs, "jmodel": jmodel, "tmodel": tmodel, "root": root}
    patch.undo()


def _cam_config(tmp_path, cameras=None, name="cam.yml"):
    cameras = cameras or [{"name": "c0", "url": "synthetic", "fps": 10}]
    path = tmp_path / name
    path.write_text(yaml.safe_dump({"camera_list": cameras, "anomaly_settings": SETTINGS}))
    return str(path)


def _window(package, env, tmp_path, cam_config=None, warmup=None):
    """A camera window of ``package`` over its log directory, on the CPU, scoring
    every tick."""
    args = types.SimpleNamespace(
        cam_config=cam_config or _cam_config(tmp_path), cam_config_index=0,
        model_cache_dir=str(tmp_path / f"cache_{package}"), model_dir=env["dirs"][package],
        warmup=warmup, device="cpu")
    w = WINDOWS[package].CameraStreamerMainWindow(args)
    w.engine.inference_period_ms = 0.0
    return w


@pytest.fixture
def cam_window(env, tmp_path):
    return _window("port", env, tmp_path)


@pytest.fixture
def jax_window(env, tmp_path):
    return _window("jax", env, tmp_path)


def _tick(w, n=1):
    """n ticks (grab a frame, draw); the result each tick scored."""
    results = []
    for _ in range(n):
        w.grab_frame()
        w.update_draws()
        results.append(w.last_result)
    return results


def _assert_scores_agree(got, ref):
    """testing.py's rule on the windows' results: counts within COUNT_TOL, and scores
    (NaN where the reference is NaN) at SCORE_RTOL up to the first frame whose counts
    differ. Returns how many scores were compared."""
    compared = 0
    for i, (g, r) in enumerate(zip(got, ref)):
        assert abs(g.pixel_count - r.pixel_count) <= COUNT_TOL, (i, g.pixel_count, r.pixel_count)
        if g.pixel_count != r.pixel_count:
            break
        assert np.isnan(g.score) == np.isnan(r.score), (i, g.score, r.score)
        if not np.isnan(r.score):
            np.testing.assert_allclose(g.score, r.score, rtol=SCORE_RTOL, err_msg=f"tick {i}")
            compared += 1
    return compared


def _pixels(label):
    return label._pixmaps[-1].img.array


# -- tests/test_qt_shells.py, case for case -------------------------------------------------

def test_cam_window_stream_and_inference(cam_window, jax_window):
    w = cam_window
    got = _tick(w, 3)
    assert w.last_frame is not None
    assert w.stream_label._pixmaps, "stream pane never drew"
    assert w.error_label._pixmaps, "inference pane never drew"
    assert w.last_result is not None
    assert w.anomaly_lbl.text().startswith("AS:")
    assert "timings:" in w.timing_lbl.text() and "process_rate" in w.timing_lbl.text()
    ref = _tick(jax_window, 3)
    _assert_scores_agree(got, ref)
    np.testing.assert_array_equal(_pixels(w.stream_label), _pixels(jax_window.stream_label))


def test_cam_window_view_modes(cam_window, jax_window):
    """Each view mode draws; the maps behind it are within one grey level of the JAX
    window's, and the pane's pixels equal the JAX pane's wherever those maps are equal."""
    w = cam_window
    got, ref = [], []
    for mode in ("error", "reconstruction", "heatmap", "overlay"):
        before = len(w.error_label._pixmaps)
        for win, out in ((w, got), (jax_window, ref)):
            win.view_mode.setCurrentText(mode)
            out += _tick(win)
        assert len(w.error_label._pixmaps) > before, mode
        g, r = w.last_result, jax_window.last_result
        norm_g, norm_r = g.norm_err_u8.astype(int), np.asarray(r.norm_err_u8).astype(int)
        rec_g, rec_r = g.reconstruction_u8.astype(int), np.asarray(r.reconstruction_u8).astype(int)
        assert np.abs(norm_g - norm_r).max() <= 1, mode
        assert np.abs(rec_g - rec_r).max() <= 1, mode
        same = {"error": norm_g == norm_r, "reconstruction": (rec_g == rec_r).all(-1),
                "heatmap": norm_g == norm_r,
                "overlay": (norm_g == norm_r) & (rec_g == rec_r).all(-1)}[mode]
        pane_g, pane_r = _pixels(w.error_label), _pixels(jax_window.error_label)
        np.testing.assert_array_equal(pane_g[same], pane_r[same], err_msg=mode)
    _assert_scores_agree(got, ref)


def test_cam_window_anomalous_indicator(cam_window):
    """The anomalous state drives a visible change of the label, not only a text
    marker. The state is forced: the score is NaN while the scorer warms up, so
    tripping the threshold with real scores depends on timing."""
    w = cam_window
    w.engine.anomalous_state = True  # held: no start time, so the machine keeps it
    _tick(w)
    assert "background-color" in w.anomaly_lbl.styleSheet()
    assert w.anomaly_lbl.text().endswith("**")
    w.engine.anomalous_state = False
    _tick(w)
    assert w.anomaly_lbl.styleSheet() == ""


def test_cam_window_dials(cam_window, jax_window):
    """The lr dial is deferred while CL is off (set_learning_rate allocates the
    optimizer's moments, which an inference-only session never uses) and applied
    when CL turns on; the JAX window dials to the same rate."""
    for w in (cam_window, jax_window):
        w.lr_man.setValue(2.5)
        w.lr_exp.setValue(-3)
        # dialing with CL off allocates no optimizer
        assert w.engine.model.optimizer is None
        w.record_period.setValue(2.0)
        assert w.engine.record_period_ms == 2000.0
        w.cl_checkbox.setChecked(True)
        assert w.engine.enable_cont_learning
        # the deferred dial value lands when CL turns on
        assert abs(w.engine.model.learning_rate - 2.5e-3) < 1e-9
        # further dialing applies live while CL is on
        w.lr_man.setValue(3.0)
        assert abs(w.engine.model.learning_rate - 3.0e-3) < 1e-9
        w.noise_man.setValue(2.0)
        w.cl_checkbox.setChecked(False)
    assert cam_window.engine.model.beta == 2e-6
    assert np.float32(jax_window.engine.model.beta) == np.float32(2e-6)


def test_cam_window_combine_action(cam_window, tmp_path):
    for name, ids in (("a", [0, 1]), ("b", [0])):
        d = tmp_path / name
        d.mkdir()
        labels = {"info": {}, "categories": [], "annotations": [],
                  "images": [{"id": i, "width": 4, "height": 4,
                              "file_name": f"{name}{i}.png"} for i in ids]}
        (d / "labels.json").write_text(json.dumps(labels))
    dest = tmp_path / "merged"
    dest.mkdir()
    qt_stub.QFileDialog.existing_dirs = [str(tmp_path / "a"), str(tmp_path / "b"), "",
                                         str(dest)]
    qt_stub.QMessageBox.messages.clear()
    cam_window._combine_datasets_dialog()
    assert qt_stub.QMessageBox.messages[-1][0] == "information"
    with open(dest / "labels.json") as f:
        assert len(json.load(f)["images"]) == 3


def test_cam_window_recording_toggle(cam_window, jax_window, tmp_path):
    """A recording over two ticks writes a dataset whose labels.json loads, with as
    many images as the JAX window's."""
    counts = []
    for package, w in (("port", cam_window), ("jax", jax_window)):
        rec = tmp_path / f"rec_{package}"
        rec.mkdir()
        qt_stub.QFileDialog.existing_dirs = [str(rec)]
        w.engine.record_period_ms = 0.0
        w.record_btn.setChecked(True)
        assert w.engine.recording_flag
        _tick(w, 2)
        w.record_btn.setChecked(False)
        assert not w.engine.recording_flag
        inst = [p for p in rec.iterdir() if p.name.startswith("data_")]
        assert inst and (inst[0] / "labels.json").exists()
        with open(inst[0] / "labels.json") as f:
            counts.append(len(json.load(f)["images"]))
    assert counts[0] == counts[1] > 0


def test_decoder_window_spinbox_redraw(env):
    """The debounced redraw draws the decode of the spinboxes' z: within 1e-5 of the
    JAX window's decode before rounding, and its pixels within one grey level."""
    from trustedai_cl_vae_ad_tpu.registry import load_model_from_directory as jax_load
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory

    model, config = load_model_from_directory(env["dirs"]["port"], device="cpu")
    w = decoder_generator_qt_torch.DecoderGeneratorMainWindow(model, config)
    jmodel, jconfig = jax_load(env["dirs"]["jax"])
    jw = decoder_generator_qt.DecoderGeneratorMainWindow(jmodel, jconfig)
    assert len(w.spinboxes) == 4
    for win in (w, jw):
        win.spinboxes[0].setValue(0.7)
        win.timer.fire()  # the debounced redraw
    assert w.image_label._pixmaps, "decoder pane never drew"
    z = np.array([[0.7, 0.0, 0.0, 0.0]], np.float32)
    np.testing.assert_allclose(model.decode(z, apply_sigmoid=True)[0].numpy(),
                               np.asarray(jmodel.decode(z, apply_sigmoid=True))[0], atol=1e-5)
    got, ref = _pixels(w.image_label).astype(int), _pixels(jw.image_label).astype(int)
    assert np.abs(got - ref).max() <= 1
    # a clean timer tick does not redraw
    n = len(w.image_label._pixmaps)
    w.timer.fire()
    assert len(w.image_label._pixmaps) == n


def test_cam_window_camera_switch_menu(env, tmp_path):
    """The camera menu: one exclusive checkable action per camera_list entry;
    selecting one reopens the source at the new camera's fps and updates
    engine.cam_info."""
    cam_config = _cam_config(tmp_path, [{"name": "front", "url": "synthetic", "fps": 10},
                                        {"name": "back", "url": "synthetic", "fps": 25}],
                             "cam2.yml")
    w = _window("port", env, tmp_path, cam_config=cam_config)
    names = [a.text() for a in w.cam_menu.actions_]
    assert names == ["front", "back"]
    assert w.cam_menu.actions_[0].isChecked()
    old_source = w.source
    w.cam_menu.actions_[1].trigger()
    assert w.cam_config_idx == 1
    assert w.cam_info["name"] == "back"
    assert w.source is not old_source
    assert w.stream_timer.interval == int(1000.0 / 25)
    assert w.engine.cam_info["name"] == "back"
    assert w.select_camera_from_name("front")
    assert w.cam_config_idx == 0
    assert not w.select_camera_from_name("nope")


def test_cam_window_toggle_inference(cam_window):
    """Unchecked, the inference toggle stops the engine's dispatch while the raw
    stream keeps drawing."""
    w = cam_window
    _tick(w, 2)
    w.toggle_inference_btn.setChecked(False)
    before_err = len(w.error_label._pixmaps)
    before_stream = len(w.stream_label._pixmaps)
    last = w.last_result
    _tick(w, 3)
    assert len(w.error_label._pixmaps) == before_err  # no inference draws
    assert len(w.stream_label._pixmaps) > before_stream  # the stream still draws
    assert w.last_result is last
    w.toggle_inference_btn.setChecked(True)
    _tick(w)
    assert len(w.error_label._pixmaps) > before_err


def test_cam_window_anomaly_override(cam_window):
    """The manual anomalous-state button, gated by the Enable checkbox."""
    w = cam_window
    # Enable unchecked (the default): the override is refused
    assert not w.enable_anomaly_cbx.isChecked()
    assert not w.engine.enable_anomaly_state
    w.anomaly_state_btn.setChecked(True)
    w._anomaly_state_btn_pressed()
    assert not w.engine.anomalous_state
    assert not w.anomaly_state_btn.isChecked()  # the button reflects the refusal
    # Enable checked: the override latches the engine's state
    w.enable_anomaly_cbx.setChecked(True)
    assert w.engine.enable_anomaly_state
    w.anomaly_state_btn.setChecked(True)
    w._anomaly_state_btn_pressed()
    assert w.engine.anomalous_state
    assert w.anomaly_state_btn.isChecked()
    # unchecking Enable clears the state
    w.enable_anomaly_cbx.setChecked(False)
    assert not w.engine.anomalous_state
    assert not w.anomaly_state_btn.isChecked()


def test_cam_window_new_model(cam_window, tmp_path):
    """New Model builds a fresh model from a config file in-app, on the window's
    device; the lr dials re-seed from the new config."""
    new_cfg = copy.deepcopy(CONFIG)
    new_cfg["loss"]["w_kl_divergence"] = 1e-4
    new_cfg["model"]["type"] = "KLGaussian"
    new_cfg["training"]["learning_rate"] = 2.5e-3
    del new_cfg["data"]["dataset"], new_cfg["data"]["n_train"], new_cfg["data"]["n_val"]
    cfg_path = tmp_path / "new_model.yml"
    cfg_path.write_text(yaml.safe_dump(new_cfg))
    w = cam_window
    old_engine = w.engine
    qt_stub.QFileDialog.open_files = [str(cfg_path)]
    w._new_model_dialog()
    assert w.engine is not old_engine
    assert type(w.engine.model.core).__name__ == "KLGaussianCVAE"
    assert w.engine.model.device.type == "cpu"
    assert w.lr_exp.value() == -3
    assert abs(w.lr_man.value() - 2.5) < 1e-9
    w.engine.inference_period_ms = 0.0
    _tick(w, 2)  # the new engine streams
    assert w.last_result is not None
    # a bad config file reports the failure instead of killing the window
    bad = tmp_path / "bad.yml"
    bad.write_text("model: {type: Bogus}\n")
    qt_stub.QFileDialog.open_files = [str(bad)]
    qt_stub.QMessageBox.messages.clear()
    w._new_model_dialog()
    assert qt_stub.QMessageBox.messages[-1][0] == "critical"


def test_cam_window_new_model_failure_keeps_old_engine(cam_window, tmp_path, monkeypatch):
    """If the replacement engine's construction raises, the app keeps running on the
    old engine with its metrics writer still open: the old engine is closed only
    after the new one exists."""
    cfg_path = tmp_path / "boom.yml"
    cfg_path.write_text(yaml.safe_dump(CONFIG))
    w = cam_window
    old_engine = w.engine

    def boom(*a, **k):
        raise RuntimeError("construction OOM")

    monkeypatch.setattr(camera_streamer_qt_torch, "StreamingEngine", boom)
    qt_stub.QFileDialog.open_files = [str(cfg_path)]
    qt_stub.QMessageBox.messages.clear()
    w._new_model_dialog()
    assert qt_stub.QMessageBox.messages[-1][0] == "critical"
    assert w.engine is old_engine
    # the old engine still streams and its writer still takes records
    w.engine.inference_period_ms = 0.0
    _tick(w, 2)
    assert w.last_result is not None
    assert w.engine.metrics is not None
    w.engine.metrics.log(1, {"loss": 0.0}, prefix="cl/")


class _Noise:
    """Noise frames, not the moving gradient: a scene without variance keeps the
    score-normalizing EMA std at 0 and the score NaN, which would make a comparison
    of scores vacuous. 35 ticks clear the scorer's warm-up (finite from about frame
    13 on noise)."""
    fps = 10.0

    def __init__(self):
        self._rng = np.random.RandomState(5)

    def read(self):
        return self._rng.randint(0, 255, (240, 320, 3), np.uint8)

    def release(self):
        pass


def test_cam_window_warmup(env, tmp_path, monkeypatch, capsys):
    """--warmup runs the dispatch once at construction on the camera's resolution,
    says so, and changes no result: a warmed and an unwarmed window score 35 noise
    ticks alike (the warm-up runs on scratch state)."""
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import StreamingEngine

    shapes = []
    warmup = StreamingEngine.warmup

    def recorded(self, frame_shape=None, cl=False):
        shapes.append(frame_shape)
        return warmup(self, frame_shape=frame_shape, cl=cl)

    monkeypatch.setattr(StreamingEngine, "warmup", recorded)
    w = _window("port", env, tmp_path, warmup=(240, 320))
    assert shapes == [(240, 320, 3)]
    assert "warming up" in capsys.readouterr().out
    scores = []
    for win in (w, _window("port", env, tmp_path)):
        win.source = _Noise()
        _tick(win, 35)
        scores.append(win.last_result.score)
    assert shapes == [(240, 320, 3)]  # the unwarmed window ran no warm-up
    a, b = scores
    assert np.isfinite(a), "score still NaN after 35 ticks: vacuous test"
    assert a == b


def test_decoder_warmup_flag(env, capsys):
    """--warmup decodes one zero vector before the window shows, then the GUI path
    proceeds (the stub's event loop returns 0)."""
    with pytest.raises(SystemExit) as e:
        decoder_generator_qt_torch.main([env["dirs"]["port"], "--warmup", "--device", "cpu"])
    assert e.value.code == 0
    assert "warming up" in capsys.readouterr().out


def test_np_to_pixmap_stride_exact_on_odd_widths():
    """QImage's scanline math on widths where 3*w is not a multiple of 4: the shell
    passes stride=3*w, so the decoded pixels equal the source for w = 25, 31, 333,
    and for the grayscale and 1-channel paths."""
    rng = np.random.RandomState(7)
    for w in (25, 31, 333):
        arr = rng.randint(0, 255, (17, w, 3), np.uint8)
        pix = camera_streamer_qt_torch._np_to_pixmap(arr)
        np.testing.assert_array_equal(pix.img.array, arr)
    g = rng.randint(0, 255, (9, 25), np.uint8)
    np.testing.assert_array_equal(camera_streamer_qt_torch._np_to_pixmap(g).img.array,
                                  np.stack([g] * 3, axis=-1))
    np.testing.assert_array_equal(camera_streamer_qt_torch._np_to_pixmap(g[..., None]).img.array,
                                  np.stack([g] * 3, axis=-1))


def test_decoder_pane_stride_exact_on_an_odd_width():
    """The stub's stride check on the port's decoder pane: a model whose width makes
    3*w no multiple of 4 (18 pixels: 54 bytes a row) draws exactly the decode's
    rounded pixels, row for row."""
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config

    config = copy.deepcopy(CONFIG)
    config["data"]["image_size"] = [12, 18, 3]
    model = load_model_from_config(config, seed=3, device="cpu")
    w = decoder_generator_qt_torch.DecoderGeneratorMainWindow(model, config)
    for i, v in enumerate((0.5, -1.0, 2.0)):
        w.spinboxes[i].setValue(v)
    w.timer.fire()
    z = np.array([[0.5, -1.0, 2.0, 0.0]], np.float32)
    img = model.decode(z, apply_sigmoid=True)[0].numpy()
    want = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
    assert want.shape == (12, 18, 3)
    np.testing.assert_array_equal(_pixels(w.image_label), want)


def test_cam_window_rss_guard_exits_3(cam_window):
    """--max-rss-mb: on breach the tick handler stops both timers, saves and drains,
    and quits the event loop with code 3 so a supervisor restarts the app."""
    from tests.qt_stub import QApplication

    w = cam_window
    app = QApplication([])  # the instance main() would have created
    w.max_rss_mb = 1.0  # any real python process is far above 1 MB
    _tick(w, 25)  # the guard polls every 25 ticks
    assert app.exit_code == 3
    assert not w.stream_timer.active and not w.update_timer.active
    # without the flag nothing exits (a fresh app instance)
    w2_app = QApplication([])
    w.max_rss_mb = None
    w.stream_timer.start(50)
    w.update_timer.start(50)
    _tick(w, 26)
    assert w2_app.exit_code is None


# -- tests/test_integration.py: the headless decoder and the gate -------------------------

def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, os.path.join(REPO, script), *args],
                          capture_output=True, text=True, timeout=300, env=env, cwd=REPO)


def test_decoder_generator_headless(env, tmp_path, capsys):
    """decoder_generator_qt_torch.py --decode-z through its main: the PNG's pixels
    within one grey level of the JAX model's decode of the same z, and the decode
    before rounding within 1e-5 of it (the gate below runs the script itself)."""
    out = tmp_path / "decoded.png"
    img = decoder_generator_qt_torch.main([env["dirs"]["port"], "--decode-z", "0.5,-0.5,0.1,0.0",
                                           "-o", str(out), "--device", "cpu"])
    assert "decoded z ->" in capsys.readouterr().out
    z = np.array([[0.5, -0.5, 0.1, 0.0]], np.float32)
    ref = np.asarray(env["jmodel"].decode(z, apply_sigmoid=True))[0]
    np.testing.assert_allclose(img, ref, atol=1e-5)
    with Image.open(out) as png:
        got = np.asarray(png).astype(int)
    ref = np.clip(np.round(ref * 255.0), 0, 255).astype(int)
    assert got.shape == ref.shape == (16, 16, 3)
    assert np.abs(got - ref).max() <= 1


@pytest.mark.parametrize("script,args,names", [
    ("camera_streamer_qt_torch.py", ["configs/cam_config.yml"], "camera_streamer_torch.py"),
    ("decoder_generator_qt_torch.py", [], "--decode-z"),
])
def test_qt_shells_gate_cleanly(env, script, args, names):
    """Without PyQt5 the Qt CLIs import fine and exit 2 with guidance: the camera
    window names the headless CLI, the decoder its headless modes."""
    import importlib.machinery

    if importlib.machinery.PathFinder.find_spec("PyQt5") is not None:
        pytest.skip("PyQt5 present; the gate does not apply")
    args = [env["dirs"]["port"]] if script.startswith("decoder") else args
    result = _run(script, *args, "--device", "cpu")
    assert result.returncode == 2, result.stderr[-400:]
    assert names in result.stderr


def test_decoder_histogram_latents_match_the_jax_function(env, tmp_path, monkeypatch):
    """--histogram encodes each split on the device: the latents equal the JAX
    function's (read from the values it hands matplotlib) at rtol 1e-5, and the
    figure is a PNG drawn without matplotlib."""
    import matplotlib.axes
    import matplotlib.pyplot as plt

    seen = []
    hist = matplotlib.axes.Axes.hist

    def recorded(self, x, *args, **kwargs):
        seen.append((kwargs.get("label"), np.array(x)))
        return hist(self, x, *args, **kwargs)

    monkeypatch.setattr(matplotlib.axes.Axes, "hist", recorded)
    from trustedai_cl_vae_ad_tpu.config import load_config

    jax_config = load_config(os.path.join(env["dirs"]["jax"], "config.yml"))
    decoder_generator_qt.latent_histograms_to_png(env["jmodel"], jax_config,
                                                  str(tmp_path / "jax.png"))
    plt.close("all")
    out = tmp_path / "latents.png"
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # the port's path must not need it
    series = decoder_generator_qt_torch.main([env["dirs"]["port"], "--histogram", "-o",
                                              str(out), "--device", "cpu"])
    assert [label for label, _ in seen] == list(series) == ["train", "val"]
    for (label, ref) in seen:
        assert series[label].shape == (CONFIG["data"][f"n_{label}"], 4)
        np.testing.assert_allclose(series[label].reshape(-1), ref, rtol=1e-5, atol=1e-6)
    with Image.open(out) as img:
        assert img.size == (640, 480) and img.mode == "RGB"
