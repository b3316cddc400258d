#!/usr/bin/env python3
"""Qt GUI for live-stream anomaly detection and continual learning (PyTorch port).

The counterpart of ``camera_streamer_qt.py`` on ``trustedai_cl_vae_ad_tpu_torch``:

  python camera_streamer_qt_torch.py <cam_config.yml> [-m <model_dir>] [--quantize]
         [--warmup [HxW]] [--max-rss-mb MB] [--device cuda]

A thin view over ``trustedai_cl_vae_ad_tpu_torch.stream.engine.StreamingEngine``:
inference, scoring, continual learning, recording and autosave live in the engine
(which the headless ``camera_streamer_torch.py`` drives too). The window has the
same widgets and handlers as the JAX package's: stream and error panes, the view
modes (error / reconstruction / JET heatmap / overlay), the continual-learning
checkbox, learning-rate and image-noise mantissa/exponent dials, replay-buffer
load, record start/stop with its period dial, model load/save, New Model from a
config file, the camera menu, the inference toggle, the anomalous-state override
with its Enable box, the dataset-combine action, the timing readout, the
anomalous-state indicator, the periodic autosave and the CL metrics.

Every frame the window scores runs on ``--device`` (the card by default): one
scorer launch a frame (kernel 1), and under ``--quantize`` two int8 products a
frame (kernel 10). Nothing falls back to the CPU.

Requires PyQt5; without it the script exits 2 and names the headless CLI.
"""

import argparse
import sys

try:
    from PyQt5.QtCore import Qt, QTimer
    from PyQt5.QtGui import QImage, QPixmap
    from PyQt5.QtWidgets import (
        QAction,
        QActionGroup,
        QApplication,
        QCheckBox,
        QDoubleSpinBox,
        QFileDialog,
        QHBoxLayout,
        QLabel,
        QMainWindow,
        QMessageBox,
        QPushButton,
        QSpinBox,
        QVBoxLayout,
        QWidget,
        QComboBox,
    )

    HAVE_QT = True
except ImportError:  # pragma: no cover - environment-dependent
    HAVE_QT = False


def get_args(argv=None):
    from trustedai_cl_vae_ad_tpu_torch.stream.run import parse_warmup_spec
    from trustedai_cl_vae_ad_tpu_torch.utils.cli import add_device_argument, checked_device

    parser = argparse.ArgumentParser()
    parser.add_argument("cam_config", type=str, help="cam_config.yml")
    parser.add_argument("--cam-config-index", type=int, default=0)
    parser.add_argument("--model-cache-dir", type=str, default="model_cache")
    parser.add_argument("--model-dir", "-m", type=str, default=None)
    parser.add_argument("--quantize", action="store_true",
                        help="int8 inference dispatch (ops/quant.py); CL re-quantizes the "
                             "serving copy after each step")
    parser.add_argument("--autosave-period-s", type=float, default=5 * 60.0,
                        help="Seconds between scheduled model-cache saves")
    parser.add_argument("--async-autosave", action="store_true",
                        help="Background the periodic model-cache writes (see "
                             "camera_streamer_torch.py --async-autosave). Switching models or "
                             "quitting drains any write in flight first, so the window may stall "
                             "for a few seconds at those two moments")
    parser.add_argument("--max-rss-mb", type=float, default=None,
                        help="Graceful restart guard for multi-day runs: on breach, save CL "
                             "state to the cache and exit with code 3 for a supervisor restart "
                             "(see camera_streamer_torch.py --max-rss-mb)")
    parser.add_argument("--warmup", nargs="?", const="native", default=None, metavar="HxW",
                        help="Build the kernels and run the frame dispatch once before the "
                             "window shows, so the first camera frame pays neither the nvcc "
                             "build nor cuDNN's algorithm choice. Pass the camera resolution "
                             "(e.g. 1080x1920) or omit the value for the model's native size")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    args.warmup = parse_warmup_spec(args.warmup, parser.error)
    args.device = checked_device(parser, args.device)
    return args


if HAVE_QT:

    import numpy as np

    from trustedai_cl_vae_ad_tpu_torch.stream.capture import make_source
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import (
        StreamingEngine,
        load_cam_config,
        load_engine_from_directory,
    )
    from trustedai_cl_vae_ad_tpu_torch.viz.plots import jet_heatmap as _jet_heatmap

    def _np_to_pixmap(arr: np.ndarray) -> QPixmap:
        if arr.ndim == 3 and arr.shape[-1] == 1:
            arr = arr[..., 0]  # 1-channel models: render as grayscale
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        h, w, _ = arr.shape
        img = QImage(np.ascontiguousarray(arr).data, w, h, 3 * w, QImage.Format_RGB888)
        return QPixmap.fromImage(img).copy()

    class CameraStreamerMainWindow(QMainWindow):
        def __init__(self, args):
            super().__init__()
            self.cam_config = load_cam_config(args.cam_config, args.cam_config_index)
            self.cam_config_idx = int(args.cam_config_index)
            self.cam_info = self.cam_config["camera_list"][self.cam_config_idx]
            self.anomaly_settings = self.cam_config.get("anomaly_settings")
            self.model_cache_dir = args.model_cache_dir
            self.autosave_period_s = float(getattr(args, "autosave_period_s", 5 * 60.0))
            self.async_autosave = bool(getattr(args, "async_autosave", False))
            self.quantize = bool(getattr(args, "quantize", False))
            self.warmup = getattr(args, "warmup", None)
            self.max_rss_mb = getattr(args, "max_rss_mb", None)
            self.device = getattr(args, "device", "cuda")
            self._rss_tick = 0
            self.engine = None
            self.source = None
            self.last_frame = None
            self.last_result = None

            if args.model_dir:
                self.load_engine(args.model_dir)

            self._build_ui()
            self._open_source()

            self.stream_timer = QTimer()
            self.stream_timer.timeout.connect(self.grab_frame)
            self.stream_timer.start(int(1000.0 / float(self.cam_info.get("fps", 20))))
            self.update_timer = QTimer()
            self.update_timer.timeout.connect(self.update_draws)
            self.update_timer.start(50)

        # ---------------------------------------------------------------- UI
        def _build_ui(self):
            self.stream_label = QLabel("stream")
            self.error_label = QLabel("inference")
            for lbl in (self.stream_label, self.error_label):
                lbl.setMinimumSize(320, 240)
                lbl.setAlignment(Qt.AlignCenter)

            self.view_mode = QComboBox()
            self.view_mode.addItems(["error", "reconstruction", "heatmap", "overlay"])
            self.cl_checkbox = QCheckBox("Continuous Learning")
            self.cl_checkbox.toggled.connect(self._toggle_cl)
            self.record_btn = QPushButton("Record")
            self.record_btn.setCheckable(True)
            self.record_btn.toggled.connect(self._toggle_record)
            self.load_model_btn = QPushButton("Load Model")
            self.load_model_btn.clicked.connect(self._load_model_dialog)
            self.save_model_btn = QPushButton("Save Model")
            self.save_model_btn.clicked.connect(self._save_model_dialog)
            self.replay_btn = QPushButton("Load Replay Buffer")
            self.replay_btn.clicked.connect(self._load_replay_dialog)
            self.combine_btn = QPushButton("Combine Datasets")
            self.combine_btn.clicked.connect(self._combine_datasets_dialog)
            self.new_model_btn = QPushButton("New Model")
            self.new_model_btn.clicked.connect(self._new_model_dialog)

            # toggle-inference: unchecking stops the per-tick engine dispatch; the raw
            # stream keeps drawing
            self.toggle_inference_btn = QPushButton("Toggle Inference")
            self.toggle_inference_btn.setCheckable(True)
            self.toggle_inference_btn.setChecked(True)

            # manual anomalous-state override and its Enable gate: the override and the
            # automatic state machine both act only while Enable is checked
            self.anomaly_state_btn = QPushButton("Anomalous State")
            self.anomaly_state_btn.setCheckable(True)
            self.anomaly_state_btn.setChecked(False)
            self.anomaly_state_btn.clicked.connect(self._anomaly_state_btn_pressed)
            self.enable_anomaly_cbx = QCheckBox("Enable")
            self.enable_anomaly_cbx.setChecked(False)
            self.enable_anomaly_cbx.toggled.connect(self._enable_anomaly_toggled)

            # runtime camera-switch menu
            self.cam_menu = self.menuBar().addMenu("Camera")
            self.build_select_cam_menu()

            self.anomaly_lbl = QLabel("AS: n/a")
            self.anomaly_lbl.setAutoFillBackground(True)
            self.timing_lbl = QLabel("timings: n/a")

            # recording cadence dial (500 ms by default)
            self.record_period = QDoubleSpinBox()
            self.record_period.setRange(0.05, 60.0)
            self.record_period.setValue(0.5)
            self.record_period.setSuffix(" s")
            self.record_period.valueChanged.connect(self._record_period_changed)

            # lr and img-noise mantissa/exponent dials
            self.lr_man = QDoubleSpinBox()
            self.lr_man.setRange(1.0, 9.99)
            self.lr_man.setValue(1.0)
            self.lr_exp = QSpinBox()
            self.lr_exp.setRange(-9, 0)
            self.lr_exp.setValue(-4)
            self.noise_man = QDoubleSpinBox()
            self.noise_man.setRange(0.0, 9.99)
            self.noise_man.setValue(1.0)
            self.noise_exp = QSpinBox()
            self.noise_exp.setRange(-9, 0)
            self.noise_exp.setValue(-6)
            for w in (self.lr_man, self.lr_exp, self.noise_man, self.noise_exp):
                w.valueChanged.connect(self._dials_changed)

            panes = QHBoxLayout()
            panes.addWidget(self.stream_label)
            panes.addWidget(self.error_label)
            controls = QHBoxLayout()
            for w in (self.view_mode, self.cl_checkbox, self.toggle_inference_btn,
                      self.record_btn,
                      QLabel("rec period:"), self.record_period, self.load_model_btn,
                      self.save_model_btn, self.new_model_btn, self.replay_btn,
                      self.combine_btn,
                      QLabel("lr:"), self.lr_man,
                      self.lr_exp, QLabel("noise:"), self.noise_man, self.noise_exp,
                      self.anomaly_state_btn, self.enable_anomaly_cbx,
                      self.anomaly_lbl):
                controls.addWidget(w)
            layout = QVBoxLayout()
            layout.addLayout(panes)
            layout.addLayout(controls)
            layout.addWidget(self.timing_lbl)
            main = QWidget()
            main.setLayout(layout)
            self.setCentralWidget(main)
            self.resize(1280, 480)
            self._apply_ui_state_to_engine()

        # ------------------------------------------------------------ engine
        def load_engine(self, model_dir):
            import os

            from trustedai_cl_vae_ad_tpu_torch.utils.metrics import MetricsWriter

            # CL epochs are persisted (loss dict and anomaly scores). Loading a new
            # model replaces the writer: close the old one instead of leaking it.
            self._close_engine()
            metrics = MetricsWriter(os.path.join(self.model_cache_dir, "metrics"))
            self.engine = load_engine_from_directory(
                model_dir,
                device=self.device,
                anomaly_settings=self.anomaly_settings,
                model_cache_dir=self.model_cache_dir,
                autosave_period_s=self.autosave_period_s,
                async_autosave=self.async_autosave,
                metrics=metrics,
                quantize=self.quantize,
            )
            self._warmup_engine()
            self._apply_ui_state_to_engine()

        def _warmup_engine(self):
            """--warmup: build the kernels and run the dispatch once before the window
            shows, so the first camera frame scores at steady-state latency."""
            if not self.warmup or self.engine is None:
                return
            shape = None if self.warmup == "native" else (*self.warmup, self.engine.channels)
            print("warming up (building the kernels, running the dispatch once)")
            self.engine.warmup(frame_shape=shape)

        def _close_engine(self):
            old = getattr(self, "engine", None)
            if old is None:
                return
            # an in-flight recording must be finalized (labels.json with the anomaly
            # scores and a model snapshot) before the old engine is dropped, or the
            # recorded dataset is unusable
            if getattr(old, "recording_flag", False):
                try:
                    old.terminate_recording()
                except Exception:
                    pass
                if hasattr(self, "record_btn"):
                    self.record_btn.setChecked(False)
            # an in-flight background autosave (--async-autosave) must land before the
            # engine object is dropped
            try:
                old.drain_autosaves()
            except Exception as e:
                print(f"autosave drain failed: {e}")
            if getattr(old, "metrics", None) is not None:
                try:
                    old.metrics.close()
                except Exception:
                    pass

        def _apply_ui_state_to_engine(self):
            """The UI toggles are the source of truth when an engine is (re)attached;
            before _build_ui runs, the engine keeps its defaults."""
            if not self.engine:
                return
            self.engine.cam_info = self.cam_info
            if hasattr(self, "cl_checkbox"):
                self.engine.enable_cont_learning = self.cl_checkbox.isChecked()
            if hasattr(self, "enable_anomaly_cbx"):
                self.engine.enable_anomaly_state = self.enable_anomaly_cbx.isChecked()

        def _open_source(self):
            self.source = make_source(
                self.cam_info.get("url"), fps=float(self.cam_info.get("fps", 20))
            )

        # ----------------------------------------------- camera switch menu
        def build_select_cam_menu(self):
            """One checkable exclusive action per camera_list entry."""
            self.cam_menu.clear()
            self.cam_action_group = QActionGroup(self)
            for idx, cam_obj in enumerate(self.cam_config["camera_list"]):
                action = self.cam_menu.addAction(str(cam_obj.get("name", f"cam{idx}")))
                action.setCheckable(True)
                if idx == self.cam_config_idx:
                    action.setChecked(True)
                self.cam_action_group.addAction(action)
                action.triggered.connect(
                    lambda checked=False, index=idx: self.select_camera_from_idx(index)
                )

        def select_camera_from_idx(self, idx: int):
            """Switch the live source to camera_list[idx]: reopen the capture and retime
            the grab loop at the new camera's fps; the scorer's EMA state carries over
            (only the source changes)."""
            if not (0 <= idx < len(self.cam_config["camera_list"])):
                return
            self.cam_config_idx = idx
            self.cam_info = self.cam_config["camera_list"][idx]
            if self.source is not None:
                self.source.release()
            self._open_source()
            self.stream_timer.stop()
            self.stream_timer.start(int(1000.0 / float(self.cam_info.get("fps", 20))))
            if self.engine:
                self.engine.cam_info = self.cam_info

        def select_camera_from_name(self, name: str) -> bool:
            for idx, cam_obj in enumerate(self.cam_config["camera_list"]):
                if cam_obj.get("name") == name:
                    self.select_camera_from_idx(idx)
                    return True
            return False

        def _toggle_cl(self, checked):
            if self.engine:
                self.engine.enable_cont_learning = checked
                if checked:
                    # apply the dialed lr that _dials_changed deferred while CL was off
                    # (this is where the optimizer's moments are allocated)
                    self.engine.set_learning_rate(
                        float(f"{self.lr_man.value()}E{self.lr_exp.value()}"))

        def _enable_anomaly_toggled(self, checked):
            """Gate for both the manual override and the automatic state machine:
            toggle_anomalous_state does nothing and clears the state while Enable is
            unchecked."""
            if self.engine:
                self.engine.enable_anomaly_state = bool(checked)
                if not checked:
                    self.engine.toggle_anomalous_state(False)
            if not checked:
                self.anomaly_state_btn.setChecked(False)

        def _anomaly_state_btn_pressed(self):
            """Manual anomalous-state override."""
            if self.engine:
                self.engine.toggle_anomalous_state(self.anomaly_state_btn.isChecked())
                # the engine may refuse (Enable unchecked): reflect what it holds
                self.anomaly_state_btn.setChecked(self.engine.anomalous_state)

        def _new_model_dialog(self):
            """Build a fresh (seeded random) model from a config file in-app."""
            f, _ = QFileDialog.getOpenFileName(
                self, "Load Configuration File", "", "YAML (*.yml *.yaml)"
            )
            if f:
                try:
                    self.new_model_from_config(f)
                except Exception as e:
                    QMessageBox.critical(None, "New model failed", str(e))

        def new_model_from_config(self, config_path):
            import math
            import os

            from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config_path
            from trustedai_cl_vae_ad_tpu_torch.utils.metrics import MetricsWriter

            model, config = load_model_from_config_path(config_path, device=self.device)
            # build the replacement FIRST: if construction raises (a bad config, out of
            # memory), the app keeps running on the old engine, whose writer and
            # recording must not have been closed
            metrics = MetricsWriter(os.path.join(self.model_cache_dir, "metrics"))
            try:
                new_engine = StreamingEngine(
                    model,
                    config,
                    anomaly_settings=self.anomaly_settings,
                    cam_info=self.cam_info,
                    model_cache_dir=self.model_cache_dir,
                    autosave_period_s=self.autosave_period_s,
                    async_autosave=self.async_autosave,
                    metrics=metrics,
                    quantize=self.quantize,
                )
            except Exception:
                metrics.close()
                raise
            self._close_engine()
            self.engine = new_engine
            self._warmup_engine()
            self._apply_ui_state_to_engine()
            # seed the lr dials from the new config
            lr = float(config["training"]["learning_rate"])
            exp = int(math.floor(math.log10(lr)))
            self.lr_exp.setValue(exp)
            self.lr_man.setValue(lr / (10.0**exp))

        def _dials_changed(self, *_):
            if not self.engine:
                return
            # the lr dial reaches the engine only while CL is on: set_learning_rate
            # allocates the optimizer's moments (twice the parameters' bytes), which an
            # inference-only session never uses; the dialed value is applied when the
            # CL checkbox turns on (_toggle_cl)
            if self.cl_checkbox.isChecked():
                self.engine.set_learning_rate(
                    float(f"{self.lr_man.value()}E{self.lr_exp.value()}"))
            self.engine.set_img_noise(float(f"{self.noise_man.value()}E{self.noise_exp.value()}"))

        def _toggle_record(self, checked):
            if not self.engine:
                # don't leave the button pressed with nothing recording
                if checked:
                    self.record_btn.setChecked(False)
                return
            if checked:
                d = QFileDialog.getExistingDirectory(self, "Recording Directory")
                if d:
                    self.engine.begin_recording(d)
                else:
                    self.record_btn.setChecked(False)
            else:
                self.engine.terminate_recording()

        def _load_model_dialog(self):
            d = QFileDialog.getExistingDirectory(self, "Select Model Directory")
            if d:
                try:
                    self.load_engine(d)
                except Exception as e:
                    QMessageBox.critical(None, "Load failed", str(e))

        def _save_model_dialog(self):
            if not self.engine:
                return
            d = QFileDialog.getExistingDirectory(self, "Select Save Directory")
            if d:
                self.engine.save_model_to_dir_by_date(d)

        def _record_period_changed(self, value):
            if self.engine:
                self.engine.record_period_ms = float(value) * 1000.0

        def _combine_datasets_dialog(self):
            """Merge recorded dataset directories: pick the sources one at a time (an
            empty choice ends the list), then the destination."""
            from trustedai_cl_vae_ad_tpu_torch.stream.engine import combine_datasets

            srcs = []
            while True:
                d = QFileDialog.getExistingDirectory(
                    self, f"Source dataset #{len(srcs) + 1} (cancel to finish)"
                )
                if not d:
                    break
                srcs.append(d)
            if not srcs:
                return
            dest = QFileDialog.getExistingDirectory(self, "Destination directory")
            if not dest:
                return
            try:
                out = combine_datasets(srcs, dest)
                QMessageBox.information(None, "Combined", f"Merged labels: {out}")
            except Exception as e:
                QMessageBox.critical(None, "Combine failed", str(e))

        def _load_replay_dialog(self):
            if not self.engine:
                QMessageBox.critical(None, "Failed", "Model not loaded yet")
                return
            f, _ = QFileDialog.getOpenFileName(
                self, "Image path list", "", "CSV File (*.csv);;Text File (*.txt)"
            )
            if f:
                self.engine.load_replay_buffer_from_file(f)

        # ------------------------------------------------------------- loop
        def grab_frame(self):
            if self.source is None:
                return
            frame = self.source.read()
            if frame is not None:
                self.last_frame = frame

        def _rss_guard(self) -> bool:
            """--max-rss-mb: poll every RSS_POLL_TICKS ticks; on breach save dirty CL
            state, drain, and quit the event loop with RSS_EXIT_CODE so a supervisor
            restarts the app before the OOM killer fires."""
            from trustedai_cl_vae_ad_tpu_torch.stream.run import RSS_EXIT_CODE, RSS_POLL_TICKS

            if not self.max_rss_mb:
                return False
            self._rss_tick += 1
            if self._rss_tick % RSS_POLL_TICKS != 0:
                return False
            from trustedai_cl_vae_ad_tpu_torch.utils.profiling import rss_mb

            rss = rss_mb()
            if rss <= self.max_rss_mb:
                return False
            print(f"host RSS {rss:.0f} MB exceeded --max-rss-mb "
                  f"{self.max_rss_mb:.0f}: saving state and exiting "
                  f"{RSS_EXIT_CODE} for supervisor restart")
            self.stream_timer.stop()
            self.update_timer.stop()
            eng = self.engine
            if eng is not None:
                try:
                    # drain an in-flight --async-autosave round FIRST: the synchronous
                    # save's staging sweep assumes nothing is in flight
                    eng.drain_autosaves()
                    if eng.model_cache_dir and getattr(eng, "model_changed_flag", False):
                        eng.save_model_to_dir(eng.model_cache_dir)
                    if eng.recording_flag:
                        eng.terminate_recording()
                except Exception as e:  # noqa: BLE001: still exit gracefully
                    print(f"rss-guard save failed: {e}")
            app = QApplication.instance()
            if app is not None:
                app.exit(RSS_EXIT_CODE)
            return True

        def update_draws(self):
            if self._rss_guard():
                return
            if self.last_frame is None:
                return
            self.stream_label.setPixmap(
                _np_to_pixmap(self.last_frame).scaled(
                    self.stream_label.size(), Qt.KeepAspectRatio
                )
            )
            if self.engine is None:
                return
            # toggle-inference off: the stream keeps drawing, no engine dispatch
            if not self.toggle_inference_btn.isChecked():
                return
            result = self.engine.process_frame(self.last_frame)
            if result is None:
                return
            self.last_result = result
            mode = self.view_mode.currentText()
            # the maps reach the host here, one copy each (FrameResult's lazy fetch)
            if mode == "reconstruction":
                view = result.reconstruction_u8
            elif mode == "heatmap":
                view = _jet_heatmap(result.norm_err_u8)
            elif mode == "overlay":
                heat = _jet_heatmap(result.norm_err_u8)
                view = (0.5 * heat + 0.5 * result.reconstruction_u8).astype("uint8")
            else:
                view = result.norm_err_u8
            self.error_label.setPixmap(
                _np_to_pixmap(view).scaled(self.error_label.size(), Qt.KeepAspectRatio)
            )
            marker = " **" if result.anomalous else ""
            self.anomaly_lbl.setText(
                f"AS: {result.score: 1.4f}, MA: {result.score_ma: 1.4f}{marker}"
            )
            # visual anomalous-state indicator
            self.anomaly_lbl.setStyleSheet(
                "background-color: #cc2222; color: white; font-weight: bold;"
                if result.anomalous
                else ""
            )
            # the override button mirrors the live state
            self.anomaly_state_btn.setChecked(bool(result.anomalous))
            t = self.engine.timings
            if t:
                self.timing_lbl.setText(
                    f"timings: infer {t['infer_s'] * 1e3:.1f} ms | "
                    f"cl {t['cl_s'] * 1e3:.1f} ms | "
                    f"record {t['record_s'] * 1e3:.1f} ms | "
                    f"total {t['total_s'] * 1e3:.1f} ms | "
                    f"process_rate {self.engine.process_rate * 1e3:.1f} ms"
                )


def main(argv=None):
    args = get_args(argv)
    if not HAVE_QT:
        print(
            "PyQt5 is not available in this environment.\n"
            "Use the headless engine instead:\n"
            f"  python camera_streamer_torch.py {args.cam_config} -m <model_dir>",
            file=sys.stderr,
        )
        raise SystemExit(2)
    app = QApplication(sys.argv)
    window = CameraStreamerMainWindow(args)
    window.show()
    code = app.exec_()
    # drain an in-flight background autosave (--async-autosave) before the
    # interpreter's teardown: a cut-off write is a lost save
    if window.engine is not None:
        try:
            window.engine.drain_autosaves()
        except Exception as e:
            print(f"autosave drain failed: {e}")
    raise SystemExit(code)


if __name__ == "__main__":
    main()
