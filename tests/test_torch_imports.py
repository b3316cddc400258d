"""The PyTorch port imports no jax, flax, optax or orbax, and nothing of the
JAX package (whose ``__init__`` imports jax when a ``TCVAE_*`` override is
set)."""

import ast
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "trustedai_cl_vae_ad_tpu_torch"
FORBIDDEN = ("jax", "flax", "optax", "orbax", "trustedai_cl_vae_ad_tpu", "camera_streamer",
             # the JAX package's scoring CLIs, which serve_torch.py and
             # do_anomaly_detection_torch.py carry over
             "serve", "do_anomaly_detection",
             # the archived JAX probes under benchmarks/, which the port copies and never imports
             "benchmarks", "r11_kernel", "r11_diag", "r11_fused_dense_adam", "r4_int8_gemm",
             "r18_conv_dw",
             # the JAX package's builder CLIs, which the *_torch.py builders carry over
             "build_raite_json_from_directory", "build_veri_dataset", "build_virat_dataset",
             "fix_raite_event_data", "coco_validator",
             # the JAX package's checkpoint tools, which the *_torch.py tools carry over
             "validate_logdir", "import_tf_checkpoint", "export_tf_checkpoint",
             # the JAX package's latent tools and examples, which the *_torch.py ones carry over
             "output_reconstructions", "interpolate", "sample_latent_space", "plot_j_diagram",
             "similarity_analysis", "plot_umap", "gamma_example", "kurtosis_example",
             "kurtosis_single_example", "kurtosis_pso", "quick_camera_streamer",
             # the JAX package's Qt shells, which the *_torch.py shells carry over
             "camera_streamer_qt", "decoder_generator_qt")
LATENT_TOOLS = ("output_reconstructions_torch.py", "interpolate_torch.py",
                "sample_latent_space_torch.py", "plot_j_diagram_torch.py",
                "similarity_analysis_torch.py", "plot_umap_torch.py")
EXAMPLES = tuple(os.path.join("examples", f) for f in (
    "gamma_example_torch.py", "kurtosis_example_torch.py", "kurtosis_single_example_torch.py",
    "kurtosis_pso_torch.py", "quick_camera_streamer_torch.py"))
QT_SHELLS = ("camera_streamer_qt_torch.py", "decoder_generator_qt_torch.py")
ENTRY_POINTS = ("camera_streamer_torch.py", "chip_smoke.py", "do_anomaly_detection_torch.py",
                "kernel_bounds_torch.py", "probe_r11_torch.py", "probe_r18_torch.py",
                "profile_stream_torch.py", "profile_train_torch.py", "serve_torch.py",
                "train_torch.py", "build_raite_json_from_directory_torch.py",
                "build_veri_dataset_torch.py", "build_virat_dataset_torch.py",
                "coco_validator_torch.py", "fix_raite_event_data_torch.py",
                os.path.join("tools", "quantize_checkpoint_torch.py"),
                os.path.join("tools", "convert_logdir_torch.py"),
                os.path.join("tools", "validate_logdir_torch.py"),
                os.path.join("tools", "import_tf_checkpoint_torch.py"), *LATENT_TOOLS, *EXAMPLES,
                *QT_SHELLS, os.path.join("tools", "export_tf_checkpoint_torch.py"))


def _port_sources():
    for root, _dirs, files in os.walk(os.path.join(REPO, PACKAGE)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    for f in ENTRY_POINTS:
        yield os.path.join(REPO, f)


def test_importing_every_port_module_loads_no_jax():
    """With the JAX package's jax-importing overrides set, as its tool CLIs
    are run, importing the port, the CLI and chip_smoke loads neither jax nor
    the JAX package."""
    code = f"""
import importlib, json, pkgutil, sys
import {PACKAGE}
for m in pkgutil.walk_packages({PACKAGE}.__path__, "{PACKAGE}."):
    importlib.import_module(m.name)
sys.path.insert(0, {REPO!r})
import camera_streamer_torch, chip_smoke, kernel_bounds_torch, profile_stream_torch
import probe_r11_torch, probe_r18_torch, profile_train_torch, train_torch
import serve_torch, do_anomaly_detection_torch
import build_raite_json_from_directory_torch, build_veri_dataset_torch, build_virat_dataset_torch
import coco_validator_torch, fix_raite_event_data_torch
sys.path.insert(0, {os.path.join(REPO, "tools")!r})
import quantize_checkpoint_torch, convert_logdir_torch
import validate_logdir_torch, import_tf_checkpoint_torch
import output_reconstructions_torch, interpolate_torch, sample_latent_space_torch
import plot_j_diagram_torch, similarity_analysis_torch, plot_umap_torch
sys.path.insert(0, {os.path.join(REPO, "examples")!r})
import gamma_example_torch, kurtosis_example_torch, kurtosis_single_example_torch
import kurtosis_pso_torch, quick_camera_streamer_torch
import camera_streamer_qt_torch, decoder_generator_qt_torch, export_tf_checkpoint_torch
print(json.dumps(sorted(k for k in sys.modules if k.split(".")[0] in {FORBIDDEN!r})))
"""
    env = dict(os.environ, PYTHONPATH=REPO, TCVAE_PLATFORM="cpu", TCVAE_CPU_DEVICES="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_the_slices_new_modules_are_in_the_walk():
    """The walk above covers the package by directory; the slices' modules
    (the recorder's viz/plots.py among them) are where it expects them."""
    sources = {os.path.relpath(p, REPO) for p in _port_sources()}
    for rel in ("ops/moments.py", "ops/adam.py", "models/batch_stats.py",
                "models/kurtosis_global.py", "data/loader.py", "data/saved_dataset.py",
                "utils/metrics.py", "train/__init__.py", "train/checkpoint.py",
                "train/loop.py", "train/bench_step.py", "models/kurtosis_single.py",
                "models/kl_gaussian.py", "data/pipeline.py", "stream/engine.py",
                "stream/run.py", "ops/quant.py", "ops/int8_gemm.py", "stream/multicam.py",
                "ops/dense_grad_adam.py", "probes/__init__.py", "probes/r11.py",
                "ops/conv_dw.py", "probes/r18.py", "viz/__init__.py", "viz/plots.py",
                "anomaly/offline.py", "train/orbax_read.py", "data/coco.py", "data/raite.py",
                "data/ingest.py", "ops/adam8.py", "data/builders/__init__.py",
                "data/builders/raite_json.py", "data/builders/fix_raite.py",
                "data/builders/veri.py", "data/builders/virat.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/collectives.py", "parallel/dp.py",
                "parallel/zero.py", "parallel/tp.py", "train/tf_import.py", "viz/latent.py",
                "utils/cli.py", "train/tf_export.py"):
        assert os.path.join(PACKAGE, rel) in sources, rel
    # the multi-camera engine on a mesh and adam_fp8 on one: their modules above, their
    # JAX-parity tests beside the rest
    for rel in ("test_torch_multicam_mesh.py", "test_torch_parallel.py", "test_torch_adam8.py"):
        assert os.path.isfile(os.path.join(REPO, "tests", rel)), rel
    assert {"train_torch.py", "profile_train_torch.py", "probe_r11_torch.py", "probe_r18_torch.py",
            "serve_torch.py", "do_anomaly_detection_torch.py",
            "build_raite_json_from_directory_torch.py", "build_veri_dataset_torch.py",
            "build_virat_dataset_torch.py", "coco_validator_torch.py",
            "fix_raite_event_data_torch.py",
            os.path.join("tools", "quantize_checkpoint_torch.py"),
            os.path.join("tools", "convert_logdir_torch.py"),
            os.path.join("tools", "validate_logdir_torch.py"),
            os.path.join("tools", "import_tf_checkpoint_torch.py"), *LATENT_TOOLS,
            *EXAMPLES, *QT_SHELLS, os.path.join("tools", "export_tf_checkpoint_torch.py")} <= sources
    assert len(LATENT_TOOLS) + len(EXAMPLES) == 11


def test_port_sources_have_no_jax_import():
    """The port, its entry points and the worker of its multi-process tests
    (tests/torch_dist_worker.py, which runs torch and the port alone)."""
    found = []
    for path in (*_port_sources(), os.path.join(REPO, "tests", "torch_dist_worker.py")):
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    found.append(f"{os.path.relpath(path, REPO)}:{node.lineno} {name}")
    assert not found, found


def test_kernel_sources_include_nothing_of_the_jax_package():
    """The CUDA sources the port builds (csrc/moments_cluster.cu among them) include only
    the toolkit's headers and their own."""
    csrc = os.path.join(REPO, PACKAGE, "csrc")
    sources = sorted(f for f in os.listdir(csrc) if f.endswith((".cu", ".cuh")))
    assert "moments_cluster.cu" in sources
    for name in sources:
        with open(os.path.join(csrc, name)) as f:
            includes = [line for line in f if line.lstrip().startswith("#include")]
        for line in includes:
            assert not any(word in line for word in FORBIDDEN), (name, line)


def test_reading_a_jax_logdir_loads_no_jax():
    """An orbax read (``train/orbax_read.py`` through tensorstore), the model
    and sidecar loads built on it, and a conversion leave no jax, flax, optax
    or orbax module in ``sys.modules``."""
    data = os.path.join(REPO, "tests", "data", "jax_logdirs")
    code = f"""
import json, os, sys, tempfile
sys.path.insert(0, {os.path.join(REPO, "tools")!r})
from trustedai_cl_vae_ad_tpu_torch.train import orbax_read
from trustedai_cl_vae_ad_tpu_torch.ops.quant import load_quantized_checkpoint
from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory
import convert_logdir_torch
logdir = os.path.join({data!r}, "global_f32")
tree = orbax_read.read_subtree(os.path.join(logdir, "optimizer"))
assert "inner_state" in tree
load_model_from_directory(logdir, device="cpu", restore_optimizer=True)
load_quantized_checkpoint(logdir, "cpu")
convert_logdir_torch.convert(logdir, os.path.join(tempfile.mkdtemp(), "converted"))
assert "tensorstore" in sys.modules
print(json.dumps(sorted(k for k in sys.modules
                        if k.split(".")[0] in {FORBIDDEN!r} + ("jaxlib",))))
"""
    env = dict(os.environ, PYTHONPATH=REPO, TCVAE_PLATFORM="cpu", TCVAE_CPU_DEVICES="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_the_doctor_and_the_tf_importer_load_no_jax_and_no_tensorflow(tmp_path):
    """tools/validate_logdir_torch.py on a JAX-written directory and on a
    port directory, and tools/import_tf_checkpoint_torch.py without --verify
    on a reference directory in the Keras 2 layout, leave no jax, flax,
    optax, orbax, keras or tensorflow module in ``sys.modules``."""
    data = os.path.join(REPO, "tests", "data", "jax_logdirs")
    ref = str(tmp_path / "ref")
    out = str(tmp_path / "out")
    code = f"""
import json, os, sys
sys.path.insert(0, {os.path.join(REPO, "tools")!r})
import import_tf_checkpoint_torch, validate_logdir_torch
from trustedai_cl_vae_ad_tpu_torch import testing
from trustedai_cl_vae_ad_tpu_torch.bridge import params_to_flax
from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config
config = {{"data": {{"image_size": [16, 16, 3]}},
          "loss": {{"kurtosis": 1.8, "w_kl_divergence": 0.0, "w_kurtosis": 1e-4, "w_mse": 1.0,
                   "w_skew": 0.0, "w_z_l1_reg": 0.0}},
          "model": {{"type": "KurtosisGlobal", "decoder_dense_filters": 4,
                    "latent_dimensions": 8, "layers": [4]}},
          "training": {{"batch_size": 8, "beta": 1e-6, "learning_rate": 1e-3, "max_epochs": 1}}}}
model = load_model_from_config(config, device="cpu")
testing.write_reference_logdir({ref!r}, config, params_to_flax(model.params))
assert import_tf_checkpoint_torch.main([{ref!r}, {out!r}, "--device", "cpu"]) == 0
assert validate_logdir_torch.main([{out!r}]) == 0
assert validate_logdir_torch.main([os.path.join({data!r}, "global_f32")]) == 0
print(json.dumps(sorted(k for k in sys.modules
                        if k.split(".")[0] in {FORBIDDEN!r} + ("jaxlib", "keras", "tensorflow"))))
"""
    env = dict(os.environ, PYTHONPATH=REPO, TCVAE_PLATFORM="cpu", TCVAE_CPU_DEVICES="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def _flags(parser_source: str) -> set:
    """The option strings of every ``add_argument`` call in a script."""
    flags = set()
    for node in ast.walk(ast.parse(parser_source)):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            flags |= {a.value for a in node.args
                      if isinstance(a, ast.Constant) and str(a.value).startswith("-")}
    return flags


def test_the_parallel_flags_match_the_jax_clis():
    """train_torch.py has every flag of train.py (the five parallel ones
    among them), and do_anomaly_detection_torch.py every flag of
    do_anomaly_detection.py; both parse them (read from the sources: the JAX
    scripts import jax)."""
    import do_anomaly_detection_torch
    import train_torch

    for port, jax_cli in ((train_torch, "train.py"),
                          (do_anomaly_detection_torch, "do_anomaly_detection.py")):
        with open(os.path.join(REPO, jax_cli)) as f:
            want = _flags(f.read())
        with open(port.__file__) as f:
            got = _flags(f.read())
        assert want <= got, (jax_cli, sorted(want - got))
    assert {"--no-parallel", "--distributed", "--coordinator", "--num-processes",
            "--process-id"} <= _flags(open(os.path.join(REPO, "train.py")).read())
    args = train_torch.get_args(["cfg.yml", "--device", "cpu", "--coordinator", "127.0.0.1:29500",
                                 "--num-processes", "2", "--process-id", "1", "--no-parallel"])
    assert (args.coordinator, args.num_processes, args.process_id, args.no_parallel) == (
        "127.0.0.1:29500", 2, 1, True)
    assert train_torch.get_args(["cfg.yml", "--device", "cpu", "--distributed"]).distributed
    import pytest

    with pytest.raises(SystemExit):  # a coordinator needs the process count and id
        train_torch.get_args(["cfg.yml", "--device", "cpu", "--coordinator", "h:1"])
