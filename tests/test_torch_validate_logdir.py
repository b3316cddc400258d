"""tools/validate_logdir_torch.py, the port's log-directory doctor, against
the JAX package's (tools/validate_logdir.py).

Every case of tests/test_validate_logdir.py and
tests/test_ckpt_atomicity.py::test_doctor_reports_round_state runs twice:
on a directory that the JAX package wrote and faulted (``jax``) and on one
that the port wrote and faulted alike, with the same config (``port``). The
JAX doctor on the JAX-written directory is the oracle: the port's doctor must
give the same number of errors and of warnings, the same info values and the
same exit codes, and each case's message content. Messages name leaves by
state-dict key where the JAX doctor uses flax's keystr. The committed JAX
fixtures and their converted copies, the error for a JAX layout where
tensorstore does not import, and the doctor's reads (no weight payload, no
CUDA context) are checked too.
"""

import json
import os
import shutil
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "jax_logdirs")

sys.path.insert(0, os.path.join(REPO, "tools"))
import validate_logdir as jax_tool  # noqa: E402
import validate_logdir_torch as port_tool  # noqa: E402

sys.path.pop(0)


def _tiny_config():
    from trustedai_cl_vae_ad_tpu_torch.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", "synthetic_small.yml"))
    cfg["data"]["image_size"] = [32, 32, 3]
    cfg["model"]["latent_dimensions"] = 8
    cfg["model"]["layers"] = [4, 8]
    return cfg


def _round_state_config():
    return {
        "data": {"image_size": [16, 16, 3]},
        "loss": {"kurtosis": 1.8, "w_kl_divergence": 0.0, "w_kurtosis": 1e-4,
                 "w_mse": 1.0, "w_skew": 0.0, "w_z_l1_reg": 0.0},
        "model": {"type": "KurtosisSingle", "decoder_dense_filters": 4,
                  "latent_dimensions": 8, "layers": [4]},
        "training": {"batch_size": 8, "beta": 1e-6, "learning_rate": 1e-3,
                     "max_epochs": 1},
    }


def _batch(seed):
    return np.random.RandomState(seed).rand(4, 32, 32, 3).astype(np.float32)


class JaxOps:
    """What a case does to a directory, through the JAX package."""

    @staticmethod
    def save_config(cfg, path):
        import trustedai_cl_vae_ad_tpu as tc

        tc.save_config(cfg, path)

    @staticmethod
    def new_model(cfg):
        import trustedai_cl_vae_ad_tpu as tc

        return tc.load_model_from_config(cfg)

    @staticmethod
    def load(d):
        import trustedai_cl_vae_ad_tpu as tc

        return tc.load_model_from_directory(d)[0]

    @staticmethod
    def train_step(model, seed):
        import jax.numpy as jnp

        model.compile()
        model.train_step(jnp.asarray(_batch(seed)))

    @staticmethod
    def save_train_state(d):
        from trustedai_cl_vae_ad_tpu.train.loop import save_train_state

        save_train_state(d, epochs_completed=1, step=2, beta=1e-6)

    @staticmethod
    def quantize(d, model):
        from trustedai_cl_vae_ad_tpu.ops.quant import quantize_params, save_quantized_checkpoint

        save_quantized_checkpoint(d, quantize_params(model.core, model.params, min_elems=1))

    @staticmethod
    def quant_names():
        from trustedai_cl_vae_ad_tpu.ops.quant import PROVENANCE_FILE, QUANTIZED_SUBDIR

        return QUANTIZED_SUBDIR, PROVENANCE_FILE


class PortOps:
    """The same, through the port (on the CPU)."""

    @staticmethod
    def save_config(cfg, path):
        from trustedai_cl_vae_ad_tpu_torch.config import save_config

        save_config(cfg, path)

    @staticmethod
    def new_model(cfg):
        from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config

        return load_model_from_config(cfg, device="cpu")

    @staticmethod
    def load(d):
        from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory

        return load_model_from_directory(d, device="cpu")[0]

    @staticmethod
    def train_step(model, seed):
        model.compile()
        model.train_step(torch.from_numpy(_batch(seed)))

    @staticmethod
    def save_train_state(d):
        from trustedai_cl_vae_ad_tpu_torch.train.loop import save_train_state

        save_train_state(d, epochs_completed=1, step=2, beta=1e-6)

    @staticmethod
    def quantize(d, model):
        from trustedai_cl_vae_ad_tpu_torch.ops.quant import (
            quantize_params,
            save_quantized_checkpoint,
        )

        save_quantized_checkpoint(d, quantize_params(model.core, model.params, min_elems=1))

    @staticmethod
    def quant_names():
        from trustedai_cl_vae_ad_tpu_torch.ops.quant import PROVENANCE_FILE, QUANTIZED_SUBDIR

        return QUANTIZED_SUBDIR, PROVENANCE_FILE


OPS = {"jax": JaxOps, "port": PortOps}


def _base_logdir(ops, d):
    """The doctor tests' directory: the tiny model after one training step,
    saved with its Adam state, and train_state.json."""
    os.makedirs(d)
    cfg = _tiny_config()
    model = ops.new_model(cfg)
    ops.train_step(model, 0)
    ops.save_config(cfg, os.path.join(d, "config.yml"))
    model.save_model(d)
    ops.save_train_state(d)
    return d


@pytest.fixture(scope="module")
def base_logdirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("doctor_bases")
    return {layout: _base_logdir(ops, str(root / layout)) for layout, ops in OPS.items()}


def _summary(report, rc, rc_strict):
    return {"errors": len(report["errors"]), "warnings": len(report["warnings"]),
            "info": json.loads(json.dumps(report["info"], default=str)),
            "rc": rc, "rc_strict": rc_strict}


def _exit_codes(tool, d, capsys):
    rc = tool.main([d, "--json"])
    rc_strict = tool.main([d, "--strict"])
    return rc, rc_strict, capsys.readouterr().out


# -- the cases: each takes the layout's ops, its base directory, a scratch path and
# check(d, expect), which runs the doctors on d; expect(report) must hold for each

def case_healthy(ops, base, tmp, check):
    d = str(tmp / "healthy")
    shutil.copytree(base, d, symlinks=True)
    check(d, lambda r: r["errors"] == [] and r["warnings"] == []
          and r["info"]["optimizer_state"] is True
          and r["info"]["train_state"]["epochs_completed"] == 1
          and r["info"]["latent_dimensions"] == 8)


def case_config_weight_drift(ops, base, tmp, check):
    d = str(tmp / "drift")
    shutil.copytree(base, d, symlinks=True)
    cfg = _tiny_config()
    cfg["model"]["latent_dimensions"] = 16  # the weights were saved at 8
    ops.save_config(cfg, os.path.join(d, "config.yml"))
    check(d, lambda r: any("drift" in e for e in r["errors"]))


def case_missing_pieces(ops, base, tmp, check):
    d = str(tmp / "empty")
    os.makedirs(d)
    check(d, lambda r: any("config.yml missing" in e for e in r["errors"]))
    ops.save_config(_tiny_config(), os.path.join(d, "config.yml"))
    check(d, lambda r: any("encoder/ checkpoint missing" in e for e in r["errors"])
          and any("decoder/ checkpoint missing" in e for e in r["errors"]))


def case_stale_quantized_mtime_fallback(ops, base, tmp, check):
    """A hand-made quantized/ without provenance: the mtime fallback's soft wording."""
    d = str(tmp / "stale_q")
    shutil.copytree(base, d, symlinks=True)
    qdir = os.path.join(d, ops.quant_names()[0])
    os.makedirs(qdir)
    with open(os.path.join(qdir, "marker"), "w") as f:
        f.write("x")
    old = time.time() - 3600
    os.utime(os.path.join(qdir, "marker"), (old, old))
    check(d, lambda r: any("MAY be stale" in w for w in r["warnings"]))


def case_quantized_provenance_is_content_based(ops, base, tmp, check):
    """A fresh sidecar stays fresh when mtimes lie; after a retrain the
    provenance mismatch warns with the quantized tree's mtimes in the future."""
    d = str(tmp / "prov_q")
    shutil.copytree(base, d, symlinks=True)
    model = ops.load(d)
    ops.quantize(d, model)
    now = time.time()
    for r, _dirs, fs in os.walk(os.path.join(d, "encoder")):
        for f in fs:
            os.utime(os.path.join(r, f), (now + 3600, now + 3600))
    check(d, lambda r: not any("stale" in w.lower() or "DIFFERENT float" in w
                               for w in r["warnings"]))
    ops.train_step(model, 1)
    model.save_model(d)
    for r, _dirs, fs in os.walk(os.path.join(d, ops.quant_names()[0])):
        for f in fs:
            os.utime(os.path.join(r, f), (now + 7200, now + 7200))
    check(d, lambda r: any("DIFFERENT float checkpoint" in w for w in r["warnings"])
          and any("quantize_checkpoint" in w for w in r["warnings"]))


def case_precision_drift(ops, base, tmp, check):
    """Weights saved in float32 under a bfloat16 config: shapes match, one
    dtype warning a part, no error."""
    d = str(tmp / "dtype_drift")
    shutil.copytree(base, d, symlinks=True)
    cfg = _tiny_config()
    cfg["training"]["precision"] = "bfloat16"
    ops.save_config(cfg, os.path.join(d, "config.yml"))
    check(d, lambda r: r["errors"] == [] and any(
        "dtype" in w and "training.precision" in w for w in r["warnings"]))


def case_replay_provenance_missing_files(ops, base, tmp, check):
    d = str(tmp / "replay")
    shutil.copytree(base, d, symlinks=True)
    with open(os.path.join(d, "replay_buffer_paths.csv"), "w") as f:
        f.write("/nonexistent/frame_0001.png\n")
    check(d, lambda r: any("replay provenance" in w for w in r["warnings"])
          and r["info"]["replay_paths"] == 1)


def case_missing_train_state(ops, base, tmp, check):
    """The CLI case: --strict turns the missing sidecar's warning into exit code 2."""
    d = str(tmp / "warned")
    shutil.copytree(base, d, symlinks=True)
    os.remove(os.path.join(d, "train_state.json"))
    check(d, lambda r: any("train_state.json missing" in w for w in r["warnings"]))


def case_all_none_provenance_falls_back_to_mtimes(ops, base, tmp, check):
    """A provenance stamp of None values carries no evidence: the mtime check decides."""
    d = str(tmp / "blank_prov_q")
    shutil.copytree(base, d, symlinks=True)
    qsub, prov_file = ops.quant_names()
    qdir = os.path.join(d, qsub)
    os.makedirs(qdir)
    with open(os.path.join(qdir, prov_file), "w") as f:
        json.dump({"float_checkpoint": {"encoder": None, "decoder": None}}, f)
    for side in ("encoder", "decoder"):  # the JAX stamp's source; the port's has none
        meta = os.path.join(d, side, "_CHECKPOINT_METADATA")
        if os.path.exists(meta):
            os.remove(meta)
    old = time.time() - 3600
    for r, _dirs, fs in os.walk(qdir):
        for fn in fs:
            os.utime(os.path.join(r, fn), (old, old))
    check(d, lambda r: any("MAY be stale" in w for w in r["warnings"]))


def case_round_state(ops, base, tmp, check):
    """Two saves: two complete rounds; a stale staging directory and a
    'current' that lags the newest round warn and never error."""
    d = tmp / "log"
    d.mkdir()
    config = _round_state_config()
    ops.save_config(config, str(d / "config.yml"))
    model = ops.new_model(config)
    model.save_model(str(d))
    model.save_model(str(d))
    check(str(d), lambda r: not r["errors"] and r["info"]["layout"] == "rounds"
          and r["info"]["rounds_complete"] == 2 and r["info"]["round_selected"] == "00000002")
    os.makedirs(d / "rounds" / ".tmp-00000003")
    check(str(d), lambda r: not r["errors"]
          and any("interrupted save round" in w for w in r["warnings"]))
    cur = d / "current"
    cur.unlink()
    os.symlink(os.path.join("rounds", "00000001"), cur)
    check(str(d), lambda r: not r["errors"] and any("pointer" in w for w in r["warnings"])
          and r["info"]["round_selected"] == "00000001")


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


def _run_case(case, layout, base, tmp, capsys, jax_oracle):
    """The case on ``layout``'s directory: the port doctor's summaries, and,
    on the JAX layout, the JAX doctor's (with ``jax_oracle``)."""
    got, oracle = [], []

    def check(d, expect):
        report = port_tool.validate_logdir(d)
        assert expect(report), report
        rc, rc_strict, out = _exit_codes(port_tool, d, capsys)
        got.append(_summary(report, rc, rc_strict))
        json.loads(out[:out.index("\n}") + 2])  # --json prints one object
        if jax_oracle:
            ref = jax_tool.validate_logdir(d)
            assert expect(ref), ref
            oracle.append(_summary(ref, *_exit_codes(jax_tool, d, capsys)[:2]))

    CASES[case](OPS[layout], base, tmp, check)
    return got, oracle


@pytest.fixture(scope="module")
def oracles(base_logdirs, tmp_path_factory):
    """{case: the JAX doctor's summaries on the JAX-written directory}, made once."""
    cache = {}

    def get(case, capsys):
        if case not in cache:
            tmp = tmp_path_factory.mktemp(f"oracle_{case}")
            cache[case] = _run_case(case, "jax", base_logdirs["jax"], tmp, capsys, True)[1]
        return cache[case]

    return get


@pytest.mark.parametrize("layout", ["jax", "port"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_doctor_agrees_with_the_jax_doctor(case, layout, base_logdirs, oracles, tmp_path,
                                           capsys):
    if layout == "jax":
        got, oracle = _run_case(case, "jax", base_logdirs["jax"], tmp_path, capsys, True)
    else:
        got, _ = _run_case(case, "port", base_logdirs["port"], tmp_path, capsys, False)
        oracle = oracles(case, capsys)
    assert got == oracle


@pytest.mark.parametrize("name", ["global_f32", "single_bf16"])
def test_committed_jax_fixtures_and_their_converted_copies(name, capsys):
    """The JAX-written fixtures (read through tensorstore here) and
    tools/convert_logdir_torch.py's copies of them get the JAX doctor's
    verdict on the fixture."""
    src = os.path.join(FIXTURES, name)
    ref = jax_tool.validate_logdir(src)
    oracle = _summary(ref, *_exit_codes(jax_tool, src, capsys)[:2])
    for d in (src, os.path.join(FIXTURES, "converted", name)):
        report = port_tool.validate_logdir(d)
        assert _summary(report, *_exit_codes(port_tool, d, capsys)[:2]) == oracle, (d, report)


def test_a_jax_layout_without_tensorstore_is_an_error(monkeypatch):
    """Where tensorstore does not import, the port cannot load a JAX-written
    directory, and the doctor says so in one error naming the converter; the
    converted copy is healthy without it."""
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory

    monkeypatch.setitem(sys.modules, "tensorstore", None)
    src = os.path.join(FIXTURES, "global_f32")
    report = port_tool.validate_logdir(src)
    assert len(report["errors"]) == 1, report
    assert "tensorstore" in report["errors"][0]
    assert "tools/convert_logdir_torch.py" in report["errors"][0]
    assert port_tool.main([src]) == 2
    with pytest.raises(ImportError, match="convert_logdir_torch"):
        load_model_from_directory(src, device="cpu")
    converted = os.path.join(FIXTURES, "converted", "global_f32")
    assert port_tool.validate_logdir(converted)["errors"] == []
    load_model_from_directory(converted, device="cpu")


def _file_mappings(path):
    """[(start, end)] of this process's memory mapped from ``path``."""
    real = os.path.realpath(path)
    out = []
    with open("/proc/self/maps") as f:
        for line in f:
            fields = line.split()
            if len(fields) >= 6 and fields[5] == real:
                lo, hi = (int(x, 16) for x in fields[0].split("-"))
                out.append((lo, hi))
    return out


def test_the_doctor_reads_no_weight_payload_and_no_device(base_logdirs, monkeypatch):
    """On a port directory the doctor opens each params.pt memory-mapped:
    every tensor it gets lies in the file's mapping, none was copied into
    memory; it builds the model on the meta device and leaves CUDA
    uninitialized."""
    real_load = torch.load
    seen = []

    def spy(f, *args, **kwargs):
        out = real_load(f, *args, **kwargs)
        if str(f).endswith("params.pt"):
            assert kwargs.get("mmap") is True and kwargs.get("weights_only") is True
            spans = _file_mappings(f)
            for key, t in out.items():
                ptr = t.untyped_storage().data_ptr()
                assert any(lo <= ptr < hi for lo, hi in spans), (f, key)
            seen.append(f)
        return out

    monkeypatch.setattr(torch, "load", spy)
    report = port_tool.validate_logdir(base_logdirs["port"])
    assert report["errors"] == [] and report["warnings"] == []
    assert len(seen) == 2
    assert not torch.cuda.is_initialized()
