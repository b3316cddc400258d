"""The port's scoring server (``serve_torch.py``): the cases of
``tests/test_serve.py`` run against it, and parity with ``serve.py`` on the
same weights (through ``bridge.py``) and the same PNGs, on the CPU at a tiny
config. Every server listens on port 0, every ``urlopen`` has a timeout, and
each server is shut down and its batcher closed when its test or module
ends.

Tolerances: float /score eps at rtol 1e-5 (float32 forwards of the two
libraries); /reconstruct within one grey level (a value at .5 may round
either way); --quantize eps at rtol 2e-4, the bound on the w8a8 forwards'
outputs of ``tests/test_torch_quant.py::test_call_quantized_matches_jax``."""

import contextlib
import importlib.util
import io
import json
import os
import select
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_port_helpers import paired_models, tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

_LIVE = {}  # the live MicroBatcher of the module's server, for direct-submit tests


def _config():
    return tiny_config(image=(16, 16, 3), layers=(4,), latent=4, model_type="KurtosisSingle")


@pytest.fixture(scope="module")
def logdirs(tmp_path_factory):
    """The same weights as a JAX log directory and as the port's, with a
    stats file beside them."""
    from trustedai_cl_vae_ad_tpu.config import save_config as jax_save_config
    from trustedai_cl_vae_ad_tpu_torch.config import save_config

    config = _config()
    jmodel, tmodel = paired_models(config, compile=False)
    root = tmp_path_factory.mktemp("serve_torch")
    jdir, tdir = root / "jax", root / "port"
    jdir.mkdir()
    tdir.mkdir()
    jmodel.save_model(str(jdir), include_optimizer=False)
    jax_save_config(config, str(jdir / "config.yml"))
    tmodel.save_model(str(tdir), include_optimizer=False)
    save_config(config, str(tdir / "config.yml"))
    stats = root / "stats.json"
    stats.write_text(json.dumps({"meu": 100.0, "sigma": 10.0}))
    return str(jdir), str(tdir), str(stats)


@contextlib.contextmanager
def _serving(srv):
    """Run ``srv`` in a thread; yield its URL; shut it down and close its batcher."""
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.batcher.close()
        srv.server_close()
        thread.join(timeout=10)


@pytest.fixture(scope="module")
def server(logdirs):
    import serve_torch

    _, tdir, stats = logdirs
    srv = serve_torch.build_server(tdir, port=0, stats_path=stats, threshold=3.0, max_batch=4,
                                   max_wait_ms=10.0, device="cpu")
    _LIVE["batcher"] = srv.batcher
    with _serving(srv) as url:
        yield url


def _png_bytes(seed=0, size=(16, 16), mode="RGB"):
    shape = (*size, 3) if mode == "RGB" else size
    img = np.random.RandomState(seed).randint(0, 255, shape, np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img, mode=mode).save(buf, format="PNG")
    return buf.getvalue()


def _post(url, path, body, timeout=60):
    req = urllib.request.Request(f"{url}{path}", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _score(url, body):
    return json.loads(_post(url, "/score", body))["reconstruction_error"]


# -- the cases of tests/test_serve.py --------------------------------------------------------

def test_healthz(server):
    with urllib.request.urlopen(f"{server}/healthz", timeout=30) as r:
        body = json.loads(r.read())
    assert body["ok"] and body["model_input"] == [16, 16, 3] and body["max_batch"] == 4


def test_score_with_stats(server):
    body = json.loads(_post(server, "/score", _png_bytes(1)))
    assert np.isfinite(body["reconstruction_error"])
    assert "error" not in body  # reserved for failure payloads
    assert "z" in body and "anomalous" in body
    assert abs(body["z"] - (body["reconstruction_error"] - 100.0) / 10.0) < 1e-4


def test_score_resizes_foreign_sizes(server):
    assert np.isfinite(_score(server, _png_bytes(2, (40, 30))))


def test_reconstruct_returns_png(server):
    img = Image.open(io.BytesIO(_post(server, "/reconstruct", _png_bytes(3))))
    assert img.size == (16, 16) and img.mode == "RGB"


def test_concurrent_requests_batch(server):
    """Concurrent clients all get the answer of their image, whichever
    bucket the batcher put it in."""
    results = {}

    def call(i):
        results[i] = _score(server, _png_bytes(7))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    vals = list(results.values())
    assert len(vals) == 6
    np.testing.assert_allclose(vals, vals[0], rtol=1e-4)


def test_bad_image_400(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/score", b"not a png", timeout=30)
    assert e.value.code == 400


def test_max_batch_clamps_to_bucket():
    import serve_torch

    for requested, expected in ((12, 16), (3, 4), (5, 8), (8, 8), (99, 16), (1, 1)):
        assert serve_torch.MicroBatcher._clamp_to_bucket(requested) == expected, requested


def test_bad_submit_fails_future_not_thread(server):
    """A malformed direct submit fails its future; the batcher's thread
    lives on, and a score-only request fetches no reconstruction."""
    batcher = _LIVE["batcher"]
    fut = batcher.submit(np.zeros((99, 99, 99), np.uint8))
    with pytest.raises(Exception):
        fut.result(timeout=30)
    eps, rec = batcher.submit(np.zeros(batcher.hwc, np.uint8)).result(timeout=30)
    assert np.isfinite(eps) and rec is None


def _dead_batcher():
    """A MicroBatcher shell whose worker has already stopped."""
    import queue as _q

    import serve_torch

    batcher = serve_torch.MicroBatcher.__new__(serve_torch.MicroBatcher)
    batcher.queue = _q.Queue()
    batcher._stop = False
    batcher._submit_lock = threading.Lock()

    class _DoneThread:
        def join(self, timeout=None):
            pass

    batcher.thread = _DoneThread()
    return batcher


def test_close_fails_queued_futures():
    from concurrent.futures import Future

    batcher = _dead_batcher()
    fut = Future()
    batcher.queue.put((None, False, fut))
    batcher.close()
    with pytest.raises(RuntimeError, match="shutting down"):
        fut.result(timeout=1)


def _quantize_tool():
    spec = importlib.util.spec_from_file_location(
        "quantize_checkpoint_torch", os.path.join(REPO, "tools", "quantize_checkpoint_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_int8_checkpoint_boot(logdirs, tmp_path, monkeypatch):
    """build_server(quantize=True) boots from <logdir>/quantized when it is
    there (the float weights never made) and scores as the quantize-at-boot
    path does."""
    import shutil

    import serve_torch
    from trustedai_cl_vae_ad_tpu_torch.ops import quant

    d = str(tmp_path / "m")
    shutil.copytree(logdirs[1], d, symlinks=True)
    monkeypatch.setenv("TCVAE_QUANT_MIN_ELEMS", "0")
    srv_ref = serve_torch.build_server(d, port=0, quantize=True, warmup=False, device="cpu")
    srv_q = None
    try:
        assert srv_ref.batcher.model.params is not None
        assert _quantize_tool().main(["-m", d, "--min-elems", "0", "--device", "cpu"]) == 0
        assert quant.has_quantized_checkpoint(d)
        srv_q = serve_torch.build_server(d, port=0, quantize=True, warmup=False, device="cpu")
        assert srv_q.batcher.model.params is None and srv_q.batcher.quantized
        x = np.random.RandomState(0).randint(0, 255, (1, 16, 16, 3), np.uint8)
        with torch.inference_mode():
            eps_ref, _ = srv_ref.batcher._dispatch(x, False)
            eps_q, _ = srv_q.batcher._dispatch(x, False)
        np.testing.assert_allclose(eps_q, eps_ref, rtol=1e-5, atol=1e-6)
    finally:
        for srv in (srv_ref, srv_q):
            if srv is not None:
                srv.batcher.close()
                srv.server_close()


def test_metrics_endpoint(server):
    """/metrics: request counts, a bounded latency window, and the batcher's
    occupancy (batches, mean fill, bucket histogram)."""
    _post(server, "/score", _png_bytes(31))
    with urllib.request.urlopen(f"{server}/metrics", timeout=30) as r:
        m = json.loads(r.read())
    assert m["requests"]["/score"] >= 1 and m["uptime_s"] >= 0
    assert m["latency_ms"]["window"] >= 1 and m["latency_ms"]["p50"] > 0
    b = m["batcher"]
    assert b["items_scored"] >= 1 and b["batches_dispatched"] >= 1
    assert 1.0 <= b["mean_batch_fill"] <= 4.0  # max_batch=4 in the fixture
    assert sum(b["bucket_counts"].values()) == b["batches_dispatched"]
    assert b["quantized"] is False
    with pytest.raises(urllib.error.HTTPError):
        _post(server, "/score", b"not a png", timeout=30)
    with urllib.request.urlopen(f"{server}/metrics", timeout=30) as r:
        assert json.loads(r.read())["failures"].get("/score", 0) >= 1


def test_submit_after_close_fails_fast():
    batcher = _dead_batcher()
    batcher.close()
    fut = batcher.submit(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(RuntimeError, match="shutting down"):
        fut.result(timeout=1)
    assert batcher.queue.empty()


def test_stats_validation():
    import serve_torch

    serve_torch._validate_stats({"meu": 100.0, "sigma": 10.0})
    serve_torch._validate_stats({"meu": 0, "sigma": -1.5})
    for bad in ({"sigma": 2.0}, {"meu": 1.0}, {"meu": 1.0, "sigma": 0},
                {"meu": "1.0", "sigma": 2.0}):
        with pytest.raises(ValueError):
            serve_torch._validate_stats(bad)


# -- the port's own ----------------------------------------------------------------------------

def test_failed_batch_is_a_500_and_the_server_goes_on(server, monkeypatch):
    """A failure inside a batch's forward (a kernel that fails to build or
    launch, on the card) fails that batch's requests with a 500 that names
    it; it is never answered from another path, and the next batch works."""
    batcher = _LIVE["batcher"]
    before = batcher.batch_errors

    def broken(_params, _x):
        raise RuntimeError("int8_gemm (mma) kernel launch failed: test")

    monkeypatch.setattr(batcher, "_forward", broken)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/score", _png_bytes(41), timeout=30)
    assert e.value.code == 500 and "kernel launch failed" in json.loads(e.value.read())["error"]
    assert batcher.batch_errors == before + 1
    monkeypatch.undo()
    assert np.isfinite(_score(server, _png_bytes(41)))


def test_warmup_runs_both_variants_of_every_bucket(server, monkeypatch):
    batcher = _LIVE["batcher"]
    seen = []
    monkeypatch.setattr(batcher, "_dispatch", lambda batch, rec: seen.append(
        (batch.shape[0], rec)))
    batcher.warmup()
    assert seen == [(1, False), (1, True), (2, False), (2, True), (4, False), (4, True)]


@pytest.mark.parametrize("mode", ["RGB", "L"])
@pytest.mark.parametrize("channels", [3, 1])
def test_decode_to_model_size_matches_serve_py(mode, channels):
    """The request image at the model's size: the same uint8 array as
    serve.py's, greyscale (H, W, 1) for a 1-channel model."""
    import serve
    import serve_torch

    body = _png_bytes(5, (23, 17), mode=mode)
    got = serve_torch._decode_to_model_size(body, (16, 12, channels))
    np.testing.assert_array_equal(got, serve._decode_to_model_size(body, (16, 12, channels)))
    assert got.shape == (16, 12, channels) and got.dtype == np.uint8


def test_build_server_defaults_to_the_card(logdirs):
    import serve_torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_torch.build_server(logdirs[1], port=0, warmup=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):  # the CLI, through build_server
        serve_torch.main(["-m", logdirs[1], "--port", "0"])


# -- parity with serve.py ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_server(logdirs):
    import serve

    jdir, _, stats = logdirs
    srv = serve.build_server(jdir, port=0, stats_path=stats, max_batch=4, max_wait_ms=10.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.batcher.close()
        srv.server_close()
        thread.join(timeout=10)


@pytest.mark.parametrize("seed,size", [(11, (16, 16)), (12, (16, 16)), (13, (40, 30))])
def test_score_matches_serve_py(server, jax_server, seed, size):
    body = _png_bytes(seed, size)
    got, want = json.loads(_post(server, "/score", body)), json.loads(_post(jax_server, "/score",
                                                                            body))
    np.testing.assert_allclose(got["reconstruction_error"], want["reconstruction_error"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["z"], want["z"], rtol=1e-5, atol=1e-5)
    assert got["anomalous"] == want["anomalous"]


def test_reconstruct_matches_serve_py(server, jax_server):
    body = _png_bytes(21)
    got = np.asarray(Image.open(io.BytesIO(_post(server, "/reconstruct", body))), np.int16)
    want = np.asarray(Image.open(io.BytesIO(_post(jax_server, "/reconstruct", body))), np.int16)
    assert got.shape == want.shape == (16, 16, 3)
    assert int(np.abs(got - want).max()) <= 1


def test_concurrent_scores_match_serve_py(server, jax_server):
    """Six different images at once through both servers (so buckets of
    several frames form): each answer equals serve.py's for that image."""
    bodies = [_png_bytes(50 + i) for i in range(6)]
    got, want = {}, {}

    def call(url, out, i):
        out[i] = _score(url, bodies[i])

    threads = [threading.Thread(target=call, args=(url, out, i))
               for url, out in ((server, got), (jax_server, want)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    np.testing.assert_allclose([got[i] for i in range(6)], [want[i] for i in range(6)],
                               rtol=1e-5)


def test_quantized_score_matches_serve_py(logdirs, monkeypatch):
    """--quantize on both servers: each quantizes the same float weights at
    boot (int8 values equal between the packages) and serves w8a8."""
    import serve
    import serve_torch

    jdir, tdir, _ = logdirs
    monkeypatch.setenv("TCVAE_QUANT_MIN_ELEMS", "0")
    bodies = [_png_bytes(60 + i) for i in range(3)]
    with _serving(serve.build_server(jdir, port=0, quantize=True, warmup=False)) as url:
        want = [_score(url, b) for b in bodies]
    srv = serve_torch.build_server(tdir, port=0, quantize=True, warmup=False, device="cpu")
    assert srv.batcher.quantized
    with _serving(srv) as url:
        got = [_score(url, b) for b in bodies]
    np.testing.assert_allclose(got, want, rtol=2e-4)


def test_main_drains_on_sigterm(logdirs, tmp_path):
    """The CLI serves until SIGTERM, then fails what is queued and exits 0."""
    _, tdir, _ = logdirs
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "serve_torch.py"), "-m", tdir, "--port", "0",
         "--device", "cpu", "--max-batch", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=REPO))
    try:
        out = b""
        deadline = time.monotonic() + 120
        while b"serving on" not in out:  # os.read: a buffered readline could sit on the marker
            assert time.monotonic() < deadline, out
            ready, _, _ = select.select([proc.stdout], [], [], 1.0)
            if ready:
                chunk = os.read(proc.stdout.fileno(), 4096)
                assert chunk, (out, proc.stderr.read())
                out += chunk
        proc.send_signal(signal.SIGTERM)
        rest, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0, err
    assert b"shutting down" in out + rest


def test_listen_backlog_holds_a_burst_of_clients(server):
    """The server's listen backlog exceeds the largest bucket: a burst of 16
    connections is not dropped into the kernel's 1 s SYN retry (socketserver's
    default backlog, which serve.py keeps, is 5)."""
    import serve_torch

    burst = 8 * serve_torch.MicroBatcher.BUCKETS[-1]
    assert serve_torch.ScoringHTTPServer.request_queue_size >= burst
    assert isinstance(_LIVE["batcher"], serve_torch.MicroBatcher)
