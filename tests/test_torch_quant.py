"""Int8 serving in the port (ops/quant.py, ops/int8_gemm.py) vs the JAX
package's ops/quant.py: the same weights (through bridge.py) and the same
inputs (numpy, seeded) through both, on the CPU, where the port's int8
product runs its plain version."""

import json
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from torch_port_helpers import jax_core_and_params, tiny_config, to_np, torch_model_like
from trustedai_cl_vae_ad_tpu.ops import quant as jquant
from trustedai_cl_vae_ad_tpu_torch import bridge
from trustedai_cl_vae_ad_tpu_torch.ops import int8_gemm as ig
from trustedai_cl_vae_ad_tpu_torch.ops import quant

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(edf=None):
    return tiny_config(image=(64, 48, 3), layers=(4, 8), latent=8, ddf=8, edf=edf)


@pytest.fixture(scope="module")
def pair():
    """(config, JAX core, flax params, the port's model with the same weights, x)."""
    config = _config()
    core, params = jax_core_and_params(config)
    model = torch_model_like(config, params)
    x = np.random.RandomState(1).uniform(0, 1, (4, 64, 48, 3)).astype(np.float32)
    return config, core, params, model, x


def _trees(pair, min_elems=0):
    """The JAX quantized tree and the same tree carried into the port."""
    _, core, params, _, _ = pair
    jq = jquant.quantize_params(core, params, min_elems=min_elems)
    return jq, bridge.qparams_from_flax(jax.device_get(jq))


# -- the arithmetic ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(300, 7), (64, 130), (1, 5)], ids=str)
def test_quantize_dense_kernel_matches_jax(shape):
    """int8 values equal, scales at rtol 1e-6 (both divide by 127 and round
    half to even); the port's kernel is (out, in), the JAX one (in, out)."""
    w = np.random.RandomState(0).randn(*shape).astype(np.float32)  # (in, out)
    w[:, 0] = 0.0  # an all-zero output channel: the scale is clamped, the row is 0
    jk, js = jquant.quantize_dense_kernel(jnp.asarray(w))
    tk, ts = quant.quantize_dense_kernel(torch.from_numpy(w.T.copy()))
    assert tk.dtype == torch.int8 and tk.shape == (shape[1], shape[0])
    np.testing.assert_array_equal(tk.numpy().T, np.asarray(jk))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    assert int(tk.abs().max()) == 127 and int(tk[0].abs().max()) == 0


def test_quantize_dense_kernel_row_blocks_and_bf16():
    """Working through the kernel in row blocks changes nothing, and a
    bfloat16 kernel is widened first, as in the JAX function."""
    w = torch.from_numpy(np.random.RandomState(2).randn(37, 50).astype(np.float32))
    whole = quant.quantize_dense_kernel(w)
    with mock.patch.object(quant, "_ROW_BLOCK_ELEMS", 120):  # 2 rows at a time
        blocks = quant.quantize_dense_kernel(w)
    assert torch.equal(whole[0], blocks[0]) and torch.equal(whole[1], blocks[1])
    wb = w.to(torch.bfloat16)
    jk, js = jquant.quantize_dense_kernel(jnp.asarray(wb.float().numpy().T, jnp.bfloat16))
    tk, ts = quant.quantize_dense_kernel(wb)
    np.testing.assert_array_equal(tk.numpy().T, np.asarray(jk))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    with pytest.raises(ValueError):
        quant.quantize_dense_kernel(w[0])


def test_kernel_quantization_error_bound(pair):
    model = pair[3]
    w = model.params["decoder.layers.Dense_0.weight"]
    k_i8, scale = quant.quantize_dense_kernel(w)
    err = (w - k_i8.float() * scale[:, None]).abs()
    # symmetric rounding: the error of a row is at most half its scale
    assert bool((err <= scale[:, None] * 0.5 + 1e-7).all())


@pytest.mark.parametrize("safe_k", [1 << 17, 128], ids=["one-chunk", "three-chunks"])
@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_dense_matches_jax(mode, safe_k):
    """_dense on identical inputs, with K = 300 below the chunk guard and
    above a patched one (300 -> 128 + 128 + 44): the int32 partial products
    equal the JAX dots exactly. In w8a8 the sums are integers and the rescale
    is elementwise, so the outputs agree at rtol 1e-6 / atol 1e-6; in w8 the
    product is a float32 dot over 300 terms summed in another order, held at
    rtol 1e-5 / atol 1e-5 (outputs reach 40)."""
    rng = np.random.RandomState(0)
    x = rng.randn(3, 300).astype(np.float32)
    w = rng.randn(300, 7).astype(np.float32)
    bias = rng.randn(7).astype(np.float32)
    jk, js = jquant.quantize_dense_kernel(jnp.asarray(w))
    jp = {"kernel_i8": jk, "scale": js, "bias": jnp.asarray(bias)}
    tp = {"kernel_i8": torch.from_numpy(np.asarray(jk).T.copy()),
          "scale": torch.from_numpy(np.array(js)), "bias": torch.from_numpy(bias)}
    with mock.patch.object(jquant, "_I32_SAFE_K", safe_k), \
            mock.patch.object(quant, "_I32_SAFE_K", safe_k):
        want = np.asarray(jquant._dense(jp, jnp.asarray(x), jnp.float32, mode))
        got = quant._dense(tp, torch.from_numpy(x), torch.float32, mode).numpy()
        # the activations quantize to the same int8 values, and each chunk's
        # int32 product equals the JAX dot over the same slice
        sx = np.maximum(np.abs(x).max(axis=1, keepdims=True) / np.float32(127.0),
                        np.finfo(np.float32).tiny)
        x_i8 = np.clip(np.round(x / sx), -127, 127).astype(np.int8)
        partials = quant._int8_partials(torch.from_numpy(x_i8), tp["kernel_i8"])
    assert len(partials) == -(-300 // safe_k)
    for c, part in enumerate(partials):
        s, e = c * safe_k, min((c + 1) * safe_k, 300)
        dot = lax.dot_general(jnp.asarray(x_i8[:, s:e]), jk[s:e], (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
        assert part.dtype == torch.int32
        np.testing.assert_array_equal(part.numpy(), np.asarray(dot))
    tol = 1e-6 if mode == "w8a8" else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_dense_exact_on_prequantized_activations():
    """Activations that are already integers in [-127, 127] with a row
    maximum of 127 quantize to themselves (sx = 1): no rounding can flip, and
    the two packages agree to the last bit of the int32 sums and to float32
    rounding of the rescale."""
    rng = np.random.RandomState(3)
    x = rng.randint(-127, 128, (4, 200)).astype(np.float32)
    x[:, 0] = 127.0
    w = rng.randn(200, 9).astype(np.float32)
    jk, js = jquant.quantize_dense_kernel(jnp.asarray(w))
    zero = np.zeros(9, np.float32)
    jp = {"kernel_i8": jk, "scale": js, "bias": jnp.asarray(zero)}
    tp = {"kernel_i8": torch.from_numpy(np.asarray(jk).T.copy()),
          "scale": torch.from_numpy(np.array(js)), "bias": torch.from_numpy(zero)}
    want = np.asarray(jquant._dense(jp, jnp.asarray(x), jnp.float32, "w8a8"))
    got = quant._dense(tp, torch.from_numpy(x), torch.float32, "w8a8").numpy()
    acc = x.astype(np.int64) @ np.asarray(jk).astype(np.int64)
    np.testing.assert_array_equal(
        quant._int8_partials(torch.from_numpy(x.astype(np.int8)), tp["kernel_i8"])[0].numpy(), acc)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, acc.astype(np.float32) * np.asarray(js)[None], rtol=1e-6)


def test_dense_rejects_unknown_mode(pair):
    model = pair[3]
    p = {"weight": model.params["decoder.layers.Dense_0.weight"],
         "bias": model.params["decoder.layers.Dense_0.bias"]}
    with pytest.raises(ValueError, match="unknown quantization mode"):
        quant._dense(p, torch.zeros((1, p["weight"].shape[1])), torch.float32, "w8a16")


# -- the int8 product's wrapper and plain version (the kernel runs on the card) ---------

@pytest.mark.parametrize("m, k, n, k0, k1", [(1, 64, 5, 0, None), (3, 1003, 37, 0, None),
                                             (16, 300, 40, 17, 250), (33, 70, 3, 69, 70)],
                         ids=["m1", "ragged", "range", "one-column"])
def test_int8_gemm_reference_is_exact(m, k, n, k0, k1):
    rng = np.random.RandomState(k)
    x = rng.randint(-127, 128, (m, k)).astype(np.int8)
    w = rng.randint(-127, 128, (n, k)).astype(np.int8)
    end = k if k1 is None else k1
    want = x[:, k0:end].astype(np.int64) @ w[:, k0:end].astype(np.int64).T
    before = ig.launches
    got = ig.int8_gemm(torch.from_numpy(x), torch.from_numpy(w), k0, k1)
    assert got.dtype == torch.int32 and ig.launches == before  # the plain version does not count
    np.testing.assert_array_equal(got.numpy(), want)
    small = ig.int8_gemm_reference(torch.from_numpy(x), torch.from_numpy(w), k0, k1, chunk=7)
    np.testing.assert_array_equal(small.numpy(), want)


def test_int8_gemm_reference_saturated_and_wrapping():
    """A saturated safe chunk is exact; a range that leaves int32 wraps modulo
    2^32, as the kernel's arithmetic does."""
    k = quant._I32_SAFE_K
    x = torch.full((1, k), 127, dtype=torch.int8)
    assert int(ig.int8_gemm(x, x)[0, 0]) == 127 * 127 * k < 2 ** 31
    assert 127 * 127 * ig.I32_EXACT_K < 2 ** 31 <= 127 * 127 * (ig.I32_EXACT_K + 1)
    assert quant._I32_SAFE_K <= ig.I32_EXACT_K
    k = ig.I32_EXACT_K + 8
    x = torch.full((1, k), 127, dtype=torch.int8)
    assert int(ig.int8_gemm(x, x)[0, 0]) == 127 * 127 * k - 2 ** 32


def test_int8_gemm_rejects_bad_inputs():
    x = torch.zeros((2, 32), dtype=torch.int8)
    w = torch.zeros((5, 32), dtype=torch.int8)
    with pytest.raises(TypeError):
        ig.int8_gemm(x.to(torch.int32), w)
    with pytest.raises(TypeError):
        ig.int8_gemm(x, w.float())
    for bad_x, bad_w in ((x[:, ::2], w[:, ::2]), (x.t().contiguous().t(), w), (x[0], w),
                         (x, w[:, :16].contiguous()), (x[:0], w)):
        with pytest.raises(ValueError):
            ig.int8_gemm(bad_x, bad_w)
    for k0, k1 in ((-1, 8), (8, 8), (0, 33), (9, 3)):
        with pytest.raises(ValueError):
            ig.int8_gemm(x, w, k0, k1)
    with pytest.raises(ValueError, match="cuda and cpu"):
        ig.int8_gemm(x.to("meta"), w.to("meta"))


# -- the forward -----------------------------------------------------------------------

@pytest.mark.parametrize("edf", [None, 16])
def test_unquantized_transcription_equals_call(edf):
    """With nothing quantized call_quantized IS core.call, bit for bit, for
    both encoder shapes (with and without encoder_dense_filters), and agrees
    with the JAX call_quantized at 1e-5."""
    config = _config(edf)
    core, params = jax_core_and_params(config)
    model = torch_model_like(config, params)
    x = np.random.RandomState(1).uniform(0, 1, (4, 64, 48, 3)).astype(np.float32)
    qp = quant.quantize_params(model.core, model.params, min_elems=1 << 62)
    with torch.inference_mode():
        got = quant.call_quantized(model.core, qp, torch.from_numpy(x))
        assert torch.equal(got, model.core.call(torch.from_numpy(x)))
    jq = jquant.quantize_params(core, params, min_elems=1 << 62)
    np.testing.assert_allclose(got.numpy(), np.asarray(jquant.call_quantized(core, jq, x)),
                               atol=1e-5)


def test_call_quantized_uint8_contract(pair):
    _, _, _, model, x = pair
    x_u8 = np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)
    qp = quant.quantize_params(model.core, model.params, min_elems=0)
    with torch.inference_mode():
        got = quant.call_quantized(model.core, qp, torch.from_numpy(x_u8))
        ref = quant.call_quantized(model.core, qp, torch.from_numpy(x_u8).float() / 255.0)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_call_quantized_matches_jax(pair, mode):
    """The same quantized tree (the JAX package's, through the bridge) and the
    same batch through both packages. Tolerance 2e-4 on sigmoid outputs: the
    convolutions of the two libraries differ by about 1e-7, which can move
    one activation across a .5 rounding boundary of its int8 quantization;
    that moves a Dense output by one step, sx * scale (about 1e-4 here), and
    the decoder passes a fraction of it on. In w8 mode nothing is rounded and
    the two agree at 1e-5."""
    _, core, _, model, x = pair
    jq, tq = _trees(pair)
    want = np.asarray(jquant.call_quantized(core, jq, jnp.asarray(x), mode=mode))
    with torch.inference_mode():
        got = quant.call_quantized(model.core, tq, torch.from_numpy(x), mode=mode).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 if mode == "w8" else 2e-4)


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quantized_reconstruction_fidelity(pair, mode):
    _, _, _, model, x = pair
    qp = quant.quantize_params(model.core, model.params, min_elems=0)
    with torch.inference_mode():
        ref = model.core.call(torch.from_numpy(x)).numpy()
        got = quant.call_quantized(model.core, qp, torch.from_numpy(x), mode=mode).numpy()
    assert float(np.mean((got - ref) ** 2)) < 1e-4
    assert float(np.max(np.abs(got - ref))) < 0.05


def test_anomaly_decision_parity(pair):
    """Per-frame squared-error sums agree between the float and the quantized
    forward on a clean frame and one with a blob: same order, within 2%."""
    model = pair[3]
    rng = np.random.RandomState(0)
    clean = (np.full((64, 48, 3), 0.5) + rng.uniform(-0.02, 0.02, (64, 48, 3))).astype(np.float32)
    blob = clean.copy()
    blob[20:40, 15:35, :] = 1.0
    x = torch.from_numpy(np.stack([clean, blob]))
    qp = quant.quantize_params(model.core, model.params, min_elems=0)
    with torch.inference_mode():
        eps_f = ((x - model.core.call(x)) ** 2).sum(dim=(1, 2, 3)).numpy()
        eps_q = ((x - quant.call_quantized(model.core, qp, x)) ** 2).sum(dim=(1, 2, 3)).numpy()
    assert eps_f[1] > eps_f[0] and eps_q[1] > eps_q[0]
    np.testing.assert_allclose(eps_q, eps_f, rtol=0.02)


# -- the tree ---------------------------------------------------------------------------

def test_quantize_params_keeps_float_layers_by_reference(pair):
    model = pair[3]
    qp = quant.quantize_params(model.core, model.params, min_elems=0)
    assert qp["encoder"]["Conv_0"]["weight"].data_ptr() == \
        model.core.encoder.layers["Conv_0"].weight.data_ptr()
    assert qp["decoder"]["ConvTranspose_2"]["bias"].data_ptr() == \
        model.core.decoder.layers["ConvTranspose_2"].bias.data_ptr()
    for entry in (qp["decoder"]["Dense_0"], qp["encoder"]["Dense_0"]):
        assert set(entry) == {"kernel_i8", "scale", "bias"} and entry["kernel_i8"].dtype == torch.int8
    assert quant.tree_nbytes(qp) < sum(t.numel() * 4 for t in model.params.values())


def test_min_elems_threshold_and_environment_override(pair, monkeypatch):
    """min_elems is resolved at call time: the patched default, then the
    TCVAE_QUANT_MIN_ELEMS override; only Dense kernels at least that large
    are quantized."""
    model = pair[3]
    big = model.params["encoder.layers.Dense_0.weight"].numel()
    small = model.params["decoder.layers.Dense_0.weight"].numel()
    assert small < big
    assert not quant._is_qdense(quant.quantize_params(model.core, model.params)["encoder"]["Dense_0"])
    with mock.patch.object(quant, "DEFAULT_MIN_ELEMS", big):
        qp = quant.quantize_params(model.core, model.params)
    assert quant._is_qdense(qp["encoder"]["Dense_0"])
    assert not quant._is_qdense(qp["decoder"]["Dense_0"])
    monkeypatch.setenv("TCVAE_QUANT_MIN_ELEMS", str(small))
    qp = quant.quantize_params(model.core, model.params)
    assert quant._is_qdense(qp["encoder"]["Dense_0"]) and quant._is_qdense(qp["decoder"]["Dense_0"])


def test_quantized_tree_crosses_the_bridge_both_ways(pair):
    """JAX quantize_params output loads into the port, where it equals the
    port's own quantization of the same weights; and the port's tree, carried
    back, runs in the JAX call_quantized to the same result."""
    _, core, _, model, x = pair
    jq, tq = _trees(pair)
    own = quant.quantize_params(model.core, model.params, min_elems=0)
    for part in ("encoder", "decoder"):
        assert set(tq[part]) == set(own[part])
        for layer, entry in own[part].items():
            assert set(tq[part][layer]) == set(entry), layer
            for leaf, t in entry.items():
                if leaf == "scale":
                    np.testing.assert_allclose(to_np(tq[part][layer][leaf]), to_np(t), rtol=1e-6)
                else:
                    assert torch.equal(tq[part][layer][leaf], t), (part, layer, leaf)
    back = bridge.qparams_to_flax(own)
    assert back["encoder"]["Dense_0"]["kernel_i8"].dtype == np.int8
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(jq)), jax.tree_util.tree_leaves(back)):
        assert a.shape == b.shape and a.dtype == b.dtype
    want = np.asarray(jquant.call_quantized(core, jq, jnp.asarray(x)))
    got = np.asarray(jquant.call_quantized(core, jax.tree_util.tree_map(jnp.asarray, back),
                                           jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_serving_forward_selects_the_path(pair):
    """Float: the module itself. quantize: a quantized copy. qparams: the
    given tree, with the float params never touched (None on an int8 boot)."""
    _, _, _, model, x = pair
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        fwd, sp = quant.serving_forward(model.core, model.params)
        assert set(sp) == set(model.params)
        assert torch.equal(fwd(sp, xt), model.core.call(xt))
        with mock.patch.object(quant, "DEFAULT_MIN_ELEMS", 0):
            fwd, sp = quant.serving_forward(model.core, model.params, quantize=True)
        assert quant._is_qdense(sp["decoder"]["Dense_0"])
        want = quant.call_quantized(model.core, sp, xt)
        assert torch.equal(fwd(sp, xt), want)
        fwd2, sp2 = quant.serving_forward(model.core, None, quantize=True, qparams=sp)
        assert sp2 is sp and torch.equal(fwd2(sp2, xt), want)
        fwd8, _ = quant.serving_forward(model.core, None, qparams=sp, mode="w8")
        assert torch.equal(fwd8(sp, xt), quant.call_quantized(model.core, sp, xt, mode="w8"))


# -- the sidecar ------------------------------------------------------------------------

def _logdir(model, tmp_path):
    from trustedai_cl_vae_ad_tpu_torch.config import save_config

    d = str(tmp_path / "logdir")
    os.makedirs(d)
    model.save_model(d)
    save_config(model.config, os.path.join(d, "config.yml"))
    return d


def test_quantized_checkpoint_roundtrip(pair, tmp_path):
    _, _, _, model, x = pair
    qp = quant.quantize_params(model.core, model.params, min_elems=0)
    d = _logdir(model, tmp_path)
    assert not quant.has_quantized_checkpoint(d)
    with pytest.raises(FileNotFoundError):
        quant.load_quantized_checkpoint(d, "cpu")
    path = quant.save_quantized_checkpoint(d, qp)
    assert path.endswith("quantized") and quant.has_quantized_checkpoint(d)
    assert sorted(os.listdir(path)) == ["commit.json", "float_provenance.json", "params.pt"]
    rq = quant.load_quantized_checkpoint(d, "cpu")
    for part in qp:
        assert list(rq[part]) == list(qp[part])
        for layer, entry in qp[part].items():
            for leaf, t in entry.items():
                r = rq[part][layer][leaf]
                assert r.dtype == t.dtype and torch.equal(r, t), (part, layer, leaf)
    with torch.inference_mode():
        xt = torch.from_numpy(x)
        assert torch.equal(quant.call_quantized(model.core, rq, xt),
                           quant.call_quantized(model.core, qp, xt))
    # a second save replaces the first and leaves nothing behind
    quant.save_quantized_checkpoint(d, qp)
    assert sorted(n for n in os.listdir(d) if n.startswith("quantized")) == ["quantized"]


@pytest.mark.parametrize("leftover", ["staging-complete", "staging-incomplete", "old"])
def test_heal_after_a_save_killed_between_the_renames(pair, tmp_path, leftover):
    """A kill after ``quantized`` was moved aside and before the staged tree
    took its place leaves ``.old`` and ``.staging``: a complete staging
    directory (its provenance stamp is written last) wins, else the displaced
    copy comes back; a later save does not sweep the only copy away."""
    model = pair[3]
    d = _logdir(model, tmp_path)
    old_tree = quant.quantize_params(model.core, model.params, min_elems=0)
    path = quant.save_quantized_checkpoint(d, old_tree)
    new_tree = quant.quantize_params(model.core, model.params, min_elems=1 << 62)
    os.rename(path, path + ".old")
    if leftover != "old":
        os.makedirs(path + ".staging")
        flat = {f"{part}/{layer}/{leaf}": t for part, layers in new_tree.items()
                for layer, p in layers.items() for leaf, t in p.items()}
        torch.save(flat, os.path.join(path + ".staging", quant.QUANTIZED_FILE))
        if leftover == "staging-complete":
            with open(os.path.join(path + ".staging", quant.PROVENANCE_FILE), "w") as f:
                json.dump({"float_checkpoint": quant.float_checkpoint_stamp(d)}, f)
    assert quant.has_quantized_checkpoint(d)  # heals
    got = quant.load_quantized_checkpoint(d, "cpu")
    healed_new = leftover == "staging-complete"
    assert quant._is_qdense(got["decoder"]["Dense_0"]) != healed_new
    quant.save_quantized_checkpoint(d, old_tree)
    assert sorted(n for n in os.listdir(d) if n.startswith("quantized")) == ["quantized"]
    assert quant._is_qdense(quant.load_quantized_checkpoint(d, "cpu")["decoder"]["Dense_0"])


def test_float_checkpoint_stamp_follows_content(pair, tmp_path):
    model = pair[3]
    d = _logdir(model, tmp_path)
    stamp = quant.float_checkpoint_stamp(d)
    assert set(stamp) == {"encoder", "decoder"} and all(len(v) == 64 for v in stamp.values())
    for r, _dirs, fs in os.walk(d):
        for f in fs:
            os.utime(os.path.join(r, f), (1000.0, 1000.0))
    assert quant.float_checkpoint_stamp(d) == stamp  # mtimes are not content
    other = torch_model_like(model.config, jax_core_and_params(model.config, seed=5)[1])
    other.save_model(d)
    changed = quant.float_checkpoint_stamp(d)
    assert changed["encoder"] != stamp["encoder"] and changed["decoder"] != stamp["decoder"]
    assert quant.float_checkpoint_stamp(str(tmp_path / "none")) == {"encoder": None,
                                                                    "decoder": None}


def test_quantized_staleness_verdicts(pair, tmp_path):
    """Fresh provenance: None. A retrained float checkpoint: the content-based
    provenance_mismatch even with every mtime equal. Without provenance:
    commit stamps where files carry them (commit_older), else mtimes
    (mtime_older). A blank provenance stamp is no evidence."""
    model = pair[3]
    qp = quant.quantize_params(model.core, model.params, min_elems=0)
    d = _logdir(model, tmp_path)
    qdir = quant.save_quantized_checkpoint(d, qp)
    assert quant.quantized_staleness(d) is None

    other = torch_model_like(model.config, jax_core_and_params(model.config, seed=5)[1])
    other.save_model(d)  # "retrain"
    for r, _dirs, fs in os.walk(d):
        for f in fs:
            os.utime(os.path.join(r, f), (1000.0, 1000.0))
    verdict = quant.quantized_staleness(d)
    assert verdict is not None and verdict[0] == "provenance_mismatch"
    messages = []
    booted, _ = quant.load_int8_serving_model(d, device="cpu", log=messages.append)
    assert any("WARNING" in m and "DIFFERENT" in m for m in messages)
    assert booted.params is None

    # no provenance: commit stamps decide where both sides carry one
    os.remove(os.path.join(qdir, quant.PROVENANCE_FILE))
    q_commit = json.load(open(os.path.join(qdir, quant.COMMIT_FILE)))["commit_timestamp_nsecs"]
    for part, dt in (("encoder", -5), ("decoder", +5)):
        with open(os.path.join(d, part, quant.COMMIT_FILE), "w") as f:
            json.dump({"commit_timestamp_nsecs": q_commit + dt}, f)
    assert quant.quantized_staleness(d)[0] == "commit_older"
    with open(os.path.join(d, "decoder", quant.COMMIT_FILE), "w") as f:
        json.dump({"commit_timestamp_nsecs": q_commit - 1}, f)
    assert quant.quantized_staleness(d) is None

    # no content evidence at all: mtimes, with soft wording
    for part in ("encoder", "decoder"):
        os.remove(os.path.join(d, part, quant.COMMIT_FILE))
    for r, _dirs, fs in os.walk(d):
        for f in fs:
            os.utime(os.path.join(r, f), (1000.0, 1000.0))
    assert quant.quantized_staleness(d) is None
    os.utime(os.path.join(d, "encoder", "params.pt"), (2000.0, 2000.0))
    verdict = quant.quantized_staleness(d)
    assert verdict[0] == "mtime_older" and "MAY be stale" in verdict[1]

    # an all-None provenance stamp falls through to the weaker evidence
    with open(os.path.join(qdir, quant.PROVENANCE_FILE), "w") as f:
        json.dump({"float_checkpoint": {"encoder": None, "decoder": None}}, f)
    os.utime(os.path.join(qdir, quant.PROVENANCE_FILE), (1000.0, 1000.0))
    assert quant.quantized_staleness(d)[0] == "mtime_older"


def test_int8_boot_serves_without_float_params(pair, tmp_path):
    """load_int8_serving_model: the core stays on the meta device, the tree
    serves the same reconstruction, and save_model re-persists the tree."""
    _, _, _, model, x = pair
    d = _logdir(model, tmp_path)
    qp = quant.quantize_params(model.core, model.params, min_elems=0)
    quant.save_quantized_checkpoint(d, qp)
    booted, config = quant.load_int8_serving_model(d, device="cpu", log=lambda m: None)
    assert isinstance(booted, quant.QuantizedServingModel) and booted.optimizer is None
    assert booted.params is None and booted.device.type == "cpu"
    assert all(p.device.type == "meta" for p in booted.core.parameters())
    assert config["model"]["latent_dimensions"] == 8
    fwd, sp = quant.serving_forward(booted.core, booted.params, quantize=True,
                                    qparams=booted.qparams)
    with torch.inference_mode():
        xt = torch.from_numpy(x)
        assert torch.equal(fwd(sp, xt), quant.call_quantized(model.core, qp, xt))
    snap = str(tmp_path / "snapshot")
    os.makedirs(snap)
    booted.save_model(snap)
    assert quant.has_quantized_checkpoint(snap) and not os.path.isdir(os.path.join(snap, "encoder"))


# -- the engine ---------------------------------------------------------------------------

def _frames(n, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, (64, 48, 3), np.uint8) for _ in range(n)]


def test_streaming_engine_quantized_cl_requantizes():
    """StreamingEngine(quantize=True): the dispatch runs on the int8 serving
    copy, and a CL step quantizes it again from the trained float params."""
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import StreamingEngine

    config = _config()
    model = load_model_from_config(config, seed=0, device="cpu")
    with mock.patch.object(quant, "DEFAULT_MIN_ELEMS", 0):
        eng = StreamingEngine(model, config, quantize=True, inference_period_ms=0.0,
                              continuous_learning_period_ms=0.0)
        eng.enable_cont_learning = True
        assert eng.quantized and "kernel_i8" in eng._serve_params["decoder"]["Dense_0"]
        before = eng._serve_params["decoder"]["Dense_0"]["kernel_i8"].clone()
        r = None
        for t, f in enumerate(_frames(3)):
            r = eng.process_frame(f, now=float(t + 1))
        assert r is not None and np.isfinite(r.pixel_count) and r.cl_stepped
        assert eng.cl_epochs >= 1
        after = eng._serve_params["decoder"]["Dense_0"]["kernel_i8"]
        assert bool((before != after).any())  # the serving copy followed the CL update
        want, _ = quant.quantize_dense_kernel(model.params["decoder.layers.Dense_0.weight"])
        assert torch.equal(after, want)


def test_streaming_engine_quantized_tracks_float_engine():
    """The same frames through a float and a quantized engine from one warm
    scorer state: counts within 2, and equal scores while the counts agree."""
    from trustedai_cl_vae_ad_tpu_torch.ops.stream_score import StreamScoreState
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import StreamingEngine
    from trustedai_cl_vae_ad_tpu_torch.testing import warm_score_state

    config = _config()
    model = load_model_from_config(config, seed=0, device="cpu")
    engines = []
    for quantize in (False, True):
        with mock.patch.object(quant, "DEFAULT_MIN_ELEMS", 0):
            e = StreamingEngine(model, config, quantize=quantize, inference_period_ms=0.0)
        maps, scalars = warm_score_state(64, 48)
        e.score_state = StreamScoreState(torch.from_numpy(maps), torch.from_numpy(scalars))
        engines.append(e)
    rng = np.random.RandomState(7)
    base = rng.randint(0, 255, (64, 48, 3)).astype(np.int16)
    for t in range(6):
        f = np.clip(base + rng.randint(-3, 4, base.shape), 0, 255).astype(np.uint8)
        a, b = (e.process_frame(f, now=float(t)) for e in engines)
        assert abs(a.pixel_count - b.pixel_count) <= 2
        assert int(np.abs(a.reconstruction_u8.astype(int) - b.reconstruction_u8.astype(int)).max()) <= 2


def test_cl_on_an_int8_boot_raises(pair, tmp_path):
    """An engine booted from the int8 sidecar is inference-only: every CL
    control raises, as in the JAX engine; scoring works."""
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import StreamingEngine

    model = pair[3]
    d = _logdir(model, tmp_path)
    quant.save_quantized_checkpoint(d, quant.quantize_params(model.core, model.params, min_elems=0))
    booted, config = quant.load_int8_serving_model(d, device="cpu", log=lambda m: None)
    eng = StreamingEngine(booted, config, qparams=booted.qparams, inference_period_ms=0.0,
                          continuous_learning_period_ms=0.0)
    assert eng.quantized
    r = eng.process_frame(_frames(1)[0], now=1.0)
    assert r is not None and np.isfinite(r.pixel_count)
    with pytest.raises(RuntimeError, match="int8 checkpoint"):
        eng.set_learning_rate(1e-4)
    with pytest.raises(RuntimeError, match="int8 checkpoint"):
        eng.warmup(cl=True)
    eng.enable_cont_learning = True
    with pytest.raises(RuntimeError, match="int8 checkpoint"):
        eng.process_frame(_frames(1)[0], now=2.0)


# -- the tool and the boot through the CLI's loader -----------------------------------------

def test_quantize_checkpoint_tool_and_cli_boot(pair, tmp_path):
    """tools/quantize_checkpoint_torch.py writes the sidecar of a log
    directory; load_serving_model then boots --quantize from it (no float
    parameters), keeps the float boot for continual learning, and says so
    when there is no sidecar."""
    from trustedai_cl_vae_ad_tpu_torch.stream.run import load_serving_model

    model = pair[3]
    d = _logdir(model, tmp_path)
    messages = []
    m, _c, qp = load_serving_model(d, None, "cpu", quantize=True, log=messages.append)
    assert qp is None and m.params is not None and any("float boot" in s for s in messages)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "quantize_checkpoint_torch.py"), "-m", d,
         "--min-elems", "0", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert "quantized checkpoint written" in proc.stdout and " MB)" in proc.stdout
    assert quant.quantized_staleness(d) is None
    m, _c, qp = load_serving_model(d, None, "cpu", quantize=True, log=lambda s: None)
    assert m.params is None and quant._is_qdense(qp["encoder"]["Dense_0"])
    want, _ = quant.quantize_dense_kernel(model.params["encoder.layers.Dense_0.weight"])
    assert torch.equal(qp["encoder"]["Dense_0"]["kernel_i8"], want)
    m, _c, qp = load_serving_model(d, None, "cpu", quantize=True, continual_learning=True,
                                   log=lambda s: None)
    assert qp is None and m.params is not None
    m, _c, qp = load_serving_model(d, None, "cpu", quantize=False, log=lambda s: None)
    assert qp is None and m.params is not None
