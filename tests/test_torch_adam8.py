"""``adam_fp8`` in the port (``ops/adam8.py``) against the JAX package's
``trustedai_cl_vae_ad_tpu/ops/adam8.py`` on the CPU.

The integer parts (the dither hash, the stochastic cast, the quantizer) are
held bit for bit. The update over 5 steps is held to the bounds: scales
within 1e-6 relative, at least 99.99% of ``q`` equal and every other within
one e4m3 step, parameters within 1e-6 relative (it is bit for bit here: the
port follows the roundings of XLA's compiled CPU update, its multiply-adds,
its folded division and a correctly rounded square root). Then the cases of
``tests/test_adam8.py`` on the port, the leaf order against JAX's flattened
tree, and a tiny model whose encoder Dense (4096 -> 256 = 2**20) is quantized,
trained 3 steps by both packages.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import (
    LOSS_KEYS,
    loss_to_np,
    next_jax_eps,
    paired_models,
    tiny_config,
)
from trustedai_cl_vae_ad_tpu.ops import adam8 as J
from trustedai_cl_vae_ad_tpu_torch.bridge import flax_leaf_layout, fp8_moments_to_optax
from trustedai_cl_vae_ad_tpu_torch.ops import adam8 as T
from trustedai_cl_vae_ad_tpu_torch.ops.adam import make_optimizer

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops on 2**20-element
    tensors, which several test workers each running a thread per core
    slow down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
SHAPES = {"big": (1024, 1024), "small": (32, 8), "bias": (64,)}


def _noise(shape, salt):
    return T._hash_bits(shape, salt)


# -- the integer parts, bit for bit -------------------------------------------------------

@pytest.mark.parametrize("shape,salt", [((7,), 3), ((33, 17), 12345), ((3, 3, 4, 8), 39596),
                                        ((1100, 1024), 2 ** 31 - 7), ((2, 1), 0)])
def test_hash_bits_match_jax(shape, salt):
    ref = np.asarray(J._hash_bits(shape, jnp.int32(salt))).view(np.int32)
    got = T._hash_bits(shape, salt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("layer,flax_shape", [("Dense_0", (96, 40)),
                                              ("Conv_1", (3, 3, 4, 8)),
                                              ("ConvTranspose_2", (3, 3, 8, 4))])
def test_hash_bits_in_the_port_layout_and_in_blocks(layer, flax_shape):
    """The bits of an element are those of its flax index, whatever the
    port's layout, and a block of dim 0 gets its rows' bits."""
    from trustedai_cl_vae_ad_tpu_torch.bridge import _perm

    name = f"encoder.layers.{layer}.weight"
    _, axes = flax_leaf_layout([name])
    perm = _perm(layer)
    ref = np.asarray(J._hash_bits(flax_shape, jnp.int32(77))).view(np.int32).transpose(perm)
    full = T._hash_bits(ref.shape, 77, axes[name])
    np.testing.assert_array_equal(full.numpy(), ref)
    rows = ref.shape[0]
    for r0, r1 in ((0, 1), (1, rows // 2 + 1), (rows // 2 + 1, rows)):
        block = T._hash_bits((r1 - r0,) + ref.shape[1:], 77, axes[name], start=r0)
        np.testing.assert_array_equal(block.numpy(), ref[r0:r1])


def _wide_range(seed, shape, clip=None):
    rs = np.random.RandomState(seed)
    x = (rs.standard_normal(shape) * 10.0 ** rs.uniform(-9, 3, shape)).astype(np.float32)
    x.flat[:6] = [0.0, -0.0, 448.0, -448.0, 2.0 ** -9, 0.0137]
    return np.clip(x, -clip, clip) if clip else x


@pytest.mark.parametrize("dtype", ["bfloat16", "float8_e4m3fn"])
def test_sr_cast_matches_jax(dtype):
    jdt, tdt = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
                "float8_e4m3fn": (J.FP8, T.FP8)}[dtype]
    x = _wide_range(0, (512, 300), clip=448.0 if tdt == T.FP8 else None)
    for salt in (5, 2 ** 20 + 3):
        ref = J._sr_cast(jnp.asarray(x), jdt, J._hash_bits(x.shape, jnp.int32(salt)))
        got = T._sr_cast(torch.from_numpy(x), tdt, _noise(x.shape, salt))
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("sr", [False, True])
def test_quantize_matches_jax(sr):
    x = _wide_range(1, (512, 300))
    scale = np.abs(x).max(-1, keepdims=True) / np.float32(256)
    scale[::7] /= np.float32(9)  # rows that saturate at +-448
    ref = J._quantize(jnp.asarray(x), jnp.asarray(scale), sr, J._hash_bits(x.shape, jnp.int32(9)))
    got = T._quantize(torch.from_numpy(x), torch.from_numpy(scale), sr, _noise(x.shape, 9))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    leaf = T.QLeaf(q=got, scale=torch.from_numpy(scale), scale_next=torch.ones_like(
        torch.from_numpy(scale)))
    np.testing.assert_array_equal(
        T.dequant(leaf).numpy(),
        np.asarray(J.dequant(J.QLeaf(q=ref, scale=jnp.asarray(scale),
                                     scale_next=jnp.ones_like(scale)))))


def test_float8_conversion_matches_ml_dtypes():
    """float32 -> float8_e4m3fn in torch and in ml_dtypes: round to nearest
    even with subnormals, on every float8 value, every midpoint between two
    neighbours and a million values of every magnitude up to 448."""
    grid = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn).astype(np.float32)
    grid = np.unique(grid[np.isfinite(grid)])
    mids = ((grid[1:].astype(np.float64) + grid[:-1]) / 2).astype(np.float32)
    rand = _wide_range(2, (1_000_000,), clip=448.0)
    for x in (grid, mids, np.nextafter(mids, np.float32(np.inf)),
              np.nextafter(mids, np.float32(-np.inf)), rand):
        ref = x.astype(ml_dtypes.float8_e4m3fn).view(np.int8)
        got = torch.from_numpy(x).to(torch.float8_e4m3fn).view(torch.int8).numpy()
        np.testing.assert_array_equal(got, ref)


# -- the whole update ---------------------------------------------------------------------

def _jax_fp8(mode, **kwargs):
    return optax.inject_hyperparams(
        lambda learning_rate: J.adam_fp8(learning_rate, stochastic_round=mode, **kwargs))(
            learning_rate=1e-3)


def _jax_run(opt, params, grads):
    state = opt.init(params)
    step = jax.jit(lambda p, s, g: (lambda u: (optax.apply_updates(p, u[0]), u[1]))(
        opt.update(g, s, p)))
    for g in grads:
        params, state = step(params, state, g)
    return params, state


def _assert_fp8_close(jleaf, tleaf, label):
    """The bounds on a quantized leaf: scales within 1e-6 relative, q equal in
    at least 99.99% of elements and every other within one e4m3 step."""
    for field in ("scale", "scale_next"):
        np.testing.assert_allclose(getattr(tleaf, field).numpy(),
                                   np.asarray(getattr(jleaf, field)), rtol=1e-6, err_msg=label)
    jq, tq = np.asarray(jleaf.q), tleaf.q.numpy()
    differ = jq != tq
    assert differ.mean() <= 1e-4, (label, int(differ.sum()))
    # adjacent e4m3 values of one sign have adjacent bit patterns
    steps = np.abs(jq[differ].astype(np.int16) - tq[differ].astype(np.int16))
    assert (steps <= 1).all(), (label, steps.max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["none", "nu", "both"])
def test_update_matches_jax_over_five_steps(dtype, mode, monkeypatch):
    # blocks of 97 rows: the blocked update gives the bits of the whole
    monkeypatch.setattr(T, "BLOCK_ELEMS", 97 * 1024)
    rs = np.random.RandomState(0)
    p0 = {k: rs.normal(0, 0.1, s).astype(np.float32) for k, s in SHAPES.items()}
    # step 3 jumps 100x: the lagged scale saturates for a step
    grads = [{k: (rs.normal(0, 1e-2, s) * (1 + 99 * (i == 3))).astype(np.float32)
              for k, s in SHAPES.items()} for i in range(5)]
    jp, state = _jax_run(_jax_fp8(mode), {k: jnp.asarray(v, dtype) for k, v in p0.items()},
                         [{k: jnp.asarray(v, dtype) for k, v in g.items()} for g in grads])
    inner = state.inner_state[0]
    tp = {k: torch.from_numpy(v).to(TDT[dtype]) for k, v in p0.items()}
    opt = T.AdamFp8(tp, 1e-3, stochastic_round=mode)
    for g in grads:
        opt.step([torch.from_numpy(g[k]).to(TDT[dtype]) for k in opt.names])
    assert opt.count == int(inner.count) == 5
    for i, name in enumerate(sorted(SHAPES)):  # JAX's flattened order
        k = opt.names.index(name)
        assert opt.leaf_index[k] == i
        np.testing.assert_allclose(tp[name].float().numpy(),
                                   np.asarray(jp[name]).astype(np.float32), rtol=1e-6, atol=0,
                                   err_msg=name)
        for kind in ("mu", "nu"):
            jleaf, tleaf = getattr(inner, kind)[i], getattr(opt, kind)[k]
            if name == "big":
                assert isinstance(jleaf, J.QLeaf) and isinstance(tleaf, T.QLeaf)
                _assert_fp8_close(jleaf, tleaf, f"{kind}/{name}")
            else:
                assert tleaf.dtype == torch.bfloat16
                np.testing.assert_array_equal(tleaf.float().numpy(),
                                              np.asarray(jleaf).astype(np.float32))


def test_leaf_order_matches_the_flattened_jax_tree():
    """Index i of a port parameter is its leaf's place in
    ``jax.tree_util.tree_flatten`` of the JAX model's parameters, which is
    also the place of its moments in JAX's adam_fp8 state."""
    cfg = tiny_config(image=(64, 64, 3), layers=(8, 16), latent=128)
    cfg["training"]["optimizer"] = "adam_fp8"
    from trustedai_cl_vae_ad_tpu.registry import build_core_from_config
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config

    # the JAX parameters' structure and shapes, traced without computing them
    jparams = jax.eval_shape(build_core_from_config(cfg).init, jax.random.PRNGKey(0))
    tmodel = load_model_from_config(cfg, device="cpu")
    tmodel.compile()
    paths, _ = jax.tree_util.tree_flatten_with_path(jparams)
    flat = ["/".join(str(k.key) for k in path) for path, _leaf in paths]
    opt = tmodel.optimizer
    assert isinstance(opt, T.AdamFp8) and opt.name == "adam_fp8"
    for name, i in zip(opt.names, opt.leaf_index):
        part, _layers, layer, leaf = name.split(".")
        assert flat[i] == f"{part}/{layer}/{'kernel' if leaf == 'weight' else leaf}", name
    assert sorted(opt.leaf_index) == list(range(len(flat)))
    assert flat[0].startswith("decoder/ConvTranspose_") and flat[-1].startswith("encoder/Dense_")
    inner = J.adam_fp8(1e-3).init(jparams)[0]
    # the state's layout: the encoder Dense (4096 -> 256) is the one big leaf
    big = [n for n, m in zip(opt.names, opt.mu) if isinstance(m, T.QLeaf)]
    assert big == ["encoder.layers.Dense_0.weight"]
    leaf = opt.mu[opt.names.index(big[0])]
    jleaf = inner.mu[opt.leaf_index[opt.names.index(big[0])]]
    assert isinstance(jleaf, J.QLeaf)
    assert tuple(leaf.q.shape) == (256, 4096) and tuple(jleaf.q.shape) == (4096, 256)
    assert tuple(leaf.scale.shape) == (1, 4096) and tuple(jleaf.scale.shape) == (4096, 1)
    # the bridge's list is JAX's, leaf by leaf
    for kind in ("mu", "nu"):
        listed = fp8_moments_to_optax(opt.state_dict()[kind])
        for i, (got, ref) in enumerate(zip(listed, getattr(inner, kind))):
            if isinstance(ref, J.QLeaf):
                for f in ("q", "scale", "scale_next"):
                    np.testing.assert_array_equal(got[f], np.asarray(getattr(ref, f)))
            else:
                assert got.shape == ref.shape, i


# -- the cases of tests/test_adam8.py -----------------------------------------------------

BIG = (1100, 1024)  # >= 2**20 elements: the quantized path


def _port_run(opt_kwargs, w0, grads, lr=1e-3):
    params = {"w": torch.from_numpy(np.array(w0, np.float32))}
    opt = T.AdamFp8(params, lr, **opt_kwargs)
    for g in grads:
        opt.step([torch.from_numpy(np.asarray(g, np.float32))])
    return params["w"].numpy(), opt


def test_exact_match_optax_at_f32():
    """With float32 storage the quantization machinery is a no-op: the
    port's adam_fp8 is optax's Adam, as the JAX package's is."""
    rs = np.random.RandomState(0)
    w0 = rs.normal(0, 0.1, (64, 32)).astype(np.float32)
    grads = [rs.normal(0, 0.01, (64, 32)).astype(np.float32) for _ in range(10)]
    ours, opt = _port_run(dict(mu_dtype=torch.float32, nu_dtype=torch.float32,
                               stochastic_round="none"), w0, grads)
    ref, _ = _jax_run(optax.adam(1e-3), {"w": jnp.asarray(w0)}, [{"w": g} for g in grads])
    np.testing.assert_allclose(ours, np.asarray(ref["w"]), rtol=0, atol=1e-7)
    assert opt.mu[0].dtype == torch.float32


def test_state_layout():
    params = {"big": torch.zeros(BIG, dtype=torch.bfloat16),
              "small": torch.zeros((32, 8), dtype=torch.bfloat16),
              "bias": torch.zeros((4096,), dtype=torch.bfloat16)}
    opt = make_optimizer(params, 1e-3, param_dtype=torch.bfloat16, name="adam_fp8")
    by_name = dict(zip(opt.names, opt.mu))
    big = by_name["big"]
    assert isinstance(big, T.QLeaf)
    assert big.q.dtype == torch.int8 and tuple(big.q.shape) == BIG
    # a name of its own: the flax layout, scales one a row over the last axis
    assert tuple(big.scale.shape) == (BIG[0], 1) and big.scale.dtype == torch.float32
    assert tuple(big.scale_next.shape) == (BIG[0], 1)
    assert by_name["small"].dtype == torch.bfloat16
    assert by_name["bias"].dtype == torch.bfloat16
    port = T.AdamFp8({"encoder.layers.Dense_0.weight": torch.zeros(BIG[::-1])}, 1e-3)
    assert tuple(port.mu[0].scale.shape) == (1, BIG[0])  # flax's rows are the port's columns


def _small_big(monkeypatch, shape=(128, 128)):
    """The quantized path at 128x128: the threshold lowered to its size. The
    behaviour under test (each element's EMA through e4m3 storage, one scale
    a row) does not depend on the leaf's size, and 400 steps of a 2**20
    leaf would take a minute on this CPU."""
    monkeypatch.setattr(T, "BIG_LEAF_ELEMS", shape[0] * shape[1])
    return shape


def test_sr_fixes_ema_freeze(monkeypatch):
    """e4m3 round-to-nearest freezes a slow EMA (increments below its ~6%
    resolution round away); stochastic rounding tracks it in expectation."""
    shape = _small_big(monkeypatch)
    w0 = np.zeros(shape, np.float32)
    grads = [np.full(shape, 1e-2, np.float32)] * 400
    target = (1.0 - 0.999 ** len(grads)) * 1e-4  # the EMA of g**2 towards g**2

    def final_nu(mode):
        _, opt = _port_run(dict(stochastic_round=mode), w0, grads)
        assert isinstance(opt.nu[0], T.QLeaf)
        return float(T.dequant(opt.nu[0]).mean())

    nu_sr, nu_rtn = final_nu("both"), final_nu("none")
    assert abs(nu_sr - target) / target < 0.25, (nu_sr, target)
    assert nu_rtn < 0.6 * target, (nu_rtn, target)


def test_sr_cast_is_unbiased_bf16():
    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.uniform(0.5, 2.0, (4096,)).astype(np.float32))
    acc = torch.zeros_like(x)
    gen = torch.Generator().manual_seed(0)
    for _ in range(64):
        noise = torch.randint(-2 ** 31, 2 ** 31, x.shape, dtype=torch.int64,
                              generator=gen).to(torch.int32)
        acc += T._sr_cast(x, torch.bfloat16, noise).float()
    assert float((acc / 64.0 - x).abs().max()) < 0.004


def test_converges_least_squares(monkeypatch):
    """fp8 moments do not break optimization: a least-squares problem ends
    near the loss of float32 Adam."""
    shape = _small_big(monkeypatch)
    rs = np.random.RandomState(3)
    w_true = torch.from_numpy(rs.normal(0, 1, shape).astype(np.float32))

    def run(opt_name):
        w = torch.zeros(shape, requires_grad=True)
        opt = make_optimizer({"w": w}, 5e-2, name=opt_name)
        for _ in range(150):
            loss = ((w - w_true) ** 2).mean()
            (g,) = torch.autograd.grad(loss, [w])
            opt.step([g])
        with torch.no_grad():
            return float(((w - w_true) ** 2).mean())

    ref, ours = run("adam"), run("adam_fp8")
    assert ours < max(2.0 * ref, 1e-3), (ours, ref)


def test_scale_tracks_magnitude_jump(monkeypatch):
    """The lagged per-row scale saturates for one step after a 100x jump of
    the gradient, then adapts: the moments recover instead of staying
    clipped."""
    shape = _small_big(monkeypatch)
    w0 = np.zeros(shape, np.float32)
    seq = [1e-3] * 5 + [1e-1] * 5
    _, opt = _port_run({}, w0, [np.full(shape, g, np.float32) for g in seq])
    m = float(T.dequant(opt.mu[0]).mean())
    expect = 0.0
    for g in seq:
        expect = 0.9 * expect + 0.1 * g
    assert abs(m - expect) / expect < 0.3, (m, expect)


def test_init_scale_buffers_distinct():
    """``scale`` and ``scale_next`` start as distinct buffers with distinct
    values (0 and 1), as in the JAX package."""
    opt = T.AdamFp8({"big": torch.zeros(BIG, dtype=torch.bfloat16)}, 1e-3)
    for leaf in (opt.mu[0], opt.nu[0]):
        assert isinstance(leaf, T.QLeaf)
        assert float((leaf.scale - leaf.scale_next).abs().max()) == 1.0
        assert leaf.scale.data_ptr() != leaf.scale_next.data_ptr()


def test_f32_storage_keeps_dtype_under_stochastic_round():
    """Float32 moment storage with the default stochastic_round='both'
    stays float32 and exact: only a narrow store is dithered."""
    opt = T.AdamFp8({"big": torch.zeros(BIG)}, 1e-3, mu_dtype=torch.float32,
                    nu_dtype=torch.float32)
    assert opt.mu[0].dtype == torch.float32
    opt.step([torch.full(BIG, 1e-3)])
    assert opt.mu[0].dtype == opt.nu[0].dtype == torch.float32
    np.testing.assert_allclose(opt.mu[0].numpy(), np.full(BIG, 0.1 * 1e-3), rtol=1e-6)


def test_bad_stochastic_round_and_missing_gradient_raise():
    with pytest.raises(ValueError, match="stochastic_round"):
        T.AdamFp8({"w": torch.zeros(3)}, 1e-3, stochastic_round="all")
    with pytest.raises(ValueError, match="no gradient"):
        T.AdamFp8({"w": torch.zeros(3)}, 1e-3).step([None])


# -- a tiny model, both packages ----------------------------------------------------------

@pytest.mark.parametrize("precision,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_tiny_model_trains_like_jax(precision, tol):
    """64x64x3, layers [8, 16], latent 128: the encoder Dense is 4096 -> 256 =
    2**20 elements, so its moments are quantized; 3 training steps of each
    package from the same weights, batches and latent noise."""
    cfg = tiny_config(image=(64, 64, 3), layers=(8, 16), latent=128, precision=precision)
    cfg["training"]["optimizer"] = "adam_fp8"
    jmodel, tmodel = paired_models(cfg, seed=4)
    assert isinstance(tmodel.optimizer, T.AdamFp8)
    assert any(isinstance(m, T.QLeaf) for m in tmodel.optimizer.mu)
    rs = np.random.RandomState(6)
    for _ in range(3):
        x = rs.randint(0, 256, (8, 64, 64, 3)).astype(np.uint8)
        eps = next_jax_eps(jmodel, 8)
        jloss = loss_to_np(jmodel.train_step(jnp.asarray(x)))
        tloss = loss_to_np(tmodel.train_step(torch.from_numpy(x), eps=torch.from_numpy(eps)))
        assert list(tloss) == LOSS_KEYS
        for key in LOSS_KEYS:
            np.testing.assert_allclose(tloss[key], jloss[key], rtol=tol, atol=tol, err_msg=key)
    assert tmodel.optimizer.count == int(jmodel.opt_state.inner_state[0].count) == 3


def test_live_and_fleet_continual_learning_reach_adam_fp8(monkeypatch):
    """The live engine's CL step and fleet CL take ``training.optimizer:
    adam_fp8`` through ``make_optimizer``, quantized leaf and learning-rate
    dial included."""
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config
    from trustedai_cl_vae_ad_tpu_torch.stream.capture import SyntheticSource
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import StreamingEngine
    from trustedai_cl_vae_ad_tpu_torch.stream.multicam import MultiCameraEngine

    monkeypatch.setattr(T, "BIG_LEAF_ELEMS", 2048)  # the encoder Dense (768 -> 16) is big
    cfg = tiny_config(latent=8)
    cfg["training"]["optimizer"] = "adam_fp8"
    frames = list(SyntheticSource(width=48, height=32, n_frames=3, motion=0.0, seed=5))
    settings = {"anomaly_score_threshold": 2.0, "anomaly_score_method": "zz_count",
                "buffer_record_period_s": 1.0, "anomalous_state_period_s": 0.05}
    for make in (lambda m: StreamingEngine(m, cfg, continuous_learning_period_ms=0.0),
                 lambda m: MultiCameraEngine(m, cfg, n_streams=2, anomaly_settings=settings,
                                             cl_ring_ticks=2, continuous_learning_period_ms=0.0)):
        model = load_model_from_config(cfg, device="cpu")
        engine = make(model)
        before = {k: v.clone() for k, v in model.params.items()}
        engine.enable_cont_learning = True
        for i, frame in enumerate(frames):
            if isinstance(engine, MultiCameraEngine):
                engine.process_frames([frame, frame], now=1.0 + i)
            else:
                engine.process_frame(frame, now=1.0 + i)
        opt = model.optimizer
        assert isinstance(opt, T.AdamFp8) and opt.count >= 1, type(opt)
        assert isinstance(opt.mu[opt.names.index("encoder.layers.Dense_0.weight")], T.QLeaf)
        assert any(not torch.equal(before[k], v) for k, v in model.params.items())
        engine.set_learning_rate(2.5e-4)
        assert opt.learning_rate == model.learning_rate == 2.5e-4


# -- sharded leaves: regions ---------------------------------------------------------------

def test_hash_bits_of_a_block_along_every_dim():
    """A block that starts at offsets along every dim gets the bits of its
    elements in the whole tensor, in the port's layout too."""
    name = "encoder.layers.Dense_0.weight"
    _, axes = flax_leaf_layout([name])
    whole = T._hash_bits((40, 96), 77, axes[name]).numpy()
    for r0, c0, r, c in ((0, 48, 40, 48), (20, 0, 20, 96), (10, 24, 7, 30)):
        block = T._hash_bits((r, c), 77, axes[name], start=(r0, c0))
        np.testing.assert_array_equal(block.numpy(), whole[r0:r0 + r, c0:c0 + c])
    # an int start is the offset along dim 0
    np.testing.assert_array_equal(T._hash_bits((5, 96), 77, axes[name], start=3).numpy(),
                                  whole[3:8])


@pytest.mark.parametrize("mode", ["none", "nu", "both"])
@pytest.mark.parametrize("dim", [0, 1], ids=["rows", "columns"])
def test_blocks_with_regions_step_like_the_whole(mode, dim, monkeypatch):
    """A Dense weight (out, in) updated as 4 blocks, each an AdamFp8 of its
    own with its Region, gives the whole tensor's bits over 3 steps: along
    the port's dim 1 (flax's rows: ZeRO-1's split) each block owns its slice
    of the scales; along dim 0 (the output features: tensor parallelism's)
    each block's absmax is partial, and the blocks' maximum, which the MAX
    all-reduce of the model group takes, gives the scales. The leaf is
    quantized because the whole tensor is big, though no block is."""
    monkeypatch.setattr(T, "BIG_LEAF_ELEMS", 64 * 48)
    monkeypatch.setattr(T, "BLOCK_ELEMS", 3 * 48)  # blocks of rows inside each block too
    name = "encoder.layers.Dense_0.weight"
    rs = np.random.RandomState(1)
    w = rs.normal(0, 0.1, (64, 48)).astype(np.float32)
    grads = [(rs.normal(0, 1e-2, (64, 48)) * 10.0 ** rs.uniform(-2, 1, (1, 48))
              * (1 + 99 * (i == 1))).astype(np.float32) for i in range(3)]
    whole = {name: torch.from_numpy(w.copy())}
    ref = T.AdamFp8(whole, 1e-3, stochastic_round=mode)
    n, size = 4, w.shape[dim] // 4
    blocks, opts = [], []
    for b in range(n):
        part = torch.from_numpy(np.ascontiguousarray(np.take(w, range(b * size, (b + 1) * size),
                                                             axis=dim)))
        offsets = tuple(b * size if d == dim else 0 for d in range(2))
        region = T.Region((64, 48), offsets, {dim: None})
        blocks.append({name: part})
        opts.append(T.AdamFp8(blocks[-1], 1e-3, stochastic_round=mode, regions={name: region}))
    assert all(isinstance(o.mu[0], T.QLeaf) for o in opts)
    for g in grads:
        ref.step([torch.from_numpy(g)])
        parts = [torch.from_numpy(np.ascontiguousarray(np.take(g, range(b * size, (b + 1) * size),
                                                               axis=dim))) for b in range(n)]
        for o, gb in zip(opts, parts):
            o.step([gb])
        if dim == 0:
            # the model group's MAX of each block's fresh scales, taken here by hand
            for kind in ("mu", "nu"):
                top = torch.stack([getattr(o, kind)[0].scale_next for o in opts]).amax(0)
                for o in opts:
                    getattr(o, kind)[0].scale_next.copy_(top)
    got = torch.cat([b[name] for b in blocks], dim=dim)
    assert torch.equal(got, whole[name])
    for kind in ("mu", "nu"):
        leaf = getattr(ref, kind)[0]
        assert torch.equal(torch.cat([getattr(o, kind)[0].q for o in opts], dim=dim), leaf.q)
        for field in ("scale", "scale_next"):
            parts = [getattr(getattr(o, kind)[0], field) for o in opts]
            got = parts[0] if dim == 0 else torch.cat(parts, dim=1)
            assert torch.equal(got, getattr(leaf, field)), (kind, field)


def test_map_moment_splits_q_and_keeps_scales_whole_along_their_rows():
    """map_moment: a quantized leaf's q follows the split dim; its scales do
    too, except along the dim they reduce over (flax's last axis: the port's
    dim 0 of a Dense weight), where they are whole."""
    name = "encoder.layers.Dense_0.weight"
    leaf = {"q": torch.zeros(8, 6, dtype=torch.int8), "scale": torch.ones(1, 6),
            "scale_next": torch.ones(1, 6)}
    assert T.last_axis_dim(name, 2) == 0 and T.last_axis_dim("w", 2) == 1
    seen = {}
    T.map_moment(leaf, name, 0, lambda t, d: seen.setdefault(tuple(t.shape), d))
    assert seen == {(8, 6): 0, (1, 6): None}
    seen.clear()
    T.map_moment(leaf, name, 1, lambda t, d: seen.setdefault(tuple(t.shape), d))
    assert seen == {(8, 6): 1, (1, 6): 1}
    assert T.map_moment(torch.zeros(3), "encoder.layers.Dense_0.bias", 0,
                        lambda t, d: d) == 0
