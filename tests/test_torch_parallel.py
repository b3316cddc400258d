"""The port's parallel/ against the JAX package's, on the CPU with gloo.

Each multi-rank case runs on 2 or 4 worker processes (tests/torch_dist_worker.py)
joined through a file store in tmp_path; the JAX references run in this process
on its 8 virtual CPU devices. The tiny config is tests/test_parallel.py's
(16x16x3, layers [4], latent 8, batch 16), its weights carried across through
bridge.py.

Tolerances: parameters after a step against the JAX package at rtol 1e-5 / atol
1e-6 (tests/test_parallel.py's own between 1 and 8 devices); gradients of 2
ranks summed against one device's at rtol 1e-5 (an R-times or 1/R-times sum is
off by 50% or more; Adam's first step, which divides each gradient by its own
size, would not show it); a 2-rank step against the port's 1-rank step at rtol
1e-6 (atol 1e-6 for loss terms that are small differences of larger sums, the
skew, and for parameters whose gradient is rounding noise, which Adam divides
by its own size: 1e-3 of a step of lr). ZeRO-1 against the replicated
optimizer: equal bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_dist_worker import run_ranks
from torch_port_helpers import LOSS_KEYS_BY_TYPE
from trustedai_cl_vae_ad_tpu_torch.bridge import params_from_flax, params_to_flax
from trustedai_cl_vae_ad_tpu_torch.parallel.mesh import Mesh

B = 16
TYPES = ["KurtosisGlobal", "KurtosisSingle", "KLGaussian"]


def _config(model_type="KurtosisGlobal", **training):
    """tests/test_parallel.py's config; KLGaussian optimizes its KL term too."""
    return {
        "data": {"image_size": [16, 16, 3]},
        "loss": {"kurtosis": 1.8, "w_kl_divergence": 1e-3 if model_type == "KLGaussian" else 0.0,
                 "w_kurtosis": 1e-4, "w_mse": 1.0, "w_skew": 0.0, "w_z_l1_reg": 1e-3},
        "model": {"type": model_type, "decoder_dense_filters": 4, "latent_dimensions": 8,
                  "layers": [4]},
        "training": dict({"batch_size": B, "beta": 1e-6, "learning_rate": 1e-3,
                          "max_epochs": 1}, **training),
    }


def _jax_core(config, seed=0):
    from trustedai_cl_vae_ad_tpu.registry import build_core_from_config

    core = build_core_from_config(config)
    return core, core.init(jax.random.PRNGKey(seed))


def _batch(n=B, seed=0):
    return np.random.RandomState(seed).random((n, 16, 16, 3)).astype(np.float32)


def _leaves(tree):
    for part in ("encoder", "decoder"):
        for layer, leaves in tree[part].items():
            for leaf, arr in leaves.items():
                yield f"{part}/{layer}/{leaf}", np.asarray(arr)


def _jax_steps(core, params, x, mesh=None):
    """tests/test_parallel.py's step (eval-mode loss), on one device or on
    ``mesh`` with the batch sharded as shard_batch pads it."""
    from trustedai_cl_vae_ad_tpu.models import make_optimizer
    from trustedai_cl_vae_ad_tpu.parallel.mesh import replicate, shard_batch

    optimizer = make_optimizer(1e-3)

    def loss_fn(p, xx):
        return core.compute_loss(p, xx, training=False)["loss"]

    def step(p, o, xx):
        g = jax.grad(loss_fn)(p, xx)
        u, o = optimizer.update(g, o, p)
        return optax.apply_updates(p, u), o

    p = jax.tree_util.tree_map(jnp.copy, params)
    o = optimizer.init(p)
    if mesh is None:
        return jax.jit(step)(p, o, jnp.asarray(x))[0]
    return jax.jit(step)(replicate(p, mesh), replicate(o, mesh), shard_batch(x, mesh))[0]


def _step_case(config, flax_params, x, **kw):
    return dict({"kind": "step", "config": config, "state": params_from_flax(
        jax.device_get(flax_params)), "x": torch.from_numpy(x), "steps": 1}, **kw)


@pytest.mark.parametrize("model_type", TYPES)
def test_dp_matches_single_device(model_type, tmp_path):
    """One 2-rank step (eval-mode loss: zero latent noise) equals the JAX
    package's step on one device and on its 8-device mesh; the summed
    gradients equal one device's; the gathered z is every rank's z in rank
    order, and its moments (the kernel's plain version here) are one device's
    bit for bit."""
    from trustedai_cl_vae_ad_tpu.parallel.mesh import make_mesh
    from trustedai_cl_vae_ad_tpu_torch.ops.moments import global_moments_packed

    config = _config(model_type)
    core, params = _jax_core(config)
    x = _batch()
    one = dict(_leaves(jax.device_get(_jax_steps(core, params, x))))
    eight = dict(_leaves(jax.device_get(_jax_steps(core, params, x, make_mesh()))))
    r0, r1 = run_ranks(_step_case(config, params, x, eps=torch.zeros(B, 8)), 2, tmp_path)
    got = dict(_leaves(params_to_flax(r0["params"])))
    assert set(got) == set(one)
    for name, ref in one.items():
        np.testing.assert_allclose(got[name], ref, rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got[name], eight[name], rtol=1e-5, atol=1e-6, err_msg=name)
    for name, g in r0["grads"].items():
        np.testing.assert_allclose(g.numpy(), r0["single"]["grads"][name].numpy(), rtol=1e-5,
                                   atol=1e-5 * float(g.abs().max()), err_msg=name)
    # every rank's rows, in rank order, make the global batch again
    assert torch.equal(r0["global_batch"], torch.from_numpy(x))
    assert torch.equal(r1["global_batch"], torch.from_numpy(x))
    assert list(r0["losses"][0]) == LOSS_KEYS_BY_TYPE[model_type]
    assert r0["losses"] == r1["losses"]  # every rank computes the global loss
    zc0, zc1 = r0["z_check"], r1["z_check"]
    assert torch.equal(zc0["z_all"], torch.cat([zc0["z_local"], zc1["z_local"]]))
    assert torch.equal(zc0["moments"], global_moments_packed(zc0["z_all"]))
    assert torch.equal(zc0["moments"], zc1["moments"])


@pytest.mark.parametrize("model_type", TYPES)
def test_training_step_matches_one_rank(model_type, tmp_path):
    """With training=True and no injected noise, 2 ranks draw the global
    batch's latent eps from the shared seeded generator and each keeps its
    rows: two steps equal the port's 1-rank steps of the same batch and seed."""
    config = _config(model_type)
    _, params = _jax_core(config, seed=3)
    r0, _ = run_ranks(_step_case(config, params, _batch(seed=1), steps=2, seed=7), 2, tmp_path)
    single = r0["single"]
    for got, want in zip(r0["losses"], single["losses"]):
        assert list(got) == list(want)
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    for name, p in r0["params"].items():
        np.testing.assert_allclose(p.numpy(), single["params"][name].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    for name, g in r0["grads"].items():
        ref = single["grads"][name]
        np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()), err_msg=name)


@pytest.mark.parametrize("model_type", TYPES)
def test_weighted_loss_over_ranks_matches_one_rank(model_type, tmp_path):
    """The masked loss (the live engine's replay weights, some rows 0) over 2
    ranks: wsum, n_el and the weighted sums are the global batch's, the
    weights are gathered with z for the latent terms, and the loss dict,
    the summed gradients and the step equal one device's."""
    config = _config(model_type)
    config["loss"].update(w_skew=1e-3, w_kl_divergence=1e-3)
    _, params = _jax_core(config, seed=4)
    weights = torch.ones(B)
    weights[[2, 3, 11]] = 0.0
    weights[5] = 0.5
    r0, _ = run_ranks(_step_case(config, params, _batch(seed=6), eps=torch.zeros(B, 8),
                                 weights=weights), 2, tmp_path)
    single = r0["single"]
    for k, v in r0["losses"][0].items():
        np.testing.assert_allclose(v, single["losses"][0][k], rtol=1e-5, atol=1e-6, err_msg=k)
    for name, g in r0["grads"].items():
        ref = single["grads"][name]
        np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()), err_msg=name)
    for name, p in r0["params"].items():
        np.testing.assert_allclose(p.numpy(), single["params"][name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_ragged_batch_pads_and_warns(tmp_path, capsys):
    """A batch of 15 on 2 ranks is padded to 16 by repeating the last frame,
    with the JAX package's one-time warning; the step equals the JAX step on
    the same padded batch (its 8-device mesh pads 15 to 16 alike)."""
    from trustedai_cl_vae_ad_tpu.parallel import mesh as jax_mesh

    config = _config()
    core, params = _jax_core(config)
    x = _batch(15)
    jax_mesh._pad_warned = False
    ref = dict(_leaves(jax.device_get(_jax_steps(core, params, x, jax_mesh.make_mesh()))))
    jax_said = [line for line in capsys.readouterr().out.splitlines() if "padding" in line]
    r0, r1 = run_ranks(_step_case(config, params, x, eps=torch.zeros(16, 8), single=False), 2,
                       tmp_path)
    for r in (r0, r1):
        said = [line for line in r["stdout"].splitlines() if "padding" in line]
        assert said == [jax_said[0].replace("data=8", "data=2")], (said, jax_said)
    got = dict(_leaves(params_to_flax(r0["params"])))
    for name, want in ref.items():
        np.testing.assert_allclose(got[name], want, rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("optimizer,stochastic", [("adam", False), ("adam_lean", False),
                                                  ("adam_lean", True)])
def test_zero1_matches_replicated(optimizer, stochastic, tmp_path):
    """ZeRO-1 (every eligible moment sharded: min_elems 1) gives the bits of
    the replicated update over 2 steps, with adam_lean's stochastic rounding
    of nu too; each rank holds half the sharded moments' bytes."""
    config = _config(optimizer=optimizer)
    _, params = _jax_core(config, seed=21)
    case = _step_case(config, params, _batch(seed=1), steps=2, min_elems=1, single=False,
                      also_replicated=True, stochastic_round_nu=stochastic)
    r0, r1 = run_ranks(case, 2, tmp_path)
    rep = r0["replicated"]
    assert any(d is not None for d in r0["zero1_dims"].values())
    for name, p in r0["params"].items():
        assert torch.equal(p, rep["params"][name]), name
    for kind in ("mu", "nu"):
        for name, m in r0["opt"][kind].items():
            assert m.dtype == rep["opt"][kind][name].dtype
            assert torch.equal(m, rep["opt"][kind][name]), (kind, name)
    assert r0["opt"]["count"] == rep["opt"]["count"] == 2
    assert r0["losses"] == rep["losses"] == r1["losses"]
    sharded = sum(rep["opt"]["mu"][k].numel() * rep["opt"]["mu"][k].element_size()
                  for k, d in r0["zero1_dims"].items() if d is not None)
    assert rep["moment_bytes"] - r0["moment_bytes"] == sharded // 2


FP8_SHAPES = {"encoder.layers.Dense_0.weight": (48, 64), "encoder.layers.Dense_0.bias": (48,),
              "decoder.layers.Dense_0.weight": (64, 40), "decoder.layers.Dense_0.bias": (64,),
              "encoder.layers.Conv_0.weight": (8, 3, 3, 3)}
FP8_MODES = ["none", "nu", "both"]
# both Dense weights quantized (>= 1024 elements), updated in blocks of a few rows
FP8_LIMITS = {"big_leaf_elems": 1024, "block_elems": 5 * 64}


def _fp8_case(n_model, zero1, steps=3, lr=1e-3):
    rs = np.random.RandomState(9)
    params = {k: torch.from_numpy(rs.normal(0, 0.1, s).astype(np.float32))
              for k, s in FP8_SHAPES.items()}
    # rows and columns of very different magnitudes, so that the per-row scales
    # differ; step 1 jumps 100x, so that the lagged scale saturates for a step
    grads = [{k: torch.from_numpy((rs.normal(0, 1e-2, s) * 10.0 ** rs.uniform(-2, 1, s[-1:])
                                   * (1 + 99 * (i == 1))).astype(np.float32))
              for k, s in FP8_SHAPES.items()} for i in range(steps)]
    return dict({"kind": "fp8", "params": params, "grads": grads, "lr": lr, "modes": FP8_MODES,
                 "n_model": n_model, "zero1": zero1}, **FP8_LIMITS)


def _fp8_replicated(case, mode, monkeypatch):
    from trustedai_cl_vae_ad_tpu_torch.ops import adam8

    monkeypatch.setattr(adam8, "BIG_LEAF_ELEMS", case["big_leaf_elems"])
    monkeypatch.setattr(adam8, "BLOCK_ELEMS", case["block_elems"])
    params = {k: v.clone() for k, v in case["params"].items()}
    opt = adam8.AdamFp8(params, case["lr"], stochastic_round=mode)
    for grads in case["grads"]:
        opt.step([grads[k] for k in opt.names])
    return params, opt


def _assert_fp8_equal_replicated(got, case, mode, monkeypatch):
    """One mode's whole state from the ranks equals the replicated AdamFp8's bits."""
    from trustedai_cl_vae_ad_tpu_torch.ops.adam8 import QLeaf

    params, opt = _fp8_replicated(case, mode, monkeypatch)
    assert got["count"] == opt.count == len(case["grads"])
    for name, p in params.items():
        assert torch.equal(got["params"][name], p), (mode, name)
    quantized = 0
    for kind in ("mu", "nu"):
        for name, ref in zip(opt.names, getattr(opt, kind)):
            mine = got[kind][name]
            if isinstance(ref, QLeaf):
                quantized += 1
                for field in QLeaf._fields:
                    assert torch.equal(mine[field], getattr(ref, field)), (mode, kind, name, field)
            else:
                assert mine.dtype == ref.dtype and torch.equal(mine, ref), (mode, kind, name)
    assert quantized == 4  # both Dense weights' mu and nu
    return opt


def test_zero1_refuses_adam_fp8(tmp_path, monkeypatch):
    """ZeRO-1 no longer refuses adam_fp8: over 2 gloo ranks, with every
    eligible moment sharded, 3 steps from the same gradients give the bits of
    the replicated AdamFp8 step in every stochastic_round mode (q, scale,
    scale_next, the bfloat16 moments and the parameters): the dither hash
    takes each element's index in the whole tensor, and a block of whole flax
    rows owns its slice of the scales, with no collective. Each rank holds
    half the sharded moments' bytes."""
    case = _fp8_case(n_model=1, zero1=True)
    r0, r1 = run_ranks(case, 2, tmp_path)
    for mode in FP8_MODES:
        got = r0[mode]
        assert got["zero1_dims"]["encoder.layers.Dense_0.weight"] == 1  # flax's dim 0
        assert got["zero1_dims"]["decoder.layers.Dense_0.weight"] == 1
        assert got["max_reductions"] == r1[mode]["max_reductions"] == []
        opt = _assert_fp8_equal_replicated(got, case, mode, monkeypatch)
        for name in opt.names:  # both ranks gather the same whole state
            assert torch.equal(r1[mode]["params"][name], got["params"][name]), name
        sharded = 0
        for kind in ("mu", "nu"):
            for name, m in zip(opt.names, getattr(opt, kind)):
                if got["zero1_dims"][name] is not None:
                    sharded += sum(t.numel() * t.element_size()
                                   for t in (m if isinstance(m, tuple) else (m,)))
        whole = sum(t.numel() * t.element_size() for m in opt.mu + opt.nu
                    for t in (m if isinstance(m, tuple) else (m,)))
        assert whole - got["moment_bytes"] == sharded // 2


@pytest.mark.parametrize("world,n_model,zero1", [(2, 2, False), (4, 2, True)],
                         ids=["model2", "data2_model2"])
def test_adam_fp8_on_a_model_axis_matches_replicated(world, n_model, zero1, tmp_path,
                                                     monkeypatch):
    """adam_fp8 with the Dense weights split along their output features over
    a model axis (alone, and composed with ZeRO-1 on a (2, 2) mesh): 3 steps
    give the replicated bits in every mode. The rows' absmax of each block is
    partial; it is all-reduced with MAX over the model group once per leaf and
    step (both moments in one collective), not once per block of rows."""
    case = _fp8_case(n_model=n_model, zero1=zero1)
    results = run_ranks(case, world, tmp_path)
    for mode in FP8_MODES:
        got = results[0][mode]
        assert got["tp_dims"]["encoder.layers.Dense_0.weight"] == 0
        assert got["tp_dims"]["decoder.layers.Dense_0.weight"] == 0
        if zero1:
            assert got["zero1_dims"]["encoder.layers.Dense_0.weight"] == 1
        # one MAX a split quantized leaf and step, of mu's and nu's fresh scales
        # together (ZeRO-1 holds half of each scale row)
        cols = [64 // (2 if zero1 else 1), 40 // (2 if zero1 else 1)]
        want = sorted([(2, 1, c) for c in cols] * len(case["grads"]))
        for r in results:
            assert sorted(r[mode]["max_reductions"]) == want, r[mode]["max_reductions"]
        _assert_fp8_equal_replicated(got, case, mode, monkeypatch)
        for r in results[1:]:
            for name, p in got["params"].items():
                assert torch.equal(r[mode]["params"][name], p), name


def test_adam_fp8_trains_on_data2_model2(tmp_path):
    """The tiny model with training.optimizer adam_fp8 (its Dense weights
    quantized) on a (2, 2) mesh with ZeRO-1 and the Dense layers split: the
    ranks' losses agree and equal one device's within 1e-6, and the
    parameters after one step are one device's (Adam's first step moves an
    entry by +-lr; the order of the gradient's sums may flip a sign where the
    gradient is rounding noise)."""
    config = _config(optimizer="adam_fp8")
    config["model"]["encoder_dense_filters"] = 12
    _, params = _jax_core(config)
    x = _batch(8, seed=1)
    case = dict(_step_case(config, params, x, eps=torch.zeros(8, 8), n_model=2, min_params=1,
                           min_elems=1), big_leaf_elems=64)
    results = run_ranks(case, 4, tmp_path)
    r0 = results[0]
    assert all(r["losses"] == r0["losses"] for r in results)
    for k, v in r0["losses"][0].items():
        np.testing.assert_allclose(v, r0["single"]["losses"][0][k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert r0["tp_shapes"]["encoder.layers.Dense_0.weight"] == (6, 256)
    mu = r0["opt"]["mu"]["encoder.layers.Dense_0.weight"]
    assert isinstance(mu, dict) and tuple(mu["q"].shape) == (12, 256)  # gathered whole
    assert tuple(mu["scale"].shape) == (1, 256)
    single = r0["single"]
    assert isinstance(single["opt"]["mu"]["encoder.layers.Dense_0.weight"], dict)
    lr = config["training"]["learning_rate"]
    for name, p in r0["params"].items():
        diff = (p - single["params"][name]).abs()
        assert float(diff.max()) <= 2.01 * lr, name
        assert float((diff <= 1e-6 + 1e-5 * single["params"][name].abs()).float().mean()) > 0.99


def _jax_fp8_logdir(logdir, config, seed=4):
    """A log directory the JAX package writes after 2 adam_fp8 steps (the
    second quantizes with the first's scale), its learning rate dialled."""
    import os

    import yaml

    from trustedai_cl_vae_ad_tpu.models.wrapper import VAEModel
    from trustedai_cl_vae_ad_tpu.registry import build_core_from_config

    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "config.yml"), "w") as f:
        yaml.safe_dump(config, f)
    model = VAEModel(build_core_from_config(config), seed=seed)
    model.compile()
    rs = np.random.RandomState(seed)
    for _ in range(2):
        model.train_step(rs.randint(0, 256, (8, 64, 64, 3)).astype(np.uint8))
    model.set_learning_rate(2.5e-4)
    model.save_model(logdir)
    return model


@pytest.mark.parametrize("n_model,zero1", [(1, True), (2, False)], ids=["zero1", "model2"])
def test_adam_fp8_logdir_onto_a_mesh(n_model, zero1, tmp_path):
    """The JAX package's adam_fp8 tree (one quantized leaf, the encoder Dense
    4096 -> 256) restores onto a ZeRO-1 or a model-axis mesh of 2 ranks: the
    state gathered whole is the JAX state bit for bit. A step of the global
    batch gives one device's loss, and the mesh's save (gathered to rank 0,
    mu/<key>/q|scale|scale_next in the full layout) restores alone to the
    ranks' state bit for bit."""
    import os
    import shutil

    from torch_port_helpers import next_jax_eps, tiny_config
    from trustedai_cl_vae_ad_tpu.ops.adam8 import QLeaf as JaxQLeaf
    from trustedai_cl_vae_ad_tpu_torch.bridge import fp8_moments_to_optax
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory

    config = tiny_config(image=(64, 64, 3), layers=(8, 16), latent=128)
    config["training"]["optimizer"] = "adam_fp8"
    logdir, save_dir = str(tmp_path / "jax"), str(tmp_path / "saved")
    jmodel = _jax_fp8_logdir(logdir, config)
    x = np.random.RandomState(11).randint(0, 256, (8, 64, 64, 3)).astype(np.uint8)
    eps = torch.from_numpy(next_jax_eps(jmodel, 8))
    (tmp_path / "ranks").mkdir()
    results = run_ranks({"kind": "fp8_logdir", "logdir": logdir, "zero1": zero1,
                         "n_model": n_model, "x": torch.from_numpy(x), "eps": eps, "steps": 1,
                         "save_dir": save_dir}, 2, tmp_path / "ranks", timeout=300.0)
    r0 = results[0]
    assert r0["optimizer"] == ("Zero1" if zero1 else "AdamFp8")
    if n_model == 2:
        assert r0["tp_shapes"]["encoder.layers.Dense_0.weight"] == (128, 4096)
    inner = jax.device_get(jmodel.opt_state).inner_state[0]
    placed = r0["placed"]["opt"]
    assert placed["count"] == int(inner.count) == 2
    for kind in ("mu", "nu"):
        listed = fp8_moments_to_optax(placed[kind])
        for i, (got, ref) in enumerate(zip(listed, getattr(inner, kind), strict=True)):
            if isinstance(ref, JaxQLeaf):
                for field in ("q", "scale", "scale_next"):
                    np.testing.assert_array_equal(got[field], np.asarray(getattr(ref, field)),
                                                  err_msg=f"{kind}/{i}/{field}")
            else:
                np.testing.assert_array_equal(got, np.asarray(ref).astype(np.float32))
    alone, _ = load_model_from_directory(logdir, device="cpu", restore_optimizer=True)
    want = alone.train_step(torch.from_numpy(x), eps=eps)
    for r in results:
        for k, v in r["losses"][0].items():
            np.testing.assert_allclose(v, float(want[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    shutil.copy(os.path.join(logdir, "config.yml"), save_dir)
    resumed, _ = load_model_from_directory(save_dir, device="cpu", restore_optimizer=True)
    stepped = r0["stepped"]
    for name, p in resumed.params.items():
        assert torch.equal(p, stepped["params"][name]), name
    state = resumed.optimizer.state_dict()
    assert state["count"] == stepped["opt"]["count"] == 3
    for kind in ("mu", "nu"):
        for name, m in state[kind].items():
            ref = stepped["opt"][kind][name]
            pairs = [(m[f], ref[f]) for f in m] if isinstance(m, dict) else [(m, ref)]
            assert all(torch.equal(a, b) for a, b in pairs), (kind, name)


@pytest.mark.parametrize("n_data,n_model,min_params,min_elems",
                         [(4, 2, 1, 1), (8, 1, 1, 1), (2, 4, 200, 100), (4, 2, 1 << 20, 2 ** 16)])
def test_shard_choice_matches_jax(n_data, n_model, min_params, min_elems):
    """The leaves the port splits over the model axis (tp) and shards over the
    data axis (ZeRO-1, composed with tp) are the JAX package's choice on the
    same tree, with the thresholds overridden."""
    from trustedai_cl_vae_ad_tpu.parallel.mesh import make_mesh
    from trustedai_cl_vae_ad_tpu.parallel.tp import param_shardings as jax_tp
    from trustedai_cl_vae_ad_tpu.parallel.zero import zero1_shardings
    from trustedai_cl_vae_ad_tpu_torch.bridge import _flax_path
    from trustedai_cl_vae_ad_tpu_torch.parallel.tp import param_shardings
    from trustedai_cl_vae_ad_tpu_torch.parallel.zero import zero1_dims

    config = _config()
    config["model"]["encoder_dense_filters"] = 12
    core, params = _jax_core(config)
    mesh = make_mesh(n_data=n_data, n_model=n_model)
    tp_specs = jax_tp(params, mesh, min_params=min_params)
    placed = jax.device_put(params, tp_specs)
    moments = zero1_shardings(optax.adam(1e-3).init(placed)[0].mu, mesh, min_elems=min_elems)

    port = params_from_flax(jax.device_get(params))
    tp_dims = param_shardings(port, Mesh(n_data, n_model, ["cpu"]), min_params)
    blocks = {k: (v[:v.shape[0] // n_model] if tp_dims[k] is not None else v)
              for k, v in port.items()}
    z_dims = zero1_dims(blocks, Mesh(n_data, n_model, ["cpu"]), min_elems, tp_dims)
    for name in port:
        (part, layer, leaf), perm = _flax_path(name)
        want_tp = tuple(tp_specs[part][layer][leaf].spec)
        assert (tp_dims[name] is not None) == ("model" in want_tp), name
        spec = tuple(moments[part][layer][leaf].spec)
        want_data = "data" in spec
        assert (z_dims[name] is not None) == want_data, (name, spec, z_dims[name])
        if want_data:  # the same axis: flax's dim 0 is the port's dim perm.index(0)
            assert spec[0] == "data" and z_dims[name] == (perm.index(0) if perm else 0)
    assert any(d is not None for d in tp_dims.values()) == (n_model > 1 and min_params < 1 << 20)


def test_zero1_composes_with_tp(tmp_path):
    """dp x tp x ZeRO-1 on one (2, 2) mesh of 4 ranks: the Dense weights split
    over the model axis, their moments sharded over the data axis too; one
    step equals one device's (the port's and the JAX package's)."""
    config = _config()
    config["model"]["encoder_dense_filters"] = 12
    core, params = _jax_core(config)
    x = _batch(8, seed=1)
    ref = dict(_leaves(jax.device_get(_jax_steps(core, params, x))))
    case = _step_case(config, params, x, eps=torch.zeros(8, 8), n_model=2, min_params=1,
                      min_elems=1)
    results = run_ranks(case, 4, tmp_path)
    r0 = results[0]
    assert r0["tp_shapes"]["encoder.layers.Dense_0.weight"] == (6, 256)
    assert r0["tp_shapes"]["decoder.layers.Dense_0.weight"] == (128, 8)
    assert r0["zero1_dims"]["encoder.layers.Dense_0.weight"] == 1
    assert all(r["losses"] == r0["losses"] for r in results)
    # the two ranks of a model group compute the replicated gradients alike before
    # the model axis averages them (a wrong backward of the split layers' input
    # would give each its own)
    for a, b in ((0, 1), (2, 3)):
        own = results[a]["own_grads"]
        assert own and set(own) == set(results[b]["own_grads"])
        for name, g in own.items():
            assert torch.equal(g, results[b]["own_grads"][name]), name
    got = dict(_leaves(params_to_flax(r0["params"])))
    single = r0["single"]["params"]
    for name, want in ref.items():
        np.testing.assert_allclose(got[name], want, rtol=1e-5, atol=1e-6, err_msg=name)
    for name, p in r0["params"].items():
        np.testing.assert_allclose(p.numpy(), single[name].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    for name, g in r0["grads"].items():
        ref_g = r0["single"]["grads"][name]
        np.testing.assert_allclose(g.numpy(), ref_g.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(ref_g.abs().max()), err_msg=name)
    for kind in ("mu", "nu"):
        for name, m in r0["opt"][kind].items():
            ref_m = r0["single"]["opt"][kind][name].numpy()
            np.testing.assert_allclose(m.numpy(), ref_m, rtol=1e-4,
                                       atol=1e-5 * float(np.abs(ref_m).max()), err_msg=name)


def test_wrapper_compile_on_mesh_and_place_on_mesh(tmp_path):
    """The stateful model on a mesh of 2 ranks through its public surface.
    compile(mesh=) with training.zero1 and train_step of the global batch take
    the 1-rank steps (training.loss_chunks is ignored with a warning); a model
    trained alone then placed on the mesh keeps its parameters and moments bit
    for bit (with ZeRO-1 its moments land in their shards; without, it keeps
    its optimizer) and trains on."""
    config = _config(zero1=True, loss_chunks=2)
    config["data"]["image_size"] = [32, 32, 3]  # Dense moments of 2**16 elements or more
    config["model"]["latent_dimensions"] = 64
    _, params = _jax_core(config, seed=5)
    x = torch.from_numpy(np.random.RandomState(2).random((B, 32, 32, 3)).astype(np.float32))
    state = params_from_flax(jax.device_get(params))
    r0, r1 = run_ranks({"kind": "wrapper", "config": config, "state": state, "x": x,
                        "steps": 2}, 2, tmp_path)
    assert r0["optimizer"] == "Zero1" and r0["losses"] == r1["losses"]
    # training.loss_chunks has no data-parallel form: the JAX package's warning, once
    assert r0["stdout"].count("training.loss_chunks is not supported on the data-parallel") == 1
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config

    alone = load_model_from_config(config, seed=0, device="cpu")
    alone.core.load_state_dict(state)
    alone.compile()
    want = [alone.train_step(x) for _ in range(2)]
    for got, ref in zip(r0["losses"], want):
        for k in got:
            np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    for name, p in r0["final"]["params"].items():
        np.testing.assert_allclose(p.numpy(), alone.params[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    ev = alone.test_step(x)
    for k, v in r0["eval"].items():
        np.testing.assert_allclose(v, float(ev[k]), rtol=1e-5, atol=1e-6, err_msg=k)

    for zero1, optimizer in ((True, "Zero1"), (False, "Adam")):
        config["training"]["zero1"] = zero1
        (tmp_path / f"resume_{zero1}").mkdir()
        r0, _ = run_ranks({"kind": "wrapper", "config": config, "state": state, "x": x,
                           "steps": 1, "resume": True}, 2, tmp_path / f"resume_{zero1}")
        before, after = r0["before"], r0["after"]
        assert r0["optimizer"] == optimizer and r0["kept_optimizer"] is not zero1
        for name, p in before["params"].items():
            assert torch.equal(after["params"][name], p), name
        for kind in ("mu", "nu"):
            for name, m in before["opt"][kind].items():
                assert torch.equal(after["opt"][kind][name], m), (kind, name)
        assert after["opt"]["count"] == before["count"] == 1
        assert r0["final"]["opt"]["count"] == 2 and np.isfinite(r0["losses"][0]["loss"])
