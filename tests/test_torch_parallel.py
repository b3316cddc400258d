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


def test_zero1_refuses_adam_fp8():
    """adam_fp8's per-row scales cross the shards: ZeRO-1 raises, naming the
    ROADMAP item that takes it."""
    from trustedai_cl_vae_ad_tpu_torch.parallel.zero import Zero1

    p = {"encoder.layers.Dense_0.weight": torch.zeros(4, 4)}
    with pytest.raises(NotImplementedError, match="queue 1 item 20"):
        Zero1(p, 1e-3, Mesh(2, 1, ["cpu"]), name="adam_fp8")


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
