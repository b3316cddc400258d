"""One rank of the port's multi-process CPU tests (tests/test_torch_parallel.py).

Run as ``python tests/torch_dist_worker.py <rank> <world> <directory>``: joins
a gloo group through a file store in the directory, reads the case from
``<directory>/case.pt`` (written by ``run_ranks`` below, in the test process),
and writes what it measured to ``<directory>/out_<rank>.pt``. Imports torch and
the port only; the tests compare the results with the JAX package.

Cases (``case["kind"]``):
  * ``step``: ``steps`` data-parallel steps of the tiny model from the given
    weights on a (world / n_model, n_model) mesh, the Dense layers split over
    the model axis from ``min_params`` elements, the moments ZeRO-1-sharded
    from ``min_elems`` (None: replicated); with ``eps`` (global rows) or the
    generator's global draw. Returns the first step's loss dict and summed
    gradients, and the final parameters and moments gathered whole; with
    ``weights`` (global rows) the masked loss of the live engine. Rank 0
    also takes the same steps on one device, without a mesh (``single``);
    ``also_replicated`` also runs the replicated optimizer from the same start.
  * ``wrapper``: the stateful model through its public surface:
    ``compile(mesh=...)`` and ``train_step`` of the global batch, or a model
    trained one step alone, then ``place_on_mesh`` (``resume``).
  * ``fp8``: ``adam_fp8`` alone on a (world / n_model, n_model) mesh, the
    Dense weights split over the model axis and the moments ZeRO-1-sharded
    (``zero1``), stepped from the same whole gradients on every rank, once
    for each ``stochastic_round`` mode: the state after the steps gathered
    whole, and the MAX collectives of the scales counted.
  * ``fp8_logdir``: a log directory (``adam_fp8``) restored alone, then
    placed on a mesh (``training.zero1`` from ``zero1``): the state gathered
    whole; then ``steps`` training steps of the global batch and a save of
    the mesh's state into ``save_dir`` (rank 0 writes).

``big_leaf_elems`` / ``block_elems`` in a case lower ``ops/adam8.py``'s
thresholds, so that a tiny model's leaves take the quantized, blocked path.
"""

import os
import subprocess
import sys

import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(case: dict, world: int, directory, timeout: float = 120.0) -> list:
    """Run ``case`` on ``world`` worker processes (this file) and return each
    rank's results; the workers are killed if they outlive ``timeout``."""
    directory = str(directory)
    torch.save(case, os.path.join(directory, "case.pt"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world),
                               directory], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env, cwd=REPO)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            assert p.returncode == 0, out[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = [torch.load(os.path.join(directory, f"out_{r}.pt"), weights_only=False)
               for r in range(world)]
    for r, out in zip(results, outs):
        r["stdout"] = out
    return results


def _floats(loss):
    return {k: float(v) for k, v in loss.items()}


def _model(case):
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_config

    model = load_model_from_config(case["config"], seed=case.get("seed", 0), device="cpu")
    model.core.load_state_dict(case["state"])
    return model


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _whole_state(model):
    """The state gathered whole (copies: on the CPU the gather hands out the
    live tensors of what is not sharded)."""
    params, opt_state = model._gathered_state(include_optimizer=True)
    return {"params": _clone(params), "opt": _clone(opt_state)}


def _single(case):
    """The same steps on one device, without a mesh."""
    model = _model(case)
    model.compile()
    if case.get("stochastic_round_nu"):
        model.optimizer.stochastic_round_nu = True
    losses, grads = [], None
    for _ in range(case["steps"]):
        x = case["x"]
        if grads is None:
            loss_dict, _ = model.core.compute_loss(
                x, training=True, return_inf=True, eps=case.get("eps"),
                generator=model.generator, weights=case.get("weights"))
            grads = [g.detach().clone() for g in
                     torch.autograd.grad(loss_dict["loss"], model.optimizer.params)]
            model.generator.manual_seed(case.get("seed", 0))
        loss, _ = model.train_step_and_run(x, eps=case.get("eps"), weights=case.get("weights"))
        losses.append(_floats(loss))
    return {"losses": losses, "grads": dict(zip(model.optimizer.names, grads)),
            "params": {k: v.detach().clone() for k, v in model.params.items()},
            "opt": model.optimizer.state_dict()}


def _steps(case, mesh, zero1_min_elems):
    from trustedai_cl_vae_ad_tpu_torch.ops.adam import make_optimizer
    from trustedai_cl_vae_ad_tpu_torch.parallel import dp, tp, zero
    from trustedai_cl_vae_ad_tpu_torch.parallel.mesh import global_batch_from_local, shard_batch

    model = _model(case)
    model.mesh = mesh
    model.tp_dims = tp.shard_model(model.core, mesh, case.get("min_params", 1 << 20))
    named = dict(model.core.named_parameters())
    name = case["config"]["training"].get("optimizer")
    lr = case["config"]["training"]["learning_rate"]
    if zero1_min_elems is None:
        model.optimizer = make_optimizer(named, lr, name=name, generator=model.generator,
                                         stochastic_round_nu=case.get("stochastic_round_nu",
                                                                      False))
    else:
        model.optimizer = zero.Zero1(named, lr, mesh, name=name, generator=model.generator,
                                     stochastic_round_nu=case.get("stochastic_round_nu", False),
                                     min_elems=zero1_min_elems, tp_dims=model.tp_dims)
    (x,) = shard_batch(case["x"], mesh)
    eps, weights = (None if case.get(k) is None else shard_batch(case[k], mesh)[0]
                    for k in ("eps", "weights"))
    losses, grads, z_check = [], None, None
    for _ in range(case["steps"]):
        split = [model.tp_dims.get(k) is not None for k in model.optimizer.names]
        loss, x_hat, g = dp.loss_and_grads(model.core, model.optimizer.params, x, mesh,
                                           model.generator, eps, weights)
        if grads is None:
            # this rank's own gradients of the replicated parameters, before the
            # model axis averages them
            own = {k: t.clone() for k, t, s in zip(model.optimizer.names, g, split) if not s}
        dp.average_replicated(g, mesh, split)
        if grads is None:
            grads = {k: tp.full_tensor(t, model.tp_dims.get(k), mesh)
                     for k, t in zip(model.optimizer.names, g)}
            z_check = _moments_check(model, x, mesh)
        model.optimizer.step(g)
        losses.append(_floats(loss))
    out = _whole_state(model)
    out.update(losses=losses, grads=grads, own_grads=own, z_check=z_check,
               global_batch=global_batch_from_local(x, mesh),
               tp_shapes={k: tuple(v.shape) for k, v in model.core.state_dict().items()},
               zero1_dims=getattr(model.optimizer, "dims", None),
               moment_bytes=_moment_bytes(model.optimizer.inner if zero1_min_elems is not None
                                          else model.optimizer))
    return out


def _moment_bytes(optimizer):
    from trustedai_cl_vae_ad_tpu_torch.ops.adam8 import QLeaf

    return sum(t.numel() * t.element_size() for m in optimizer.mu
               for t in (m if isinstance(m, QLeaf) else (m,)))


def _fp8(case, mesh):
    """adam_fp8 from injected whole gradients on this rank's blocks, each mode in turn."""
    from trustedai_cl_vae_ad_tpu_torch.ops.adam import make_optimizer
    from trustedai_cl_vae_ad_tpu_torch.ops.adam8 import map_moment
    from trustedai_cl_vae_ad_tpu_torch.parallel import tp, zero

    reductions = []
    all_reduce = dist.all_reduce

    def counted(t, op=dist.ReduceOp.SUM, group=None, async_op=False):
        if op == dist.ReduceOp.MAX:
            reductions.append(tuple(t.shape))
        return all_reduce(t, op=op, group=group, async_op=async_op)

    dist.all_reduce = counted
    out = {}
    try:
        for mode in case["modes"]:
            whole = {k: v.clone() for k, v in case["params"].items()}
            tp_dims = tp.param_shardings(whole, mesh, min_params=1)
            params = {k: tp.shard_tensor(v, tp_dims[k], mesh).clone() for k, v in whole.items()}
            if case["zero1"]:
                opt = zero.Zero1(params, case["lr"], mesh, name="adam_fp8", min_elems=1,
                                 tp_dims=tp_dims)
                opt.inner.stochastic_round = mode
            else:
                opt = make_optimizer(params, case["lr"], name="adam_fp8",
                                     regions=zero.block_regions(params, mesh, tp_dims))
                opt.stochastic_round = mode
            del reductions[:]
            for grads in case["grads"]:
                opt.step([tp.shard_tensor(grads[k], tp_dims[k], mesh) for k in opt.names])

            def gathered(t, dim):
                return tp.full_tensor(t, dim, mesh).clone()

            out[mode] = {
                "params": {k: gathered(p, tp_dims[k]) for k, p in params.items()},
                "max_reductions": list(reductions), "count": opt.count,
                "moment_bytes": opt.moment_bytes() if case["zero1"] else _moment_bytes(opt),
                "tp_dims": tp_dims, "zero1_dims": getattr(opt, "dims", None),
                **{kind: {k: map_moment(opt.full_moment(kind, k), k, tp_dims[k], gathered)
                          for k in opt.names} for kind in ("mu", "nu")}}
    finally:
        dist.all_reduce = all_reduce
    return out


def _fp8_logdir(case):
    from trustedai_cl_vae_ad_tpu_torch.parallel.mesh import make_mesh
    from trustedai_cl_vae_ad_tpu_torch.registry import load_model_from_directory

    model, config = load_model_from_directory(case["logdir"], device="cpu",
                                              restore_optimizer=True)
    model.config["training"]["zero1"] = case["zero1"]
    model.place_on_mesh(make_mesh(n_model=case.get("n_model", 1)))
    out = {"placed": _whole_state(model), "optimizer": type(model.optimizer).__name__,
           "tp_shapes": {k: tuple(v.shape) for k, v in model.core.state_dict().items()}}
    out["losses"] = [_floats(model.train_step(case["x"], eps=case["eps"]))
                     for _ in range(case["steps"])]
    out["stepped"] = _whole_state(model)
    model.save_model(case["save_dir"])
    return out


def _moments_check(model, x, mesh):
    """The gathered z of this step and the moments of the loss's path on it."""
    from trustedai_cl_vae_ad_tpu_torch.ops.moments import global_moments_packed
    from trustedai_cl_vae_ad_tpu_torch.parallel.collectives import gather_rows

    with torch.no_grad():
        _, z, _, _ = model.core.call_detailed(x)
        z_all = gather_rows(z, mesh.data_group)
        return {"z_local": z, "z_all": z_all, "moments": global_moments_packed(z_all)}


def _wrapper(case):
    from trustedai_cl_vae_ad_tpu_torch.parallel.mesh import make_mesh

    model = _model(case)
    out = {}
    if case.get("resume"):
        model.compile()
        model.train_step(case["x"])
        out["before"] = {"params": {k: v.clone() for k, v in model.params.items()},
                         "opt": {kind: {k: v.clone() for k, v in
                                        model.optimizer.state_dict()[kind].items()}
                                 for kind in ("mu", "nu")},
                         "count": model.optimizer.count}
        optimizer = model.optimizer
        model.place_on_mesh(make_mesh())
        out["after"] = _whole_state(model)
        out["kept_optimizer"] = model.optimizer is optimizer
    else:
        model.compile(mesh=make_mesh())
    losses = [_floats(model.train_step(case["x"]))
              for _ in range(case["steps"])]
    out.update(losses=losses, eval=_floats(model.test_step(case["x"])),
               final=_whole_state(model), optimizer=type(model.optimizer).__name__)
    return out


def main(rank: int, world: int, directory: str) -> None:
    torch.set_num_threads(1)
    case = torch.load(os.path.join(directory, "case.pt"), weights_only=False)
    from trustedai_cl_vae_ad_tpu_torch.ops import adam8
    from trustedai_cl_vae_ad_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    adam8.BIG_LEAF_ELEMS = case.get("big_leaf_elems", adam8.BIG_LEAF_ELEMS)
    adam8.BLOCK_ELEMS = case.get("block_elems", adam8.BLOCK_ELEMS)

    initialize_distributed(f"file://{os.path.join(directory, 'store')}", world, rank,
                           device="cpu")
    initialize_distributed(f"file://{os.path.join(directory, 'store')}", world, rank,
                           device="cpu")  # a second call is harmless
    if case["kind"] == "step":
        mesh = make_mesh(n_model=case.get("n_model", 1))
        out = _steps(case, mesh, case.get("min_elems"))
        if case.get("also_replicated"):
            out["replicated"] = _steps(case, make_mesh(n_model=case.get("n_model", 1)), None)
        if rank == 0 and case.get("single", True):
            out["single"] = _single(case)
    elif case["kind"] == "fp8":
        out = _fp8(case, make_mesh(n_model=case.get("n_model", 1)))
    elif case["kind"] == "fp8_logdir":
        out = _fp8_logdir(case)
    else:
        out = _wrapper(case)
    dist.barrier()
    torch.save(out, os.path.join(directory, f"out_{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
