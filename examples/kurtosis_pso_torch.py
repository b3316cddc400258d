#!/usr/bin/env python3
"""Particle-swarm search for sample sets that match a target kurtosis.

The counterpart of ``examples/kurtosis_pso.py`` on
``trustedai_cl_vae_ad_tpu_torch``: finds a (batch, dims) tensor whose
per-dimension kurtosis matches the target (1.8 ~ uniform, 3.0 ~ normal, 6.0
~ Laplace). The whole swarm is one (P, B, D) device tensor. Its fitness is
ONE launch of the per-dimension moments kernel: the moments run per column,
so the swarm laid side by side as (B, P*D) gives every particle's D columns
at once. The PSO update is tensor code drawing from one seeded
``torch.Generator``; nothing leaves the device but the printed lines.

Usage: python examples/kurtosis_pso_torch.py [-p 64] [-b 64] [-d 8] [-t 1.8] [-n 300]
       [-o kurtosis_pso.png] [--device cuda]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def swarm_fitness(pos, target: float):
    """(P,) fitness of a (P, B, D) swarm, lower is better: each particle's
    mean over its columns of (kurt - target)^2 + skew^2 + mean^2."""
    from trustedai_cl_vae_ad_tpu_torch.ops.moments import perdim_moments_packed

    P, B, D = pos.shape
    flat = pos.permute(1, 0, 2).reshape(B, P * D)
    meu, _var, skew, kurt = perdim_moments_packed(flat.contiguous()).view(4, P, D)
    return ((kurt - target) ** 2).mean(dim=1) + (skew ** 2).mean(dim=1) + (meu ** 2).mean(dim=1)


def main(argv=None):
    """Run the search and draw the best member's histograms; returns {'pos0':
    the initial swarm, 'gbest': the best member (B, D), 'gbest_fit'} (device
    tensors)."""
    from trustedai_cl_vae_ad_tpu_torch.utils.cli import add_device_argument, checked_device

    parser = argparse.ArgumentParser()
    parser.add_argument("--num-particles", "-p", type=int, default=64)
    parser.add_argument("--batch-size", "-b", type=int, default=64)
    parser.add_argument("--dims", "-d", type=int, default=8)
    parser.add_argument("--target-kurtosis", "-t", type=float, default=1.8)
    parser.add_argument("--num-steps", "-n", type=int, default=300)
    parser.add_argument("--inertia", type=float, default=0.72)
    parser.add_argument("--cognitive", type=float, default=1.49)
    parser.add_argument("--social", type=float, default=1.49)
    parser.add_argument("--output", "-o", type=str, default="kurtosis_pso.png")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = checked_device(parser, args.device)

    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops.moments import perdim_moments_packed
    from trustedai_cl_vae_ad_tpu_torch.viz.plots import histogram

    target = args.target_kurtosis
    P, B, D = args.num_particles, args.batch_size, args.dims
    w, c1, c2 = args.inertia, args.cognitive, args.social
    gen = torch.Generator(device=device).manual_seed(0)
    pos = torch.randn((P, B, D), generator=gen, device=device)
    vel = 0.1 * torch.randn((P, B, D), generator=gen, device=device)
    pos0 = pos.clone()

    best_pos, best_fit = pos, swarm_fitness(pos, target)
    gbest_idx = torch.argmin(best_fit).view(1)
    gbest_pos, gbest_fit = best_pos.index_select(0, gbest_idx)[0], best_fit[gbest_idx][0]
    for step in range(args.num_steps):
        r1 = torch.rand(pos.shape, generator=gen, device=device)
        r2 = torch.rand(pos.shape, generator=gen, device=device)
        vel = w * vel + c1 * r1 * (best_pos - pos) + c2 * r2 * (gbest_pos[None] - pos)
        pos = pos + vel
        fit = swarm_fitness(pos, target)
        improved = fit < best_fit
        best_pos = torch.where(improved[:, None, None], pos, best_pos)
        best_fit = torch.where(improved, fit, best_fit)
        idx = torch.argmin(best_fit).view(1)
        new_gbest_fit = best_fit.index_select(0, idx)[0]
        better = new_gbest_fit < gbest_fit
        gbest_pos = torch.where(better, best_pos.index_select(0, idx)[0], gbest_pos)
        gbest_fit = torch.where(better, new_gbest_fit, gbest_fit)
        if step % 25 == 0 or step == args.num_steps - 1:
            print(f"step {step}: global best fitness = {float(gbest_fit):.6f}")

    _, _, skew, kurt = perdim_moments_packed(gbest_pos.contiguous()).cpu().numpy()
    print(f"target kurtosis: {target}")
    print(f"achieved per-dim kurtosis: {kurt.round(3)}")
    print(f"achieved per-dim skew: {skew.round(3)}")

    gbest = gbest_pos.cpu().numpy()
    histogram(args.output, {str(idx): gbest[:, idx] for idx in range(gbest.shape[1])},
              f"PSO best swarm member: target kurtosis {target}",
              density=True, alpha=0.35, legend=False, xlabel="Value", ylabel="Density")
    print(f"histograms -> {args.output}")
    return {"pos0": pos0, "gbest": gbest_pos, "gbest_fit": gbest_fit}


if __name__ == "__main__":
    main()
