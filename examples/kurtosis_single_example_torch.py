#!/usr/bin/env python3
"""Gradient descent of the per-dimension moment losses on a raw tensor.

The counterpart of ``examples/kurtosis_single_example.py`` on
``trustedai_cl_vae_ad_tpu_torch``: checks that the kurtosis / skew / mean
regularizer combination is optimizable before it goes into the VAE. The
loss, mean((kurt - t)^2) + sqrt(sum(mean^2)) + mean(skew^2) of x plus 1e-5
of noise, runs through ``ops/moments.py::perdim_moments``, and its gradient
through that op's analytic backward: the hand-written kernels' forward and
backward on a CUDA tensor, their plain versions on a CPU tensor. The
initial x and each step's noise come from one seeded ``torch.Generator``
on the device.

Usage: python examples/kurtosis_single_example_torch.py [-l 32] [-b 16] [-n 200]
       [--learning-rate 1e-4] [-t 3.0] [--gaussian-init] [-o out.png] [--device cuda]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def loss_fn(x, noise, target: float):
    """(loss, (min, max, mean kurtosis, mean loss, skew loss)) of x + 1e-5 noise."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops.moments import perdim_moments

    eps = x + 1e-5 * noise
    meu, _var, skew, kurtosis = perdim_moments(eps)
    kurtosis_mean = torch.mean((kurtosis - target) ** 2)
    skew_mean = torch.mean(skew ** 2)
    mean_loss = torch.sqrt(torch.sum(meu ** 2))
    aux = (torch.min(kurtosis), torch.max(kurtosis), torch.mean(kurtosis), mean_loss, skew_mean)
    return kurtosis_mean + mean_loss + skew_mean, aux


def value_and_grad(x, noise, target: float):
    """(loss, aux, d loss / dx) at x, without graph."""
    import torch

    x = x.detach().requires_grad_(True)
    loss, aux = loss_fn(x, noise, target)
    (grad,) = torch.autograd.grad(loss, x)
    return loss.detach(), tuple(a.detach() for a in aux), grad


def main(argv=None):
    """Run the descent and draw the final columns' histograms; returns {'x0',
    'noise0', 'grad0': the first step's inputs and gradient, 'x': the final x}
    (device tensors)."""
    from trustedai_cl_vae_ad_tpu_torch.utils.cli import add_device_argument, checked_device

    parser = argparse.ArgumentParser()
    parser.add_argument("--latent-variables", "-l", type=int, default=32)
    parser.add_argument("--batch-size", "-b", type=int, default=16)
    parser.add_argument("--num-steps", "-n", type=int, default=200)
    parser.add_argument("--learning-rate", type=float, default=1e-4)
    parser.add_argument("--target-kurtosis", "-t", type=float, default=3.0)
    parser.add_argument("--gaussian-init", action="store_true")
    parser.add_argument("--output", "-o", type=str, default="kurtosis_single_example.png")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = checked_device(parser, args.device)

    import torch

    from trustedai_cl_vae_ad_tpu_torch.viz.plots import histogram

    gen = torch.Generator(device=device).manual_seed(0)
    shape = (args.batch_size, args.latent_variables)
    if args.gaussian_init:
        centers = 2.0 * torch.randn(args.latent_variables, generator=gen, device=device)
        x = centers[None, :] + torch.randn(shape, generator=gen, device=device)
    else:
        x = torch.rand(shape, generator=gen, device=device)

    target = args.target_kurtosis
    first = None
    for epoch in range(args.num_steps):
        noise = torch.randn(shape, generator=gen, device=device)
        loss, (kmin, kmax, kmean, mean_loss, skew_mean), grad = value_and_grad(x, noise, target)
        if first is None:
            first = {"x0": x, "noise0": noise, "grad0": grad}
        x = x - args.learning_rate * grad
        if epoch % 20 == 0 or epoch == args.num_steps - 1:
            print(
                f"Epoch: {epoch}, Min Kurtosis: {float(kmin):0.6f}, Max Kurtosis: "
                f"{float(kmax):0.6f}, Mean Kurtosis: {float(kmean):0.6f}, Mean: "
                f"{float(mean_loss):0.6f}, Skew: {float(skew_mean):0.6f} Loss: {float(loss):0.6f}"
            )

    x_np = x.cpu().numpy()
    histogram(args.output, {str(idx): x_np[:, idx] for idx in range(x_np.shape[1])},
              f"Kurtosis Target: {target}, # Lat. Var.: {args.latent_variables}, "
              f"Batch Size: {args.batch_size}",
              density=True, alpha=0.35, legend=False, xlabel="Latent Value", ylabel="Density")
    print(f"final histograms -> {args.output}")
    return dict(first or {}, x=x)


if __name__ == "__main__":
    main()
