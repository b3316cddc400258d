#!/usr/bin/env python3
"""Moment statistics of known distributions through the per-dimension moments kernel.

The counterpart of ``examples/kurtosis_example.py`` on
``trustedai_cl_vae_ad_tpu_torch``: samples a distribution on the host from a
seeded ``np.random.RandomState``, computes each column's mean, variance,
skew and kurtosis with ``ops/moments.py::perdim_moments`` on the device (the
hand-written kernel on a CUDA tensor, the plain version on a CPU tensor; the
same op the KurtosisSingle loss trains against), and holds them against each
distribution's analytic values.

Analytic targets (kurtosis E[z^4], the convention the losses use): uniform
9/5, normal 3, gamma(k) 3 + 6/k, exponential 9.

Usage: python examples/kurtosis_example_torch.py [-n 10000] [-d 32]
       [--distribution uniform|normal|gamma|exponential] [-o hist.png] [--device cuda]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# distribution -> (sampler, analytic skew, analytic kurtosis)
GAMMA_K = 255.0
DISTRIBUTIONS = {
    "uniform": (lambda rng, n, d: rng.uniform(0.0, 1.0, (n, d)), 0.0, 9 / 5),
    "normal": (lambda rng, n, d: rng.normal(0.0, 1.0, (n, d)), 0.0, 3.0),
    "gamma": (lambda rng, n, d: rng.gamma(GAMMA_K, 0.25, (n, d)),
              2 / np.sqrt(GAMMA_K), 3 + 6 / GAMMA_K),
    "exponential": (lambda rng, n, d: rng.exponential(1.0, (n, d)), 2.0, 9.0),
}


def main(argv=None):
    """Print the table and draw the figure; returns {'x': the samples, 'moments':
    (mean, var, skew, kurtosis) as host arrays}."""
    from trustedai_cl_vae_ad_tpu_torch.utils.cli import add_device_argument, checked_device

    parser = argparse.ArgumentParser()
    parser.add_argument("--num-samples", "-n", type=int, default=10_000)
    parser.add_argument("--dimensions", "-d", type=int, default=32)
    parser.add_argument("--distribution", choices=sorted(DISTRIBUTIONS),
                        default="uniform")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output", "-o", type=str, default="kurtosis_example.png")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = checked_device(parser, args.device)
    assert args.num_samples > 1 and args.dimensions > 0

    import torch

    from trustedai_cl_vae_ad_tpu_torch.ops.moments import perdim_moments
    from trustedai_cl_vae_ad_tpu_torch.viz.plots import bar_panel, histogram_panel, panels

    sampler, want_skew, want_kurt = DISTRIBUTIONS[args.distribution]
    x = sampler(np.random.RandomState(args.seed),
                args.num_samples, args.dimensions).astype(np.float32)

    # one launch gives all four moments of every column
    mean, var, skew, kurt = (m.cpu().numpy()
                             for m in perdim_moments(torch.from_numpy(x).to(device)))

    header = f"{args.distribution}, N={args.num_samples}, d={args.dimensions}"
    print(header)
    print(f"{'moment':<10}{'min':>12}{'median':>12}{'max':>12}{'analytic':>12}")
    for name, vals, want in [("mean", mean, None), ("var", var, None),
                             ("skew", skew, want_skew),
                             ("kurtosis", kurt, want_kurt)]:
        tgt = f"{want:12.4f}" if want is not None else " " * 12
        print(f"{name:<10}{vals.min():12.4f}{np.median(vals):12.4f}"
              f"{vals.max():12.4f}{tgt}")
    # the kurtosis estimator's sampling error shrinks as 1/sqrt(N): 10k samples land
    # within a few per cent of the analytic value
    spread = abs(np.median(kurt) - want_kurt) / want_kurt
    print(f"kurtosis median within {100 * spread:.1f}% of analytic "
          f"{want_kurt:.3f} — this is the statistic the KurtosisSingle loss "
          f"drives toward config['loss']['kurtosis'] (uniform target 1.8)")

    panels([
        histogram_panel({str(i): x[:, i] for i in range(min(x.shape[1], 64))},
                        f"per-dim sample histograms ({header})", alpha=0.2, legend=False),
        bar_panel(kurt, "per-dim kurtosis vs analytic", hline=want_kurt,
                  hline_label=f"analytic {want_kurt:.2f}"),
    ], args.output, cols=2)
    print(f"figure -> {args.output}")
    return {"x": x, "moments": (mean, var, skew, kurt)}


if __name__ == "__main__":
    main()
