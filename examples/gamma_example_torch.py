#!/usr/bin/env python3
"""Empirical-CDF demo on Gamma samples (PyTorch port's package).

The counterpart of ``examples/gamma_example.py`` on
``trustedai_cl_vae_ad_tpu_torch.anomaly.cdf`` (numpy only, as there): a
CDFObject over Gamma draws, value <-> probability lookups, and the timing of
1000 resets.

Usage: python examples/gamma_example_torch.py [-a 2.0] [-b 4.0] [-n 10000]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    from trustedai_cl_vae_ad_tpu_torch.anomaly.cdf import CDFObject, benchmark_reset

    parser = argparse.ArgumentParser()
    parser.add_argument("--alpha", "-a", type=float, default=2.0, help="Gamma(Alpha, beta)")
    parser.add_argument("--beta", "-b", type=float, default=4.0, help="Gamma(alpha, Beta)")
    parser.add_argument("--num-samples", "-n", type=int, default=10000)
    args = parser.parse_args(argv)

    x = np.random.gamma(shape=args.alpha, scale=1.0 / args.beta, size=(args.num_samples,))
    cdf = CDFObject(x)
    print(f"Hist Sum: {np.sum(cdf.hist)}")
    print(f"Mean: {cdf.meu}")

    print("Get Probability from Value")
    for a in np.linspace(0.0, 3.0, 30):
        print(f" - {a:0.03f}: {cdf.get_prob_by_value(a):0.03f}")
    print("Get Value from Probability")
    for p in np.linspace(0.0, 1.0, 10):
        print(f" - {p:0.03f}: {cdf.get_value_by_prob(p):0.03f}")
    print(f"95%: {cdf.get_value_by_prob(0.95)}")

    return cdf, benchmark_reset(n=args.num_samples, alpha=args.alpha, beta=args.beta)


if __name__ == "__main__":
    main()
