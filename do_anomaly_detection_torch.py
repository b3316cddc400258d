#!/usr/bin/env python3
"""Offline anomaly detection of the PyTorch port: reconstruction-error z-scoring.

The counterpart of ``do_anomaly_detection.py`` on
``trustedai_cl_vae_ad_tpu_torch``, with the same flags (-m model dir, -d
evaluation dataset, -o output dir, -t z threshold, --histogram-only,
--quantize, --no-parallel) plus ``--device``:

  python do_anomaly_detection_torch.py -m <logdir> -d <dataset> -o <out>
         [-t 3.0] [--histogram-only] [--quantize] [--device cuda]

Pass 1 scores the model's own training data (its config's data section) and
keeps the error distribution; pass 2 scores the dataset of ``-d`` against it
(``anomaly/offline.py``) and writes the z-score histogram, and unless
``--histogram-only`` the five PNGs of every frame and ``anomaly_list.csv``.
With ``--quantize`` both passes run the ``w8a8`` forward (the int8 GEMM
kernel on the card) on one quantized tree: the ``<logdir>/quantized``
sidecar when it exists (the float weights are then never read), else a
tree quantized once at start. It scores on the CUDA devices unless
``--device cpu`` is given: with more than one local card each batch is split
over all of them, one model replica a card (``anomaly/offline.py``'s mesh),
unless ``--no-parallel`` is given or ``--device`` names one card.
"""

import argparse
import os


def get_args(argv=None):
    from trustedai_cl_vae_ad_tpu_torch.utils.cli import add_device_argument, checked_device

    parser = argparse.ArgumentParser()
    parser.add_argument("--model-dir", "-m", required=True, type=str, help="Model directory")
    parser.add_argument("--dataset-path", "-d", required=True, type=str, help="Dataset directory")
    parser.add_argument("--output-path", "-o", required=True, type=str, help="Output directory")
    parser.add_argument(
        "--anomaly-threshold", "-t", type=float, default=3.0, help="Z-score thresh (default=3.0)"
    )
    parser.add_argument(
        "--histogram-only", action="store_true",
        help="Stop after the z-score histogram (reference behavior)",
    )
    parser.add_argument(
        "--no-parallel", action="store_true",
        help="Score on one device even when several local cards are visible",
    )
    parser.add_argument(
        "--quantize", action="store_true",
        help="int8-quantize the big dense kernels for both scoring passes (ops/quant.py)",
    )
    add_device_argument(parser)
    args = parser.parse_args(argv)
    checked_device(parser, args.device)
    if not os.path.isdir(args.model_dir):
        parser.error(f"--model-dir {args.model_dir} is not a directory")
    if not os.path.isdir(args.dataset_path):
        parser.error(f"--dataset-path {args.dataset_path} is not a directory")
    if os.path.exists(args.output_path) and not os.path.isdir(args.output_path):
        parser.error(f"--output-path {args.output_path} exists and is not a directory")
    os.makedirs(args.output_path, exist_ok=True)
    return args


def main(argv=None):
    args = get_args(argv)

    import torch

    from trustedai_cl_vae_ad_tpu_torch.anomaly.offline import (
        evaluate_anomalies,
        get_data_scale,
        output_anomalies,
    )
    from trustedai_cl_vae_ad_tpu_torch.data.loader import load_data
    from trustedai_cl_vae_ad_tpu_torch.ops.quant import serving_forward
    from trustedai_cl_vae_ad_tpu_torch.parallel.mesh import make_mesh
    from trustedai_cl_vae_ad_tpu_torch.stream.engine import boot_serving_model

    # bulk scoring splits each batch over all local cards (train_torch.py's parity)
    mesh = None
    device = torch.device(args.device)
    if (not args.no_parallel and device.type == "cuda" and device.index is None
            and torch.cuda.device_count() > 1):
        mesh = make_mesh(devices=[torch.device("cuda", i)
                                  for i in range(torch.cuda.device_count())])
        print(f"scoring over {mesh.shape['data']} CUDA devices")
    model, config, score_params = boot_serving_model(
        args.model_dir, args.device, quantize=args.quantize, int8_checkpoint_boot=True,
        restore_optimizer=False)

    # the two passes pair artifacts with frames by index: a deterministic order
    config["data"]["shuffle"] = False
    train_data = load_data(config, device=args.device)
    # one quantized tree, shared by both passes
    if args.quantize and score_params is None:
        _, score_params = serving_forward(model.core, model.params, quantize=True)

    data_scale = get_data_scale(model, config, train_data, mesh=mesh, quantize=args.quantize,
                                score_params=score_params)

    # pass 2 reads the evaluation set with the same dataset kind
    config["data"]["dataset_path"] = args.dataset_path
    evaluation_data = load_data(config, device=args.device)
    anomaly_results = evaluate_anomalies(
        model, config, evaluation_data, data_scale, args.anomaly_threshold,
        keep_maps=False,
        artifact_path=None if args.histogram_only else args.output_path,
        mesh=mesh,
        quantize=args.quantize,
        score_params=score_params,
    )
    output_anomalies(
        evaluation_data, anomaly_results, data_scale, args.output_path,
        args.anomaly_threshold, histogram_only=args.histogram_only,
    )
    return data_scale, anomaly_results


if __name__ == "__main__":
    main()
