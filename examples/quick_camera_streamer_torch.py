#!/usr/bin/env python3
"""Minimal stream viewer: open a source, report frame statistics (PyTorch port's package).

The counterpart of ``examples/quick_camera_streamer.py`` on
``trustedai_cl_vae_ad_tpu_torch.stream.capture``. Headless: prints each
frame's shape and mean and optionally dumps the frames as PNGs.

Usage: python examples/quick_camera_streamer_torch.py [synthetic | <index> | <file> | <url>]
       [-n 30] [-o <dump_dir>]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    """Returns the number of frames read."""
    parser = argparse.ArgumentParser()
    parser.add_argument("source", type=str, nargs="?", default="synthetic",
                        help="'synthetic', webcam index, video file, or rtsp:// URL")
    parser.add_argument("--max-frames", "-n", type=int, default=30)
    parser.add_argument("--dump-dir", "-o", type=str, default=None)
    args = parser.parse_args(argv)

    from trustedai_cl_vae_ad_tpu_torch.stream.capture import make_source

    source = make_source(args.source)
    if args.dump_dir:
        os.makedirs(args.dump_dir, exist_ok=True)

    t0 = time.perf_counter()
    n = 0
    for frame in source:
        print(f"frame {n}: shape={frame.shape} mean={frame.mean():.1f}")
        if args.dump_dir:
            from PIL import Image

            Image.fromarray(frame).save(os.path.join(args.dump_dir, f"{n:05d}.png"))
        n += 1
        if n >= args.max_frames:
            break
    source.release()
    dt = time.perf_counter() - t0
    print(f"{n} frames in {dt:.2f}s ({n / dt:.1f} fps)")
    return n


if __name__ == "__main__":
    main()
