#!/usr/bin/env python3
"""Bounds of the TPU kernels' counterparts on one H100.

For every row of PERF.md's kernel table (rows 1-11, all ported: the JAX
package's kernels 1-3 and the archived Pallas probes under ``benchmarks/``)
this prints the least time an H100 could take for the same work at the shapes
the main path and ``chip_smoke.py`` use: the larger of the bytes moved once
(each input read once, each output written once) over the card's memory rate
and the operations over the card's peak rate for their type. Nothing runs on
a device: the numbers follow from the shapes and NVIDIA's data sheet (H100 SXM:
3.35 TB/s, 989 TFLOP/s bf16 dense, 1,979 TOP/s int8 dense, 67 TFLOP/s float32
outside the tensor cores). Rows 1-3 count the bytes and operations that
``chip_smoke.py`` counts for them (row 1 at one frame and at a tick of 16
cameras of the flagship's 224x300x3); row 10 also at the shapes of the two
quantized Dense layers of the serving path (1 and 16 frames) and of the
offline scoring path (a batch of 256); rows 4, 6 and 9
also at the flagship's two dense shapes and rows 4 and 6 in the port's own
(out, in) layout of the encoder Dense.

Usage: python3 kernel_bounds_torch.py [--json]
"""

import argparse
import json

HBM_BYTES_PER_S = 3.35e12
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}

# the reduced encoder-dense shape of benchmarks/r11_diag.py:48, and the full
# one of benchmarks/r11_kernel.py (the flagship's encoder Dense at batch 768)
K, M, N = 768, 12800, 4000
M_FULL = 268800
DEC = (768, 2000, 134400)  # the flagship's decoder Dense at batch 768
BF16 = 2
PORTED = set(range(1, 12))


def stream_score(k, h, w, c):
    """ops/stream_score.py: img, rec read; maps, scalars read and written; norm and [score,
    count] written; about 3 operations a channel and 30 a pixel (as chip_smoke.py counts)."""
    return 4 * k * (2 * h * w * c + 2 * 2 * h * w + 2 * 6 + h * w + 2), k * h * w * (3 * c + 30)


def moments(n, cols, backward):
    """ops/moments.py: z (n, cols) f32 read and the 4 x cols moments written, about 10
    operations an element; backward: z, the moments and their gradients read, the gradient
    written, about 14 an element (as chip_smoke.py counts)."""
    if backward:
        return 2 * 4 * n * cols + 2 * 4 * 4 * cols, 14 * n * cols
    return 4 * n * cols + 4 * 4 * cols, 10 * n * cols


def fused(k, m, n):
    """x (k, m), dz (k, n) read; w, mu, nu (m, n) read and written; 2 k m n operations."""
    return BF16 * (k * m + k * n + 6 * m * n), 2 * k * m * n


def dot_only(k, m, n):
    """x (k, m), dz (k, n) read, g (m, n) written; 2 k m n operations."""
    return BF16 * (k * m + k * n + m * n), 2 * k * m * n


def epilogue(m, n):
    """g, w, mu, nu read, w, mu, nu written; about 12 operations an element."""
    return BF16 * 7 * m * n, 12 * m * n


def conv_dw(batch, h, w, ci, co):
    """benchmarks/r18_conv_dw.py kernel_only: x and dy in bf16, dW in f32."""
    oh, ow = h // 2, w // 2
    nbytes = BF16 * batch * (h * w * ci + oh * ow * co) + 4 * 9 * ci * co
    return nbytes, 2 * batch * oh * ow * 9 * ci * co


def int8_gemm(m, k, n):
    """benchmarks/r4_int8_gemm.py: x (m, k) and w (k, n) int8 read, (m, n) int32 written."""
    return m * k + k * n + 4 * m * n, 2 * m * k * n


def rows():
    mn = M * N
    cw1, cw2 = conv_dw(768, 224, 300, 3, 32), conv_dw(768, 112, 150, 32, 64)
    return [
        # (row, kernel, shapes, bytes, operations, type of the operations)
        (1, "ops/stream_score.py:98 _stream_kernel", "K=1 224x300x3 f32",
         *stream_score(1, 224, 300, 3), "f32"),
        (1, "the same, a tick of 16 cameras", "K=16 224x300x3 f32",
         *stream_score(16, 224, 300, 3), "f32"),
        (2, "ops/moments.py:77 _global_kernel forward", "z (256, 2000) f32",
         *moments(256 * 2000, 1, False), "f32"),
        (2, "ops/moments.py:174 _global_bwd", "z (256, 2000) f32",
         *moments(256 * 2000, 1, True), "f32"),
        (3, "ops/moments.py:98 _perdim_kernel forward", "z (256, 2000) f32",
         *moments(256, 2000, False), "f32"),
        (3, "ops/moments.py:210 _perdim_bwd", "z (256, 2000) f32",
         *moments(256, 2000, True), "f32"),
        (4, "r11_kernel.py:84 _kernel, enc", f"K={K} M={M_FULL} N={N} bf16",
         *fused(K, M_FULL, N), "bf16"),
        (4, "the same, dec", "K={} M={} N={} bf16".format(*DEC), *fused(*DEC), "bf16"),
        (4, "the same, enc as the port stores it", f"K={K} M={N} N={M_FULL} bf16",
         *fused(K, N, M_FULL), "bf16"),
        (4, "the same at the diag shape", f"K={K} M={M} N={N} bf16", *fused(K, M, N), "bf16"),
        (5, "r11_diag.py:132 fused_xt", f"K={K} M={M} N={N} bf16", *fused(K, M, N), "bf16"),
        (6, "r11_diag.py:163 dot_only", f"K={K} M={M} N={N} bf16",
         *dot_only(K, M, N), "bf16"),
        (6, "the same on the flagship's encoder Dense", f"K={K} M={M_FULL} N={N} bf16",
         *dot_only(K, M_FULL, N), "bf16"),
        (6, "the same on the flagship's decoder Dense", "K={} M={} N={} bf16".format(*DEC),
         *dot_only(*DEC), "bf16"),
        (6, "the same, enc as the port stores it", f"K={K} M={N} N={M_FULL} bf16",
         *dot_only(K, N, M_FULL), "bf16"),
        (7, "r11_diag.py:183 copy_only", f"3x ({M}, {N}) bf16",
         BF16 * 6 * mn, 0, "bf16"),
        (8, "r11_diag.py:207 epi_bf16", f"4x ({M}, {N}) bf16", *epilogue(M, N), "f32"),
        (9, "r11_diag.py:238 epi_only", f"4x ({M}, {N}) bf16, f32 arithmetic",
         *epilogue(M, N), "f32"),
        (9, "the same on the flagship's encoder Dense", f"4x ({M_FULL}, {N}) bf16",
         *epilogue(M_FULL, N), "f32"),
        (9, "the same on the flagship's decoder Dense", "4x ({}, {}) bf16".format(*DEC[1:]),
         *epilogue(*DEC[1:]), "f32"),
        (10, "r4_int8_gemm.py:45 kernel", "M=32 K=268800 N=4096 int8 -> int32",
         *int8_gemm(32, 268800, 4096), "int8"),
        (10, "the same on the serving path, encoder Dense", "M=16 K=268800 N=4000",
         *int8_gemm(16, 268800, 4000), "int8"),
        (10, "the same on the serving path, encoder Dense", "M=1 K=268800 N=4000",
         *int8_gemm(1, 268800, 4000), "int8"),
        (10, "the same on the serving path, decoder Dense", "M=16 K=2000 N=134400",
         *int8_gemm(16, 2000, 134400), "int8"),
        (10, "the same on the serving path, decoder Dense", "M=1 K=2000 N=134400",
         *int8_gemm(1, 2000, 134400), "int8"),
        (10, "the same on the offline path, encoder Dense", "M=256 K=268800 N=4000",
         *int8_gemm(256, 268800, 4000), "int8"),
        (10, "the same on the offline path, decoder Dense", "M=256 K=2000 N=134400",
         *int8_gemm(256, 2000, 134400), "int8"),
        (11, "r18_conv_dw.py:53 _dw_kernel, conv1", "x (768, 224, 300, 3), dy (768, 112, 150, 32)",
         cw1[0], cw1[1], "bf16"),
        (11, "r18_conv_dw.py:53 _dw_kernel, conv2", "x (768, 112, 150, 32), dy (768, 56, 75, 64)",
         cw2[0], cw2[1], "bf16"),
    ]


def bounds():
    out = []
    for row, kernel, shapes, nbytes, ops, kind in rows():
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = ops / PEAK[kind] * 1e3
        out.append({"row": row, "ported": row in PORTED, "kernel": kernel, "shapes": shapes,
                    "bytes": nbytes,
                    "operations": ops, "bytes_ms": by_bytes, "operations_ms": by_ops,
                    "bound_ms": max(by_bytes, by_ops),
                    "bound_by": "bytes" if by_bytes >= by_ops else "operations"})
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)
    table = bounds()
    if args.json:
        print(json.dumps(table))
        return 0
    for r in table:
        print(f"{r['row']:>2} {'ported ' if r['ported'] else 'to port'} {r['kernel']:<42} "
              f"{r['shapes']:<46} {r['bytes'] / 1e6:10.1f} MB "
              f"{r['operations'] / 1e9:9.2f} Gop  bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
