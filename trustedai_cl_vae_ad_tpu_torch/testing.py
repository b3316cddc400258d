"""Parity fixtures and checks shared by the tests and ``chip_smoke.py``: the
stream scorer's, then the training step's, then the dense-update kernels',
and at the end writers of the reference's TF log directories.

One place states the inputs and the tolerances with which an implementation
of the stream-scorer update (the CUDA kernel, the plain PyTorch version, the
JAX package's functions) is held against a reference:

  * maps, scalars and the norm map: rtol 1e-5, atol 1e-6. The per-pixel
    steps round identically; only the frame-wide sums (mean and std of z)
    are taken in another order.
  * count: within 2. ``zz > 3`` is a hard threshold, and a rounding-level
    change of the z mean or std flips pixels that sit on it.
  * score: rtol 1e-4, and NaN exactly where the reference is NaN, on every
    frame up to the first one whose counts differ (the count EMAs carry
    every earlier count into the score). On a fresh state's first frame
    err - EMA(err) is 0 or one rounding step, so z there is rounding noise:
    two implementations that round one product differently can count 0 and
    1 pixels, and score NaN (0/0) and the cap sqrt(alpha/(1 - alpha)).
"""

from __future__ import annotations

import functools
import os
import struct
from typing import Callable, List, Sequence, Tuple

import numpy as np

MAP_RTOL, MAP_ATOL = 1e-5, 1e-6
COUNT_TOL = 2
SCORE_RTOL = 1e-4

# one scorer update on numpy inputs: (state, img, rec, alpha) ->
# (state, maps, scalars, norm, score, count) with the last five as numpy
StepFn = Callable[[object, np.ndarray, np.ndarray, float], Tuple]


STARTS = ("constant", "seeding", "converged")


def score_sequence(h: int, w: int, c: int, n_frames: int = 8, seed: int = 0,
                   start: str = "seeding"):
    """(imgs, recs, maps0, scalars0): a static scene with per-frame pixel
    noise (sigma 0.05) against a fixed reconstruction, float32 in [0, 1],
    and the scorer state to start from.

    ``start``:
      * "constant": fresh state, and frame 0 has rec == img. err is 0
        everywhere, so the min/max denominator and the z std are both 0 and
        the score is NaN (0/0).
      * "seeding": fresh state, an ordinary frame 0 that seeds the EMAs.
      * "converged": a state whose EMAs match the noise, as after a long
        stream; z is then O(1) and the anomaly block in the last-but-one
        frame (a bright square) drives it to its cap, so the count and the
        finite-score branch run. A fresh state at alpha 0.99 needs hundreds
        of frames to get there.
    """
    if start not in STARTS:
        raise ValueError(f"start must be one of {STARTS}")
    rng = np.random.RandomState(seed)
    sigma = 0.05
    scene = rng.uniform(0.2, 0.8, (h, w, c)).astype(np.float32)
    imgs = np.clip(scene + rng.normal(0, sigma, (n_frames, h, w, c)), 0, 1).astype(np.float32)
    recs = np.broadcast_to(scene, imgs.shape).copy()
    if start == "constant":
        recs[0] = imgs[0]
    if n_frames >= 3:
        k = n_frames - 2
        bh, bw = max(h // 4, 1), max(w // 4, 1)
        imgs[k, h // 2: h // 2 + bh, w // 2: w // 2 + bw] = 1.0
    maps0 = np.zeros((2, h, w), np.float32)
    scalars0 = np.zeros((6,), np.float32)
    if start == "converged":
        # err = sum of c squared N(0, sigma^2): mean c s^2, E[err^2] = (c^2 + 2c) s^4
        maps0[0] = c * sigma**2
        maps0[1] = (c * c + 2 * c) * sigma**4
        scalars0[:] = [0.0, 0.06, 20.0, 500.0, 1.0, 0.0]
    return imgs, recs, maps0, scalars0


def warm_score_state(h: int, w: int):
    """(maps, scalars) of a scorer that has seen a quiet stream (EMAs of a
    per-pixel error of about 0.1). Engines compared frame by frame start
    from it: a fresh state's first count is f32 rounding noise (see above),
    which would make their score histories differ from frame 0 on."""
    maps = np.stack([np.full((h, w), 0.1, np.float32), np.full((h, w), 0.0125, np.float32)])
    scalars = np.array([0.0, 1.0, 1.0, 2.0, 1.0, 0.0], np.float32)
    return maps, scalars


def run_sequence(step: StepFn, state, imgs: np.ndarray, recs: np.ndarray,
                 alpha: float) -> List[Tuple]:
    outs = []
    for img, rec in zip(imgs, recs):
        state, *rest = step(state, img, rec, alpha)
        outs.append(tuple(rest))
    return outs


def compare_sequences(got: Sequence[Tuple], ref: Sequence[Tuple], label: str = "") -> float:
    """Hold ``got`` against ``ref`` (outputs of ``run_sequence``) at the
    tolerances above; raises AssertionError on a violation and returns the
    largest absolute difference over the maps and the norm map."""
    max_err = 0.0
    counts_agreed = True
    for i, ((g_maps, g_scal, g_norm, g_score, g_count),
            (r_maps, r_scal, r_norm, r_score, r_count)) in enumerate(zip(got, ref)):
        where = f"{label} frame {i}"
        np.testing.assert_allclose(g_maps, r_maps, rtol=MAP_RTOL, atol=MAP_ATOL, err_msg=where)
        np.testing.assert_allclose(g_norm, r_norm, rtol=MAP_RTOL, atol=MAP_ATOL, err_msg=where)
        # [min_ema, max_ema, initialized, unused] depend on no count
        np.testing.assert_allclose(g_scal[[0, 1, 4, 5]], r_scal[[0, 1, 4, 5]],
                                   rtol=MAP_RTOL, atol=MAP_ATOL, err_msg=where)
        max_err = max(max_err, float(np.max(np.abs(g_maps - r_maps))),
                      float(np.max(np.abs(g_norm - r_norm))))
        assert abs(float(g_count) - float(r_count)) <= COUNT_TOL, (
            f"{where}: count {g_count} vs {r_count}")
        counts_agreed = counts_agreed and float(g_count) == float(r_count)
        if not counts_agreed:
            continue  # the count EMAs differ from here on, and so do the scores
        assert np.isnan(g_score) == np.isnan(r_score), (
            f"{where}: score {g_score} vs {r_score} (NaN must match)")
        if not np.isnan(r_score):
            np.testing.assert_allclose(g_scal[2:4], r_scal[2:4], rtol=MAP_RTOL,
                                       atol=MAP_ATOL, err_msg=where)
            np.testing.assert_allclose(g_score, r_score, rtol=SCORE_RTOL, err_msg=where)
    return max_err


# -- training-step parity ----------------------------------------------------------
#
# Two runs of the same training steps (the port on cuda and on cpu, or the
# port and the JAX package) start from the same weights and take the same
# batches and the same latent noise, so they differ only in the order of
# sums and, on the card, in cuDNN's choice of algorithms.

def train_inputs(config: dict, n_steps: int = 3, batch: int = 8, seed: int = 0):
    """[(x, eps)] per step: x (B, W, H, C) float32 in [0, 1] (a fixed scene
    plus per-frame noise, so there is something to reconstruct) and the
    latent noise eps (B, latent) float32, all from numpy's ``seed``."""
    w, h, c = (int(v) for v in config["data"]["image_size"])
    latent = int(config["model"]["latent_dimensions"])
    rng = np.random.RandomState(seed)
    scene = rng.uniform(0.2, 0.8, (w, h, c))
    steps = []
    for _ in range(n_steps):
        x = np.clip(scene + rng.normal(0, 0.1, (batch, w, h, c)), 0, 1).astype(np.float32)
        steps.append((x, rng.standard_normal((batch, latent)).astype(np.float32)))
    return steps


def run_train_steps(model, inputs) -> List[dict]:
    """``model.train_step_and_run`` over ``train_inputs``; the loss dicts as
    floats plus ``x_hat`` as numpy, per step. The model must be compiled."""
    import torch

    outs = []
    for x, eps in inputs:
        loss, x_hat = model.train_step_and_run(torch.from_numpy(x),
                                               eps=torch.from_numpy(eps).to(model.device))
        out = {k: float(v) for k, v in loss.items()}
        out["x_hat"] = x_hat.to("cpu", torch.float32).numpy()
        outs.append(out)
    return outs


def compare_train_runs(got: Sequence[dict], ref: Sequence[dict], rtol: float, atol: float,
                       label: str = "") -> float:
    """Hold the per-step outputs of ``run_train_steps`` (or dicts of the same
    keys from the JAX package) against each other; returns the largest
    absolute difference of the loss."""
    worst = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        assert set(g) == set(r), f"{label} step {i}: keys {sorted(g)} vs {sorted(r)}"
        for k in g:
            np.testing.assert_allclose(g[k], r[k], rtol=rtol, atol=atol,
                                       err_msg=f"{label} step {i} {k}")
        worst = max(worst, abs(g["loss"] - r["loss"]))
    return worst


# -- the dense-update kernels (ops/dense_grad_adam.py) ------------------------------


def steps_apart(got, ref, terms=None, floor: float = 0.0) -> Tuple[float, float]:
    """How far apart two tensors of one dtype (bfloat16 or float32) are: (the
    share of elements that differ, their largest difference in steps of the
    dtype at the larger of the two values). Where two terms cancelled to a
    value far below the tensor's scale, what is left is the float32 rounding
    of the terms: the step is never taken below one float32 step at that
    scale. ``terms`` (magnitudes, same shape): the terms the values are a sum
    of, where an input of the sum already differed by a step; the step is
    then taken at them. ``floor``: a difference that small counts as one step
    whatever the value (the error that a sum of many terms carries when it
    cancels to a value far below its terms)."""
    import torch

    if got.dtype != ref.dtype or got.shape != ref.shape:
        raise ValueError(f"{got.dtype} {tuple(got.shape)} against {ref.dtype} {tuple(ref.shape)}")
    bits = 7 if got.dtype == torch.bfloat16 else 23
    a, b = got.double(), ref.double()
    differ = a != b
    n = int(differ.sum())
    if n == 0:
        return 0.0, 0.0
    big = torch.maximum(a.abs(), b.abs())
    if terms is not None:
        big = torch.maximum(big, terms.double())
    step = torch.exp2(torch.floor(torch.log2(big[differ])) - bits)
    step = step.clamp_min(max(floor, 2.0 ** -23 * float(b.abs().max())))
    return n / got.numel(), float(((a - b).abs()[differ] / step).max())


# How far one Adam step may move w, mu and nu, in their own steps (``steps_apart`` with the
# terms of w and mu), where its bfloat16 g is one step from the plain version's. The
# tensor-core product sums K in another order than the plain float32 product and rounds g a
# step apart on a few 1e-4 of the elements; everywhere else the step is exact and the bits
# are equal. nu = b2 nu + (1 - b2) g g moves by up to 2.9 of its steps before each side
# rounds (where nu is small), so by less than 4 after; mu moves by a tenth of g's
# difference, and w through both where its update is of the size of w. Measured on an
# H100 at the flagship's encoder Dense: w 3.5, mu 2.0, nu 3.0.
FLIPPED_G_STEPS = 4.0


def shifted(t, offset: int):
    """A contiguous copy of ``t`` that starts ``offset`` elements into its
    allocation (so not on a 16-byte boundary when offset is 1)."""
    import torch

    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


# -- the reference's log directories (train/tf_import.py) ------------------------------
#
# The reference saves a trained model as Keras SavedModels, whose variables are
# a TensorFlow TensorBundle. TensorFlow 2.16 and later write Keras 3's keys only,
# so these writers are how the reference's own Keras 2 keys are made for a test,
# and how chip_smoke.py makes a flagship-size reference directory without
# TensorFlow. TF's reader checks every block's and every tensor's CRC32C.

_CRC32C_POLY = 0x82F63B78  # CRC-32C (Castagnoli), reflected
_CRC_CHUNKS = 1 << 20  # chunks a buffer is split into, each run as one lane


@functools.lru_cache(maxsize=1)
def _crc_tables():
    """The byte table of the reflected CRC-32C and two 16-bit tables that
    step the register over one little-endian 32-bit word: for w = crc ^ word,
    the new register is lo[w & 0xFFFF] ^ hi[w >> 16]."""
    table = np.zeros((4, 256), np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_CRC32C_POLY if c & 1 else 0)
        table[0, i] = c
    for k in range(1, 4):
        table[k] = (table[k - 1] >> 8) ^ table[0][table[k - 1] & 0xFF]
    idx = np.arange(1 << 16, dtype=np.uint32)
    lo = table[3][idx & 0xFF] ^ table[2][idx >> 8]
    hi = table[1][idx & 0xFF] ^ table[0][idx >> 8]
    return table[0], lo, hi


def _gf2_times(mat, vec: int) -> int:
    out = 0
    j = 0
    while vec:
        if vec & 1:
            out ^= mat[j]
        vec >>= 1
        j += 1
    return out


def _zero_bytes_op(n: int, squares: list) -> np.ndarray:
    """The 32 columns (GF(2)) of the linear map that feeds ``n`` zero bytes
    through a raw CRC-32C register (no pre- or post-conditioning);
    ``squares[k]``, the map of 2**k zero bytes, is extended as needed."""
    if not squares:
        m = [_CRC32C_POLY] + [1 << (j - 1) for j in range(1, 32)]  # one zero bit
        for _ in range(3):
            m = [_gf2_times(m, col) for col in m]
        squares.append(m)
    op = [1 << j for j in range(32)]
    k = 0
    while n:
        while len(squares) <= k:
            squares.append([_gf2_times(squares[-1], col) for col in squares[-1]])
        if n & 1:
            op = [_gf2_times(squares[k], col) for col in op]
        n >>= 1
        k += 1
    return np.array(op, np.uint32)


def _apply_op(op: np.ndarray, v: np.ndarray) -> np.ndarray:
    out = np.zeros_like(v)
    for j in range(32):
        out ^= op[j] * ((v >> np.uint32(j)) & np.uint32(1))
    return out


def _raw_crc_rows(words: np.ndarray, out: np.ndarray) -> None:
    """The raw CRC-32C (register from 0) of each row of ``words`` (rows of
    little-endian 32-bit words) into ``out``: every row is one lane of the
    same numpy operations, a word at a time."""
    _, lo_table, hi_table = _crc_tables()
    crc = np.zeros(words.shape[0], np.uint32)
    lo, hi = np.empty_like(crc), np.empty_like(crc)
    for start in range(0, words.shape[1], 64):
        block = np.ascontiguousarray(words[:, start:start + 64].T)  # a word of every row, in a row
        for w in block:
            np.bitwise_xor(crc, w, out=crc)
            np.bitwise_and(crc, 0xFFFF, out=lo)
            np.right_shift(crc, 16, out=hi)
            np.take(lo_table, lo, out=crc)
            np.take(hi_table, hi, out=hi)
            np.bitwise_xor(crc, hi, out=crc)
    out[:] = crc


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data`` (bytes or a numpy array's bytes), as
    TensorFlow's ``crc32c::Value``. The buffer is cut into up to 2^20
    equal chunks whose CRCs run side by side as numpy lanes on a few threads;
    the chunks' CRCs are then joined pairwise (the CRC of two pieces is the
    first's register fed the second's length in zero bytes, xor the
    second's), so a 5 GB buffer takes seconds, not the hour of a Python byte
    loop."""
    from concurrent.futures import ThreadPoolExecutor

    byte_table = _crc_tables()[0]
    squares: list = []
    buf = (np.ascontiguousarray(data).reshape(-1).view(np.uint8) if isinstance(data, np.ndarray)
           else np.frombuffer(bytes(data), np.uint8))
    n = buf.size
    chunk = max(256, (-(-n // _CRC_CHUNKS) + 3) & ~3)
    count = n // chunk
    raw = 0
    if count:
        crcs = np.zeros(count, np.uint32)
        words = buf[:count * chunk].view(np.uint32).reshape(count, chunk // 4)
        n_threads = min(8, os.cpu_count() or 1) if count >= 1 << 16 else 1
        bounds = np.linspace(0, count, n_threads + 1).astype(int)
        with ThreadPoolExecutor(n_threads) as pool:
            list(pool.map(lambda i: _raw_crc_rows(words[bounds[i]:bounds[i + 1]],
                                                  crcs[bounds[i]:bounds[i + 1]]),
                          range(n_threads)))
        # join pairwise; chunks of zeros in front change nothing of a raw CRC
        size = 1 << (count - 1).bit_length()
        v = np.concatenate([np.zeros(size - count, np.uint32), crcs])
        span = chunk
        while v.size > 1:
            v = _apply_op(_zero_bytes_op(span, squares), v[0::2]) ^ v[1::2]
            span *= 2
        raw = int(v[0])
    for b in buf[count * chunk:].tobytes():
        raw = int(byte_table[(raw ^ b) & 0xFF]) ^ (raw >> 8)
    # the standard CRC starts its register at all ones and inverts the result
    init = int(_apply_op(_zero_bytes_op(n, squares), np.array([0xFFFFFFFF], np.uint32))[0])
    return (raw ^ init ^ 0xFFFFFFFF) & 0xFFFFFFFF


def masked_crc32c(data) -> int:
    """The masked CRC-32C that LevelDB tables and TensorBundles store."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


_TF_DTYPES = {"float32": 1, "float64": 2, "int32": 3, "uint8": 4, "int16": 5, "int8": 6,
              "int64": 9, "bool": 10, "bfloat16": 14, "uint16": 17, "float16": 19,
              "uint32": 22, "uint64": 23}
_TABLE_MAGIC = 0xDB4775248B80FB57
_RESTART_INTERVAL = 16


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(number: int, payload: bytes) -> bytes:  # a length-delimited protobuf field
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _table_block(entries, restart_interval: int) -> bytes:
    """A LevelDB-format block of sorted (key, value) entries: keys
    prefix-compressed against the previous one, restarting every
    ``restart_interval`` entries, then the restart offsets and their count."""
    out = bytearray()
    restarts = []
    prev = b""
    for i, (key, value) in enumerate(entries):
        shared = 0
        if i % restart_interval == 0:
            restarts.append(len(out))
        else:
            while shared < min(len(prev), len(key)) and prev[shared] == key[shared]:
                shared += 1
        out += _varint(shared) + _varint(len(key) - shared) + _varint(len(value))
        out += key[shared:] + value
        prev = key
    if not restarts:
        restarts = [0]
    out += b"".join(struct.pack("<I", r) for r in restarts) + struct.pack("<I", len(restarts))
    return bytes(out)


def write_tf_bundle(prefix: str, tensors: dict, block_size: int = 262144) -> None:
    """Write ``tensors`` ({key: numpy array}; bfloat16 as ml_dtypes) as a
    one-shard TensorBundle, as TensorFlow's ``BundleWriter`` lays it out:
    ``<prefix>.data-00000-of-00001`` holds the tensors' bytes, and
    ``<prefix>.index`` is a table of the ``BundleHeaderProto`` under key ""
    and one ``BundleEntryProto`` per tensor (dtype, shape, offset, size,
    masked CRC-32C of the bytes): data blocks of about ``block_size`` bytes
    with restart points, an empty metaindex block, an index block, each
    block followed by its type byte and masked CRC-32C, and the 48-byte
    footer."""
    entries = [(b"", _varint(1 << 3) + _varint(1) + _field(3, _varint(1 << 3) + _varint(1)))]
    offset = 0
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    with open(prefix + ".data-00000-of-00001", "wb") as data:
        for key in sorted(tensors, key=lambda k: k.encode("utf-8")):
            a = np.asarray(tensors[key])
            raw = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
            data.write(memoryview(raw))
            shape = b"".join(_field(2, _varint(1 << 3) + _varint(int(d))) for d in a.shape)
            entry = (_varint(1 << 3) + _varint(_TF_DTYPES[a.dtype.name]) + _field(2, shape)
                     + _varint(4 << 3) + _varint(offset) + _varint(5 << 3) + _varint(raw.size)
                     + _varint(6 << 3 | 5) + struct.pack("<I", masked_crc32c(raw)))
            entries.append((key.encode("utf-8"), entry))
            offset += raw.size

    index = bytearray()

    def emit(block: bytes) -> bytes:  # the block with its trailer; returns its handle
        handle = _varint(len(index)) + _varint(len(block))
        index.extend(block + b"\x00" + struct.pack("<I", masked_crc32c(block + b"\x00")))
        return handle

    handles = []
    pending = []
    for i, entry in enumerate(entries):
        pending.append(entry)
        if i == len(entries) - 1 or sum(len(k) + len(v) for k, v in pending) >= block_size:
            handles.append((pending[-1][0], emit(_table_block(pending, _RESTART_INTERVAL))))
            pending = []
    metaindex = emit(_table_block([], 1))
    index_handle = emit(_table_block(handles, 1))
    footer = metaindex + index_handle
    index += footer + b"\x00" * (40 - len(footer)) + struct.pack("<Q", _TABLE_MAGIC)
    with open(prefix + ".index", "wb") as f:
        f.write(bytes(index))


def write_reference_logdir(directory: str, config: dict, flax_params: dict,
                           parts=("encoder", "decoder")) -> None:
    """A log directory as the reference writes it, for the weights
    ``flax_params`` ({'encoder': {layer: {'kernel', 'bias'}}, 'decoder': ...}
    of numpy arrays in flax's layouts, which are Keras's): ``config.yml``
    and ``encoder/variables/`` + ``decoder/variables/`` bundles under the
    reference's Keras 2 keys (``layer_with_weights-N/kernel/.ATTRIBUTES/
    VARIABLE_VALUE``), N in network order. The SavedModels' graphs are not
    written: what ``train/tf_import.py`` reads is there, a serving signature
    is not. ``parts`` names the SavedModels to write (``flax_params`` needs
    only those)."""
    from trustedai_cl_vae_ad_tpu_torch.config import save_config
    from trustedai_cl_vae_ad_tpu_torch.train.tf_import import (
        decoder_layer_names,
        encoder_layer_names,
    )

    os.makedirs(directory, exist_ok=True)
    names_of = {"encoder": encoder_layer_names(config), "decoder": decoder_layer_names(config)}
    for part in parts:
        names = names_of[part]
        tensors = {f"layer_with_weights-{i}/{leaf}/.ATTRIBUTES/VARIABLE_VALUE":
                   flax_params[part][name][leaf]
                   for i, name in enumerate(names) for leaf in ("kernel", "bias")}
        write_tf_bundle(os.path.join(directory, part, "variables", "variables"), tensors)
    save_config(config, os.path.join(directory, "config.yml"))
