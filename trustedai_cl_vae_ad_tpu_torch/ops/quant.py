"""Int8 weight quantization for the serving and streaming forward paths.

Counterpart of ``trustedai_cl_vae_ad_tpu/ops/quant.py``. At serving batch
sizes (1-16 frames per tick) the flagship's forward streams its weights: the
two large Dense layers hold 5.4 GB in float32 and every tick reads them
once. Stored as int8 with one float32 scale per output channel they are 1.34
GB. This is an inference-only, opt-in path (``StreamingEngine(quantize=True)``,
``MultiCameraEngine(quantize=True)``, ``camera_streamer_torch.py --quantize``);
training and continual learning keep full precision.

Two modes:
  * ``"w8a8"`` (default): int8 weights and dynamic per-row int8 activations;
    the product runs in int8 with int32 sums, through ``ops/int8_gemm.py``
    (a hand-written CUDA kernel on the card).
  * ``"w8"``: int8 weights dequantized to the compute dtype for each call,
    activations stay float: plain PyTorch, no kernel. The dequantized kernel
    is a temporary of the float kernel's size (4.3 GB in float32 for the
    flagship's encoder Dense, per call), so this is the fallback for small
    models, not the fast path.

Only Dense kernels with at least ``min_elems`` elements are quantized
(default 2^25: the flagship's two large ones); small heads and every
convolution stay in their own dtype.

Layout. The quantized tree is a plain nested dict of tensors on one explicit
device: ``tree[part][layer]`` with part ``encoder`` / ``decoder`` and the flax
layer names. A float layer is ``{"weight", "bias"}`` holding the model's own
tensors (by reference, in the port's layouts); a quantized Dense is
``{"kernel_i8", "scale", "bias"}`` with ``kernel_i8`` int8 of shape (out, in),
the layout of the port's float Dense (``nn.Linear.weight``) and the transpose
of the JAX tree's (in, out). The reason is the kernel: with (out, in) the
contraction axis is contiguous in the weights as it is in the activations, so
a thread's 16-byte load feeds four ``dp4a`` instructions directly; a scale
belongs to a row, so ``quantize_dense_kernel`` works through independent row
blocks with one pass for each block's row maxima, and never holds float32
temporaries of the whole kernel. ``bridge.py`` carries the tree to the JAX
layout and back.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from trustedai_cl_vae_ad_tpu_torch.models.cvae import conv2d_same, normalize_image_input
from trustedai_cl_vae_ad_tpu_torch.ops.convt import conv_transpose_same
from trustedai_cl_vae_ad_tpu_torch.ops.int8_gemm import int8_gemm

DEFAULT_MIN_ELEMS = 1 << 25

#: elements of a Dense kernel that ``quantize_dense_kernel`` holds in float32 at a time
_ROW_BLOCK_ELEMS = 1 << 24

_TINY = float(torch.finfo(torch.float32).tiny)


def quantize_dense_kernel(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of an (out, in) kernel.

    Returns ``(kernel_i8 int8 (out, in), scale float32 (out,))`` with
    ``weight ~= kernel_i8 * scale[:, None]``; rounding is half to even. Rows
    are independent, so the kernel is worked through in blocks of rows: the
    float32 temporaries are of one block, not of the kernel.
    """
    if weight.dim() != 2:
        raise ValueError(f"a Dense kernel is a matrix, got shape {tuple(weight.shape)}")
    weight = weight.detach()
    n_out, n_in = weight.shape
    k_i8 = torch.empty((n_out, n_in), dtype=torch.int8, device=weight.device)
    scale = torch.empty((n_out,), dtype=torch.float32, device=weight.device)
    rows = max(1, _ROW_BLOCK_ELEMS // max(n_in, 1))
    for r0 in range(0, n_out, rows):
        block = weight[r0:r0 + rows].to(torch.float32)
        s = torch.clamp(block.abs().amax(dim=1) / 127.0, min=_TINY)
        scale[r0:r0 + rows] = s
        k_i8[r0:r0 + rows] = torch.clamp(torch.round(block / s[:, None]), -127, 127).to(torch.int8)
    return k_i8, scale


def _is_qdense(p) -> bool:
    return isinstance(p, dict) and "kernel_i8" in p


def quantize_params(core, params: dict, min_elems: Optional[int] = None) -> dict:
    """The serving tree of ``params`` (the core's state dict) with large Dense
    kernels quantized.

    Quantized entries are ``{kernel_i8, scale, bias}``; everything else keeps
    the model's own tensors by reference. ``min_elems`` defaults to
    ``DEFAULT_MIN_ELEMS``, resolved at call time (so tests can patch it), or
    to the ``TCVAE_QUANT_MIN_ELEMS`` environment variable when it is set.
    """
    if min_elems is None:
        min_elems = int(os.environ.get("TCVAE_QUANT_MIN_ELEMS", DEFAULT_MIN_ELEMS))
    tree: dict = {"encoder": {}, "decoder": {}}
    for key, t in params.items():
        part, _layers, layer, name = key.split(".")
        tree[part].setdefault(layer, {})[name] = t
    for part in tree.values():
        for layer, p in part.items():
            if layer.startswith("Dense_") and "weight" in p and p["weight"].numel() >= min_elems:
                k_i8, scale = quantize_dense_kernel(p["weight"])
                part[layer] = {"kernel_i8": k_i8, "scale": scale, "bias": p["bias"]}
    return tree


# the longest contraction whose worst-case int8 x int8 sum (127 * 127 an
# element) provably fits int32 is floor(2^31 / 127^2) = 133144
_I32_SAFE_K = 1 << 17  # 131072


def _dense(p: dict, x: torch.Tensor, dtype: torch.dtype, mode: str) -> torch.Tensor:
    """Apply a Dense layer from a float or a quantized entry. The float path
    is the model's own: inputs and parameters cast to ``dtype``, x Wᵀ + b."""
    if mode not in ("w8", "w8a8"):
        raise ValueError(f"unknown quantization mode {mode!r} (w8 | w8a8)")
    if not _is_qdense(p):
        return F.linear(x.to(dtype), p["weight"].to(dtype), p["bias"].to(dtype))
    bias = p["bias"].to(torch.float32)
    if mode == "w8":
        w = p["kernel_i8"].to(dtype) * p["scale"].to(dtype)[:, None]
        return F.linear(x.to(dtype), w, bias.to(dtype)).to(dtype)
    # w8a8: dynamic symmetric per-row activation quantization
    xf = x.to(torch.float32)
    sx = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=_TINY)
    x_i8 = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return _rescale(_int8_partials(x_i8, p["kernel_i8"]), sx, p["scale"], bias).to(dtype)


def _int8_partials(x_i8: torch.Tensor, k_i8: torch.Tensor) -> list:
    """The int32 products of the contraction's chunks, in order. The encoder
    Dense contracts over K = 268800, where an all-saturated row (activations
    after a relu are non-negative) could leave int32: the contraction is
    split into chunks that provably cannot, each one launch of the int8
    kernel on its range of the full matrices, so the kernel is still read
    exactly once in total."""
    k_total = k_i8.shape[1]
    return [int8_gemm(x_i8, k_i8, s, min(s + _I32_SAFE_K, k_total))
            for s in range(0, k_total, _I32_SAFE_K)]


def _rescale(partials: list, sx: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor) -> torch.Tensor:
    """float32 sum of the chunks in order, then ``acc * sx * scale + bias``."""
    acc = partials[0].to(torch.float32)
    for part in partials[1:]:
        acc = acc + part.to(torch.float32)
    return acc * sx * scale[None, :] + bias


def call_quantized(core, qparams: dict, x: torch.Tensor, mode: str = "w8a8") -> torch.Tensor:
    """Eval-mode forward (``core.call(x, training=False)``) over a serving
    tree: the encoder and decoder of ``models/cvae.py`` with each Dense
    evaluated from its entry. With nothing quantized it equals ``core.call``
    exactly, the uint8 input contract included (raw 0-255 pixels are
    normalized on the device)."""
    dtype = core.encoder.dtype
    enc = qparams["encoder"]
    h = normalize_image_input(x).to(dtype).permute(0, 3, 1, 2)
    for i, _ in enumerate(core.conv_filters):
        p = enc[f"Conv_{i}"]
        h = F.relu(conv2d_same(h, p["weight"].to(dtype), p["bias"].to(dtype), 2))
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    j = 0
    if core.encoder_dense_filters:
        h = _dense(enc[f"Dense_{j}"], h, dtype, mode)
        j += 1
    out = _dense(enc[f"Dense_{j}"], h, dtype, mode).to(torch.float32)
    mean, logvar = torch.chunk(out, 2, dim=1)

    # eval-mode reparameterize: z = mean + 0.5 * logvar (eps = 0)
    z = mean + (logvar * 0.5)

    dec = qparams["decoder"]
    dw, dh, df = core.dense_shape
    g = F.relu(_dense(dec["Dense_0"], z, dtype, mode))
    g = g.reshape(g.shape[0], dw, dh, df).permute(0, 3, 1, 2)
    n_up = len(core.conv_filters)
    for i in range(n_up + 1):
        p = dec[f"ConvTranspose_{i}"]
        g = conv_transpose_same(g, p["weight"].to(dtype), 2 if i < n_up else 1)
        g = g + p["bias"].to(dtype)[None, :, None, None]
        if i < n_up:
            g = F.relu(g)
    return torch.sigmoid(g.permute(0, 2, 3, 1).to(torch.float32).contiguous())


def serving_forward(core, params: Optional[dict], quantize: bool = False, mode: str = "w8a8",
                    qparams: Optional[dict] = None):
    """One-stop forward selection for the serving and scoring integrations.

    Returns ``(forward_fn, serve_params)`` with ``forward_fn(serve_params, x)``
    the eval forward (x: NHWC batch): the float forward of the module on the
    parameters it holds (``params`` passes through), or, with ``quantize``,
    ``call_quantized`` over a quantized copy. ``qparams`` supplies a tree that
    is already quantized (``load_quantized_checkpoint``): ``params`` is then
    not touched at all, which is the int8-checkpoint boot.
    """
    if qparams is not None:
        return (lambda p, x: call_quantized(core, p, x, mode=mode)), qparams
    if quantize:
        qparams = quantize_params(core, params)
        return (lambda p, x: call_quantized(core, p, x, mode=mode)), qparams
    return (lambda _p, x: core(x)), params


def tree_nbytes(tree: dict) -> int:
    """Bytes of the tensors of a serving tree."""
    return sum(t.numel() * t.element_size()
               for part in tree.values() for p in part.values() for t in p.values())


# -- the quantized sidecar of a log directory ---------------------------------------

QUANTIZED_SUBDIR = "quantized"
PROVENANCE_FILE = "float_provenance.json"
QUANTIZED_FILE = "params.pt"
COMMIT_FILE = "commit.json"

_STAMP_SPAN = 1 << 20


def float_checkpoint_stamp(log_dir: str) -> dict:
    """Content-based identity of the float checkpoint: for ``encoder`` and
    ``decoder`` a SHA-256 over the size of ``<part>/params.pt`` and its first
    and last MiB. The file is ``torch.save``'s zip archive, whose central
    directory at the end carries a CRC-32 of every tensor record, so the
    stamp follows the content of all of them without reading 5.4 GB, and,
    unlike filesystem mtimes, it survives copies that preserve mtimes (cp -p,
    rsync -a, tar). A missing file maps to None."""
    stamp = {}
    for part in ("encoder", "decoder"):
        path = os.path.join(log_dir, part, "params.pt")
        try:
            size = os.path.getsize(path)
            digest = hashlib.sha256(str(size).encode())
            with open(path, "rb") as f:
                digest.update(f.read(_STAMP_SPAN))
                if size > _STAMP_SPAN:
                    f.seek(max(size - _STAMP_SPAN, _STAMP_SPAN))
                    digest.update(f.read())
            stamp[part] = digest.hexdigest()
        except OSError:
            stamp[part] = None
    return stamp


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            value = json.load(f)
    except (OSError, ValueError):
        return None
    return value if isinstance(value, dict) else None


def _commit_time(directory: str) -> Optional[int]:
    """``commit_timestamp_nsecs`` of a ``commit.json`` in ``directory``."""
    return (_read_json(os.path.join(directory, COMMIT_FILE)) or {}).get("commit_timestamp_nsecs")


def quantized_staleness(log_dir: str):
    """Did ``<log_dir>/quantized`` come from the current float checkpoint?

    Returns None (no evidence of staleness) or ``(code, message)``. Evidence
    is content-based first: the provenance stamp that
    ``save_quantized_checkpoint`` writes (``provenance_mismatch``), then commit
    timestamps recorded in files (``commit.json`` in ``quantized/`` and, where
    a writer left one, in ``encoder/`` and ``decoder/``: ``commit_older``);
    filesystem mtimes, which lie under mtime-preserving copies and clock
    skew, are the last resort, with soft wording (``mtime_older``)."""
    qdir = os.path.join(log_dir, QUANTIZED_SUBDIR)
    float_stamp = float_checkpoint_stamp(log_dir)
    prov = (_read_json(os.path.join(qdir, PROVENANCE_FILE)) or {}).get("float_checkpoint")
    # an all-None stamp (no float checkpoint beside the sidecar when it was
    # written) carries no content evidence: compared with an equally blank
    # current stamp it would certify a stale sidecar as fresh
    if isinstance(prov, dict) and not any(v is not None for v in prov.values()):
        prov = None
    if prov is not None:
        if prov != float_stamp:
            return ("provenance_mismatch",
                    "quantized/ was built from a DIFFERENT float checkpoint "
                    "(provenance mismatch)")
        return None
    q_commit = _commit_time(qdir)
    float_commits = [t for t in (_commit_time(os.path.join(log_dir, part))
                                 for part in ("encoder", "decoder")) if t is not None]
    if q_commit is not None and float_commits:
        if max(float_commits) > q_commit:
            return ("commit_older", "quantized/ was committed BEFORE the float checkpoint")
        return None

    def tree_mtime(root):
        return max((os.path.getmtime(os.path.join(r, f))
                    for r, _d, fs in os.walk(root) for f in fs), default=0.0)

    float_mtime = max((tree_mtime(os.path.join(log_dir, part)) for part in ("encoder", "decoder")
                       if os.path.isdir(os.path.join(log_dir, part))), default=0.0)
    if float_mtime > tree_mtime(qdir):
        return ("mtime_older",
                "quantized/ MAY be stale (older filesystem mtime than the float checkpoint; "
                "no content provenance found)")
    return None


def _sidecar_paths(log_dir: str):
    path = os.path.abspath(os.path.join(log_dir, QUANTIZED_SUBDIR))
    return path, path + ".staging", path + ".old"


def save_quantized_checkpoint(log_dir: str, qparams: dict) -> str:
    """Persist a serving tree under ``<log_dir>/quantized`` and return that
    path. ``quantized/params.pt`` is one flat ``torch.save`` dict
    ``{"<part>/<layer>/<leaf>": CPU tensor}``.

    The replace is crash-safe: the new tree is staged in a sibling directory,
    the provenance stamp is written last (it marks the staging directory as
    complete), then two renames swap it in; loaders heal a kill between the
    two renames (``_heal_quantized``). Healing comes BEFORE the sweep of
    leftovers: after such a kill ``.staging`` or ``.old`` may hold the only
    copy.
    """
    _heal_quantized(log_dir)
    path, staging, old = _sidecar_paths(log_dir)
    for leftover in (staging, old):
        if os.path.isdir(leftover):
            shutil.rmtree(leftover)
    os.makedirs(staging)
    flat = {f"{part}/{layer}/{leaf}": t.detach().to("cpu")
            for part, layers in qparams.items() for layer, p in layers.items()
            for leaf, t in p.items()}
    torch.save(flat, os.path.join(staging, QUANTIZED_FILE))
    with open(os.path.join(staging, COMMIT_FILE), "w") as f:
        json.dump({"commit_timestamp_nsecs": time.time_ns()}, f)
    with open(os.path.join(staging, PROVENANCE_FILE), "w") as f:
        json.dump({"float_checkpoint": float_checkpoint_stamp(log_dir)}, f)
    if os.path.isdir(path):
        os.rename(path, old)
    os.rename(staging, path)
    if os.path.isdir(old):
        shutil.rmtree(old)
    return path


def _heal_quantized(log_dir: str) -> None:
    """Recover ``quantized/`` after a save that was killed between its two
    renames: a COMPLETE staging directory wins (its provenance stamp is
    written last), else the displaced previous copy. No-op when healthy."""
    path, staging, old = _sidecar_paths(log_dir)
    if not os.path.isdir(path):
        if os.path.isdir(staging) and os.path.isfile(os.path.join(staging, PROVENANCE_FILE)):
            os.rename(staging, path)
        elif os.path.isdir(old):
            os.rename(old, path)


def load_quantized_checkpoint(log_dir: str, device="cuda") -> dict:
    """The serving tree of ``<log_dir>/quantized`` on ``device`` (moved there
    once, here); dtypes and structure come from the file: int8 kernels,
    float32 scales, float biases and convolutions."""
    _heal_quantized(log_dir)
    path = os.path.join(_sidecar_paths(log_dir)[0], QUANTIZED_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no quantized checkpoint at {path}")
    flat = torch.load(path, map_location=torch.device(device), weights_only=True)
    tree: dict = {"encoder": {}, "decoder": {}}
    for key, t in flat.items():
        part, layer, leaf = key.split("/")
        tree[part].setdefault(layer, {})[leaf] = t
    return tree


def has_quantized_checkpoint(log_dir: str) -> bool:
    _heal_quantized(log_dir)
    return os.path.isdir(os.path.join(log_dir, QUANTIZED_SUBDIR))


class QuantizedServingModel:
    """Inference-only model shell for int8-checkpoint boots.

    Stands in for ``VAEModel`` on the serving surfaces that booted straight
    from ``<log_dir>/quantized``: ``params`` is None (the float tensors are
    never made; ``core`` stays on the ``meta`` device and only describes the
    architecture) and ``qparams`` holds the serving tree. ``save_model``
    persists the quantized tree again; such a snapshot holds no float
    ``encoder/`` or ``decoder/``.
    """

    optimizer = None

    def __init__(self, core, qparams: dict, device):
        self.core = core
        self.device = torch.device(device)
        self.params = None
        self.qparams = qparams

    def save_model(self, log_dir: str, include_optimizer: bool = True) -> None:
        save_quantized_checkpoint(log_dir, self.qparams)


def load_int8_serving_model(model_dir: str, device="cuda", log=print):
    """``(QuantizedServingModel, config)`` from ``<model_dir>/quantized``: the
    float checkpoint is neither read nor put on the device. Warns when the
    sidecar looks older than the float checkpoint beside it (a retrain
    without a new ``tools/quantize_checkpoint_torch.py`` run)."""
    from trustedai_cl_vae_ad_tpu_torch.config import load_config, validate_config
    from trustedai_cl_vae_ad_tpu_torch.registry import build_core_from_config

    config = validate_config(load_config(os.path.join(model_dir, "config.yml")))
    core = build_core_from_config(config)
    qparams = load_quantized_checkpoint(model_dir, device)
    log(f"int8 boot: loaded quantized checkpoint from "
        f"{os.path.join(model_dir, QUANTIZED_SUBDIR)}")
    verdict = quantized_staleness(model_dir)
    if verdict is not None:
        log(f"WARNING: {verdict[1]}: serving may use weights from before a retrain; "
            "run tools/quantize_checkpoint_torch.py again to refresh")
    return QuantizedServingModel(core, qparams, device), config
