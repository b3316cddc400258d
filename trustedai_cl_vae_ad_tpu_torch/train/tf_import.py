"""Import the reference's checkpoints: TF SavedModel variables -> the port's model.

Counterpart of ``trustedai_cl_vae_ad_tpu/train/tf_import.py``. The reference
(gtemplin/TrustedAI-CL-VAE-AD) saves a trained model as a log directory of
Keras SavedModels, ``encoder/`` + ``decoder/`` + ``config.yml``. This module
moves those weights into a ``VAEModel`` of the same architecture, on the
device the caller names, without TensorFlow.

A SavedModel's variables are a TensorFlow "TensorBundle":
``variables/variables.index``, a LevelDB-format table whose values are
``BundleEntryProto`` messages, beside the ``.data-*-of-*`` shards that hold
the tensors' bytes. Both are stable on-disk formats, parsed here with the
standard library and numpy. The shards are memory-mapped: a tensor is an
array over the mapped file, and its bytes are read once, when the transplant
copies it into a torch tensor (a flagship bundle is 5.38 GB, one Dense kernel
in it 4.30 GB).

Key layouts read:
  * Keras 2 SavedModel (the reference's, TF < 2.11):
    ``layer_with_weights-N/kernel/.ATTRIBUTES/VARIABLE_VALUE``
  * Keras 3 / ``tf.saved_model.save``:
    ``_layers/N/_kernel/.ATTRIBUTES/VARIABLE_VALUE``

Keras's kernels are flax's layouts (Conv2D (kh, kw, in, out), Dense (in,
out), Conv2DTranspose (kh, kw, out, in) as flax's ``ConvTranspose`` with
``transpose_kernel=True``), so the weights become a flax-layout tree and
cross into the port through ``bridge.params_from_flax``, the one table of
permutations; ``load_state_dict`` casts each leaf to the model's dtype.

Unlike the JAX package's reader, a bundle that this parser cannot read is an
error naming the file and the fault: there is no second reader
(``tf.train.load_checkpoint``) to fall back on, which would hide a parse
fault.
"""

from __future__ import annotations

import glob
import os
import re
import struct
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

# -- the TensorBundle reader --------------------------------------------------------

_TABLE_MAGIC = 0xDB4775248B80FB57
_FOOTER_BYTES = 48
_DT_BFLOAT16 = 14

# tensorflow DataType enum -> numpy (bfloat16 through ml_dtypes)
_DTYPES = {
    1: np.float32,
    2: np.float64,
    3: np.int32,
    4: np.uint8,
    5: np.int16,
    6: np.int8,
    9: np.int64,
    10: np.bool_,
    _DT_BFLOAT16: None,
    17: np.uint16,
    19: np.float16,
    22: np.uint32,
    23: np.uint64,
}


def _read_varint(buf, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _parse_block_entries(block: bytes) -> List[Tuple[bytes, bytes]]:
    """The (key, value) entries of one LevelDB-format table block."""
    if len(block) < 4:
        return []
    num_restarts = struct.unpack("<I", block[-4:])[0]
    data_end = len(block) - 4 - 4 * num_restarts
    if data_end < 0:
        raise ValueError(f"block of {len(block)} bytes claims {num_restarts} restart points")
    entries = []
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _read_varint(block, pos)
        non_shared, pos = _read_varint(block, pos)
        value_len, pos = _read_varint(block, pos)
        key = key[:shared] + block[pos: pos + non_shared]
        pos += non_shared
        value = block[pos: pos + value_len]
        pos += value_len
        entries.append((key, value))
    return entries


def _read_table_block(data: bytes, offset: int, size: int) -> bytes:
    """One block by its handle; its trailer is 1 byte of compression type and
    4 of masked CRC32C."""
    if offset + size + 5 > len(data):
        raise ValueError(f"block at {offset} of {size} bytes runs past the end of the file")
    comp = data[offset + size]
    if comp != 0:  # kNoCompression; TF writes bundle indexes uncompressed
        raise ValueError(f"block at {offset} has compression type {comp}, which is not read")
    return data[offset: offset + size]


def _iter_index_entries(index_path: str):
    """(key, raw BundleEntryProto bytes) of each entry of a bundle's .index."""
    with open(index_path, "rb") as f:
        data = f.read()
    if len(data) < _FOOTER_BYTES:
        raise ValueError(f"{len(data)} bytes, shorter than the table's footer")
    magic = struct.unpack("<Q", data[-8:])[0]
    if magic != _TABLE_MAGIC:
        raise ValueError("not a TF bundle index (bad magic)")
    footer = data[-_FOOTER_BYTES:]
    pos = 0
    _mi_off, pos = _read_varint(footer, pos)
    _mi_size, pos = _read_varint(footer, pos)
    idx_off, pos = _read_varint(footer, pos)
    idx_size, pos = _read_varint(footer, pos)
    for _k, handle in _parse_block_entries(_read_table_block(data, idx_off, idx_size)):
        b_off, hpos = _read_varint(handle, 0)
        b_size, hpos = _read_varint(handle, hpos)
        for key, value in _parse_block_entries(_read_table_block(data, b_off, b_size)):
            yield key.decode("utf-8"), value


def _parse_shape(body: bytes) -> List[int]:
    """TensorShapeProto: repeated Dim dim = 2 { int64 size = 1; string name = 2 }."""
    dims = []
    pos = 0
    while pos < len(body):
        tag, pos = _read_varint(body, pos)
        field, wire = tag >> 3, tag & 7
        if field == 2 and wire == 2:
            dlen, pos = _read_varint(body, pos)
            dim_body = body[pos: pos + dlen]
            pos += dlen
            dpos = 0
            size = None
            while dpos < len(dim_body):
                dtag, dpos = _read_varint(dim_body, dpos)
                if dtag >> 3 == 1 and dtag & 7 == 0:
                    size, dpos = _read_varint(dim_body, dpos)
                elif dtag & 7 == 2:
                    nlen, dpos = _read_varint(dim_body, dpos)
                    dpos += nlen
                else:
                    raise ValueError(f"unexpected wire type {dtag & 7} in a shape's dim")
            if size is not None:
                dims.append(size)
        elif wire == 0:
            _, pos = _read_varint(body, pos)
        elif wire == 2:
            skip, pos = _read_varint(body, pos)
            pos += skip
        else:
            raise ValueError(f"unexpected wire type {wire} in a shape")
    return dims


def _parse_bundle_entry(raw: bytes) -> dict:
    """BundleEntryProto: dtype (1), shape (2), shard_id (3), offset (4),
    size (5), crc32c (6, fixed32), slices (7)."""
    entry = {"dtype": 0, "shape": [], "shard_id": 0, "offset": 0, "size": 0}
    varints = {1: "dtype", 3: "shard_id", 4: "offset", 5: "size"}
    pos = 0
    while pos < len(raw):
        tag, pos = _read_varint(raw, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(raw, pos)
            if field in varints:
                entry[varints[field]] = val
        elif wire == 2:
            ln, pos = _read_varint(raw, pos)
            if field == 2:
                entry["shape"] = _parse_shape(raw[pos: pos + ln])
            pos += ln
        elif wire == 5:
            pos += 4
        elif wire == 1:
            pos += 8
        else:
            raise ValueError(f"unexpected wire type {wire}")
    return entry


def _map_shard(path: str) -> np.ndarray:
    if os.path.getsize(path) == 0:  # mmap takes no empty file
        return np.zeros(0, np.uint8)
    return np.memmap(path, dtype=np.uint8, mode="r")


def read_tf_bundle(prefix: str) -> Dict[str, np.ndarray]:
    """Every numeric tensor of a TensorBundle, each an array over its
    memory-mapped shard (its bytes are read where the array is first used).

    ``prefix`` is the path without the .index / .data suffix, e.g.
    ``<savedmodel>/variables/variables``."""
    index_path = prefix + ".index"
    if not os.path.isfile(index_path):
        raise FileNotFoundError(f"{index_path}: no TensorBundle index")
    shards = [_map_shard(p) for p in sorted(glob.glob(prefix + ".data-*-of-*"))]
    out = {}
    for key, raw in _iter_index_entries(index_path):
        if key == "":
            continue  # BundleHeaderProto
        entry = _parse_bundle_entry(raw)
        if entry["dtype"] == _DT_BFLOAT16:
            import ml_dtypes

            np_dtype = np.dtype(ml_dtypes.bfloat16)
        elif _DTYPES.get(entry["dtype"]) is None:
            continue  # not numeric (string assets): no model weight
        else:
            np_dtype = np.dtype(_DTYPES[entry["dtype"]])
        shard, offset, size = entry["shard_id"], entry["offset"], entry["size"]
        if shard >= len(shards):
            raise ValueError(f"{key}: shard {shard} of {len(shards)} data files")
        if offset + size > len(shards[shard]) or size != np_dtype.itemsize * int(
                np.prod(entry["shape"], dtype=np.int64)):
            raise ValueError(f"{key}: {size} bytes at {offset} do not hold {np_dtype} "
                             f"{entry['shape']} in a shard of {len(shards[shard])} bytes")
        out[key] = shards[shard][offset: offset + size].view(np_dtype).reshape(entry["shape"])
    return out


def read_savedmodel_variables(savedmodel_dir: str) -> Dict[str, np.ndarray]:
    """Every checkpoint variable of a SavedModel directory. A bundle that
    does not parse is a ValueError naming it and the fault."""
    prefix = os.path.join(savedmodel_dir, "variables", "variables")
    if not os.path.isfile(prefix + ".index"):
        raise FileNotFoundError(f"{prefix}.index: not a SavedModel's variables")
    try:
        return read_tf_bundle(prefix)
    except (ValueError, IndexError, struct.error, UnicodeDecodeError) as err:
        raise ValueError(f"{prefix}.index: cannot read the TensorBundle: {err}") from err


# -- variables -> weighted layers ----------------------------------------------------

_LAYER_PATTERNS = [
    # Keras 2 SavedModel (the reference's format, TF < 2.11)
    re.compile(r"(?:^|/)layer_with_weights-(\d+)/_?([a-zA-Z_]+)/\.ATTRIBUTES/VARIABLE_VALUE$"),
    # Keras 3 / tf.saved_model.save
    re.compile(r"(?:^|/)_layers/(\d+)/_?([a-zA-Z_]+)/\.ATTRIBUTES/VARIABLE_VALUE$"),
]

_SKIP_SUBSTRINGS = ("optimizer", "OPTIMIZER", "keras_api", "OBJECT_GRAPH")


def extract_weighted_layers(variables: Dict[str, np.ndarray]) -> List[Dict[str, np.ndarray]]:
    """The checkpoint's variables grouped into the network's weighted layers,
    in order ({'kernel': ..., 'bias': ...} each)."""
    for pattern in _LAYER_PATTERNS:
        layers: Dict[int, Dict[str, np.ndarray]] = {}
        for key, arr in variables.items():
            if any(s in key for s in _SKIP_SUBSTRINGS):
                continue
            m = pattern.search(key)
            if m:
                idx, var = int(m.group(1)), m.group(2).lstrip("_")
                layers.setdefault(idx, {})[var] = arr
        if layers:
            return [layers[i] for i in sorted(layers)]
    raise ValueError(
        "no recognizable layer variables in checkpoint; keys were: "
        + ", ".join(sorted(variables)[:20])
    )


# -- weighted layers -> the model ----------------------------------------------------

def encoder_layer_names(config: dict) -> List[str]:
    """The encoder's weighted layers in network order, by their flax names
    (Conv_0.., [Dense_0,] the last Dense), which the port's modules carry."""
    n_conv = len(config["model"]["layers"])
    names = [f"Conv_{i}" for i in range(n_conv)]
    if config["model"].get("encoder_dense_filters"):
        names += ["Dense_0", "Dense_1"]
    else:
        names += ["Dense_0"]
    return names


def decoder_layer_names(config: dict) -> List[str]:
    """The decoder's: Dense_0, ConvTranspose_0..L (the last is the stride-1
    output convolution)."""
    n_conv = len(config["model"]["layers"])
    return ["Dense_0"] + [f"ConvTranspose_{i}" for i in range(n_conv + 1)]


def _transplant(tf_layers: List[Dict[str, np.ndarray]], model_shapes: dict,
                layer_names: List[str], what: str) -> dict:
    """The flax-layout subtree {layer: {kernel, bias}} of one part, each leaf
    the checkpoint's array (no copy, no cast); ``model_shapes`` {layer: {leaf:
    flax shape}} is the model's."""
    if len(tf_layers) != len(layer_names):
        raise ValueError(
            f"{what}: checkpoint has {len(tf_layers)} weighted layers, "
            f"model expects {len(layer_names)} ({layer_names})"
        )
    tree = {}
    for name, tf_vars in zip(layer_names, tf_layers):
        leaves = {}
        for var in ("kernel", "bias"):
            if var not in tf_vars:
                raise ValueError(f"{what}.{name}: checkpoint layer missing {var}")
            src, dst = tf_vars[var], model_shapes[name][var]
            if tuple(src.shape) != tuple(dst):
                raise ValueError(
                    f"{what}.{name}.{var}: shape {tuple(src.shape)} != model "
                    f"{tuple(dst)} — architecture/config mismatch"
                )
            leaves[var] = src
        tree[name] = leaves
    return tree


def import_tf_checkpoint(ref_dir: str, config: Optional[dict] = None, device="cuda",
                         timings: Optional[dict] = None):
    """``(model, config)``: a fresh ``VAEModel`` of the architecture of a
    reference log directory (``encoder/`` + ``decoder/`` SavedModels +
    ``config.yml``, or ``config`` when given) on ``device``, holding the
    SavedModels' weights cast to the model's dtype. No random weights are drawn
    and no Adam state is made.

    ``timings``, when given, receives ``read_s`` (parsing the indexes and
    copying every tensor out of the mapped shards into host memory) and
    ``load_s`` (the copy onto the device, synchronized)."""
    import torch

    from trustedai_cl_vae_ad_tpu_torch.bridge import params_from_flax, shape_to_flax
    from trustedai_cl_vae_ad_tpu_torch.config import load_config, validate_config
    from trustedai_cl_vae_ad_tpu_torch.models.wrapper import VAEModel
    from trustedai_cl_vae_ad_tpu_torch.registry import build_core_from_config

    if config is None:
        config = load_config(os.path.join(ref_dir, "config.yml"))
    config = validate_config(config)
    device = torch.device(device)
    core = build_core_from_config(config)  # meta: shapes only
    shapes: Dict[str, dict] = {"encoder": {}, "decoder": {}}
    for key, t in core.state_dict().items():
        part, _layers, layer, name = key.split(".")
        leaf = "kernel" if name == "weight" else name
        shapes[part].setdefault(layer, {})[leaf] = shape_to_flax(key, t.shape)
    names = {"encoder": encoder_layer_names(config), "decoder": decoder_layer_names(config)}

    # a part at a time: its shards stay mapped only until its tensors are on the device
    core = core.to_empty(device=device)
    read_s = load_s = 0.0
    loaded = set()
    for part in ("encoder", "decoder"):
        t0 = time.perf_counter()
        variables = read_savedmodel_variables(os.path.join(ref_dir, part))
        layers = _transplant(extract_weighted_layers(variables), shapes[part], names[part], part)
        del variables
        # one host copy of each tensor, out of the mapped shards
        state = params_from_flax({"encoder": {}, "decoder": {}, part: layers})
        del layers
        t1 = time.perf_counter()
        core.load_state_dict(state, strict=False)
        loaded.update(state)
        del state
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        read_s += t1 - t0
        load_s += time.perf_counter() - t1
    missing = sorted(set(core.state_dict()) - loaded)
    if missing:
        raise RuntimeError(f"{ref_dir}: no weights imported for {missing}")
    if timings is not None:
        timings.update(read_s=read_s, load_s=load_s)
    return VAEModel(core, device), config
