"""Read a subtree that the JAX package's orbax ``StandardCheckpointer`` wrote.

A log directory of ``trustedai_cl_vae_ad_tpu`` holds its ``encoder``,
``decoder``, ``optimizer`` and ``quantized`` subtrees as orbax checkpoints:
each leaf is a zarr array inside one OCDBT key-value store per subtree, and
the subtree's ``_METADATA`` lists the leaves with their keys:

    <subtree>/_METADATA            {"tree_metadata": {"('Conv_0', 'kernel')":
                                     {"key_metadata": [{"key": "Conv_0"}, ...],
                                      "value_metadata": {"value_type": ...,
                                                         "skip_deserialize": ...}}},
                                    "use_zarr3": ..., "use_ocdbt": true}
    <subtree>/manifest.ocdbt       the store's root
    <subtree>/_CHECKPOINT_METADATA {"commit_timestamp_nsecs": ...}

``tensorstore`` opens such a leaf by itself, as a zarr array in the
subtree's OCDBT store at the path of its keys joined by '.' (``_leaf_spec``),
and loads no jax, flax, optax or orbax, so this module reads a JAX-written
log directory in the port's process. ``tensorstore`` is imported
inside the function that reads: importing this module needs nothing beyond
the standard library and numpy, and a machine without tensorstore reads the
port's own log directories, or those that ``tools/convert_logdir_torch.py``
converted, with torch alone.

``subtree_shapes`` reads the leaves' shapes from ``_METADATA`` alone, and
``subtree_specs`` their shapes and dtypes from the zarr metadata through
tensorstore, reading no array. Where tensorstore does not import, every read
of an orbax subtree raises an ImportError that names the converter.

Leaves come back as numpy arrays in their stored dtype; bfloat16 ones as
ml_dtypes ``bfloat16``, which ``bridge.py`` moves into torch through their
uint16 bits, exactly. Entries orbax records without data (``None``, an empty
``Dict``: optax's ``EmptyState`` and ``hyperparams_states``) are left out.
"""

from __future__ import annotations

import json
import os

import numpy as np

METADATA_FILE = "_METADATA"
MANIFEST_FILE = "manifest.ocdbt"
CHECKPOINT_METADATA_FILE = "_CHECKPOINT_METADATA"


def is_orbax_subtree(path: str) -> bool:
    """A subtree orbax's ``StandardCheckpointer`` wrote: its ``_METADATA``
    beside the OCDBT store's ``manifest.ocdbt``."""
    return (os.path.isfile(os.path.join(path, METADATA_FILE))
            and os.path.isfile(os.path.join(path, MANIFEST_FILE)))


def _leaf_spec(subtree: str, keys, zarr3: bool) -> dict:
    return {"driver": "zarr3" if zarr3 else "zarr",
            "kvstore": {"driver": "ocdbt", "base": "file://" + os.path.abspath(subtree),
                        "path": ".".join(keys)}}


def _metadata(path: str) -> dict:
    if not is_orbax_subtree(path):
        raise FileNotFoundError(
            f"{path} is not an orbax subtree (no {METADATA_FILE} with {MANIFEST_FILE})")
    with open(os.path.join(path, METADATA_FILE)) as f:
        return json.load(f)


def _leaf_keys(meta: dict) -> list:
    return [[str(k["key"]) for k in entry["key_metadata"]]
            for entry in meta["tree_metadata"].values()
            # None, EmptyState, an empty Dict: no data
            if not entry.get("value_metadata", {}).get("skip_deserialize")]


def subtree_keys(path: str) -> list:
    """The key path (a list of strings) of each leaf with data, from the
    subtree's ``_METADATA`` alone."""
    return _leaf_keys(_metadata(path))


def subtree_shapes(path: str) -> dict:
    """{key path (a tuple of strings): shape} of each leaf with data, from the
    subtree's ``_METADATA`` alone (each entry's ``value_metadata.write_shape``;
    no tensorstore). That is the shape of the piece one process wrote: the
    leaf's own shape unless the array was saved sharded, which only
    ``subtree_specs`` sees."""
    meta = _metadata(path)
    out = {}
    for entry in meta["tree_metadata"].values():
        value = entry.get("value_metadata", {})
        if not value.get("skip_deserialize"):
            keys = tuple(str(k["key"]) for k in entry["key_metadata"])
            out[keys] = tuple(int(d) for d in value["write_shape"])
    return out


def import_tensorstore(path: str):
    """The ``tensorstore`` module, or an ImportError that says why the port
    needs it for ``path`` and what to do without it."""
    try:
        import tensorstore
    except ImportError as err:
        raise ImportError(
            f"{path} is an orbax checkpoint of the JAX package, which the port reads only "
            "through tensorstore, and tensorstore does not import here: convert the log "
            "directory with tools/convert_logdir_torch.py where it does") from err
    return tensorstore


def _open_leaves(path: str):
    """(keys, tensorstore handle) of each leaf with data; opening reads the
    zarr metadata of a leaf, not its data."""
    meta = _metadata(path)
    ts = import_tensorstore(path)
    if not meta.get("use_ocdbt", True):
        raise ValueError(f"{path}: orbax wrote it without OCDBT, which this reader does not take")
    zarr3 = bool(meta.get("use_zarr3", False))
    for keys in _leaf_keys(meta):
        yield keys, ts.open(_leaf_spec(path, keys, zarr3), open=True, read=True).result()


def subtree_specs(path: str) -> dict:
    """{key path (a tuple of strings): (shape, dtype name)} of each leaf with
    data, from the leaves' zarr metadata in the OCDBT store (through
    tensorstore; no array is read)."""
    return {tuple(keys): (tuple(int(d) for d in store.shape), store.dtype.name)
            for keys, store in _open_leaves(path)}


def read_subtree(path: str) -> dict:
    """The subtree at ``path`` as a nested dict {key: ... {key: numpy array}}
    (sequence indices stay strings, as orbax writes them)."""
    tree: dict = {}
    for keys, store in _open_leaves(path):
        node = tree
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = np.asarray(store.read().result())
    return tree


def commit_timestamp_nsecs(path: str):
    """orbax's ``commit_timestamp_nsecs`` of a subtree, or None."""
    try:
        with open(os.path.join(path, CHECKPOINT_METADATA_FILE)) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return None
    return meta.get("commit_timestamp_nsecs") if isinstance(meta, dict) else None
