"""Checkpoints of a log directory: crash-atomic rounds behind stable names.

Counterpart of ``trustedai_cl_vae_ad_tpu/train/checkpoint.py``, with the same
layout and the same function names, and PyTorch's own payloads in place of
orbax trees. A log directory holds, beside ``config.yml`` and
``train_state.json``:

    <logdir>/rounds/.tmp-00000007/       staging: a save writes here
    <logdir>/rounds/00000007/            os.rename(.tmp-N, N): the round is durable
        encoder/params.pt                {state-dict key: tensor} of the encoder
        decoder/params.pt                the same for the decoder
        optimizer/state.pt               {"count", "learning_rate", "mu/<key>",
                                          "nu/<key>"} (optional; a moment that
                                          adam_fp8 quantized is "mu/<key>/q",
                                          ".../scale", ".../scale_next")
    <logdir>/current -> rounds/00000007          atomic symlink swap: the commit point
    <logdir>/encoder -> current/encoder          stable names, created once
    <logdir>/decoder -> current/decoder
    <logdir>/optimizer -> current/optimizer      (while the current round holds one)

Each file is a plain dict of CPU tensors written by ``torch.save`` and read
with ``torch.load(weights_only=True)``, which unpickles tensors and plain
containers only.

Crash atomicity. Replacing ``encoder/``, ``decoder/`` and ``optimizer/`` one
file at a time is not crash-safe: a SIGKILL or an out-of-memory kill between
two files leaves parts of two saves that load without error. So every save
stages a whole round in a sibling directory and publishes it with single
atomic renames. No code path deletes the newest complete round: a kill at any
point leaves either the previous round (staging or commit unfinished) or the
new one (pointer swapped), whole and consistent across the three subtrees.
The last two complete rounds are kept (``TCVAE_CKPT_KEEP_ROUNDS`` changes
that; 1 drops the rollback copy where disk is short); older rounds and stale
``.tmp-*`` staging directories of killed saves are swept by the next save.
Restoring follows ``current`` when it points at a complete round, falls back
to the newest complete round, and still reads flat log directories (real
``encoder/``, ``decoder/``, ``optimizer/`` directories, as earlier versions of
this package wrote them); the first new save upgrades those, removing the
flat copy only once a complete round supersedes it.

A kill is survived, a power loss is not promised: nothing is fsynced.

Log directories of the JAX package. Its rounds, ``current`` and stable names
are the same; only the subtrees differ: orbax checkpoints (``_METADATA`` and
an OCDBT store, read by ``train/orbax_read.py`` through tensorstore) in place
of ``params.pt`` and ``state.pt``. ``restore_params`` and
``restore_optimizer_state`` read either, choosing by what the subtree holds,
and carry the JAX trees across ``bridge.py``. The optimizer tree is optax's
``inject_hyperparams`` state: ``count``, ``hyperparams/{learning_rate, ...}``
and ``inner_state/0/{count, mu, nu}`` (``adam`` and ``adam_lean``); the
moments' step count comes from ``inner_state/0/count`` and the learning rate
from ``hyperparams/learning_rate``. ``adam_fp8``'s tree keeps each moment as
a list in the flattened parameter tree's order (``mu/<i>``: an array, or
``{q, scale, scale_next}`` for a quantized leaf); the parameters' keys in
the encoder's and decoder's ``_METADATA`` give each index its name
(``bridge.fp8_moments_from_optax``).
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from trustedai_cl_vae_ad_tpu_torch.bridge import (
    fp8_moments_from_optax,
    opt_state_from_optax,
    params_from_flax,
)
from trustedai_cl_vae_ad_tpu_torch.train.orbax_read import (
    MANIFEST_FILE,
    METADATA_FILE,
    is_orbax_subtree,
    read_subtree,
    subtree_keys,
)

PARTS = ("encoder", "decoder")
PARAMS_FILE = "params.pt"
OPTIMIZER_DIR = "optimizer"
OPTIMIZER_FILE = "state.pt"
ROUNDS_SUBDIR = "rounds"
CURRENT_LINK = "current"
_TMP_PREFIX = ".tmp-"
_SUBTREES = PARTS + (OPTIMIZER_DIR,)
#: tensors below this size go to the host in one plain copy
_STAGED_COPY_MIN_BYTES = 1 << 20


def _test_pause(point: str) -> None:
    """Crash-injection hook of the kill-during-save tests (a no-op unless
    TCVAE_CKPT_TEST_PAUSE is set, e.g. "before_commit:10"). Prints a marker
    and sleeps, so that a test can SIGKILL the process inside one window of a
    save or a commit."""
    spec = os.environ.get("TCVAE_CKPT_TEST_PAUSE")
    if not spec:
        return
    for part in spec.split(","):
        name, _, secs = part.partition(":")
        if name.strip() == point:
            print(f"CKPT-PAUSE:{point}", flush=True)
            time.sleep(float(secs or 5.0))


def _round_name(n: int) -> str:
    return f"{n:08d}"


def _complete_rounds(rounds_path: str) -> List[Tuple[int, str]]:
    """Sorted [(n, name)] of the committed (atomically renamed) rounds."""
    out = []
    try:
        names = os.listdir(rounds_path)
    except OSError:
        return out
    for name in names:
        if name.startswith(_TMP_PREFIX):
            continue
        try:
            out.append((int(name), name))
        except ValueError:
            continue
    out.sort()
    return out


def _atomic_symlink(target: str, link_path: str) -> None:
    """Replace ``link_path`` with a symlink to ``target`` atomically (a
    symlink at a temporary name, then ``os.replace``): a reader never sees a
    missing or half-made link."""
    tmp = link_path + ".swp"
    if os.path.lexists(tmp):
        os.remove(tmp)
    os.symlink(target, tmp)
    os.replace(tmp, link_path)


def _stage_round(log_dir: str) -> Tuple[str, int]:
    """Allocate the next round number and return (its staging path, n). Sweeps
    the ``.tmp-*`` staging directories that killed or failed saves left:
    nothing can be in flight here, since synchronous saves are serial and
    ``AsyncSaver`` drains its round before it stages the next."""
    log_dir = os.path.abspath(log_dir)
    rounds_path = os.path.join(log_dir, ROUNDS_SUBDIR)
    os.makedirs(rounds_path, exist_ok=True)
    for name in os.listdir(rounds_path):
        if name.startswith(_TMP_PREFIX):
            shutil.rmtree(os.path.join(rounds_path, name), ignore_errors=True)
    rounds = _complete_rounds(rounds_path)
    n = rounds[-1][0] + 1 if rounds else 1
    return os.path.join(rounds_path, _TMP_PREFIX + _round_name(n)), n


def _commit_round(log_dir: str, tmp_path: str, n: int) -> None:
    """Publish a fully written staging directory as round ``n``.

    Three ordered steps, each atomic, so a kill between any two leaves a
    consistent log directory: (1) rename staging -> round (the round is
    durable); (2) swap the ``current`` symlink (restoring now prefers it);
    (3) housekeeping: the stable symlinks (a flat in-place directory is
    removed only now that a complete round supersedes it; no name is left
    dangling, which would break tools that walk or copy the directory) and
    the removal of all but the last rounds."""
    log_dir = os.path.abspath(log_dir)
    rounds_path = os.path.dirname(tmp_path)
    name = _round_name(n)
    os.rename(tmp_path, os.path.join(rounds_path, name))
    _test_pause("mid_commit")
    cur = os.path.join(log_dir, CURRENT_LINK)
    if os.path.isdir(cur) and not os.path.islink(cur):
        # a copy that followed symlinks (cp -r, rsync without -l, shutil.copytree)
        # made 'current' a real directory; the new round is durable, so it may go
        shutil.rmtree(cur)
    _atomic_symlink(os.path.join(ROUNDS_SUBDIR, name), cur)
    _test_pause("after_pointer")
    for sub in _SUBTREES:
        p = os.path.join(log_dir, sub)
        present = os.path.isdir(os.path.join(rounds_path, name, sub))
        if os.path.islink(p):
            if not present:
                os.remove(p)  # a save without the moments: the name would dangle
            continue
        if os.path.isdir(p):
            shutil.rmtree(p)  # a flat in-place subtree, superseded by the round
        if present:
            _atomic_symlink(os.path.join(CURRENT_LINK, sub), p)
    # each round is a full copy (16 GB for the flagship in float32 with its
    # moments); old rounds go only after the new one is durable and pointed at
    keep = max(1, int(os.environ.get("TCVAE_CKPT_KEEP_ROUNDS", "2")))
    for _rn, rname in _complete_rounds(rounds_path)[:-keep]:
        shutil.rmtree(os.path.join(rounds_path, rname), ignore_errors=True)


def resolve_round_dir(log_dir: str) -> str:
    """The directory that holds the subtrees to restore: the round ``current``
    points at when that round is complete, else the newest complete round,
    else ``log_dir`` itself (the flat layout)."""
    log_dir = os.path.abspath(log_dir)
    rounds_path = os.path.join(log_dir, ROUNDS_SUBDIR)
    rounds = _complete_rounds(rounds_path)
    if not rounds:
        return log_dir
    names = {rname for _, rname in rounds}
    cur = os.path.join(log_dir, CURRENT_LINK)
    if os.path.islink(cur):
        tname = os.path.basename(os.readlink(cur).rstrip("/"))
        if tname in names:
            return os.path.join(rounds_path, tname)
    return os.path.join(rounds_path, rounds[-1][1])


# -- payloads -----------------------------------------------------------------------------------

def _payload_file(sub: str) -> str:
    return OPTIMIZER_FILE if sub == OPTIMIZER_DIR else PARAMS_FILE


def _subtrees(params: Dict[str, torch.Tensor], opt_state: Optional[dict]
              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{subtree: {key: live tensor}} of one round, in writing order."""
    trees: Dict[str, Dict[str, torch.Tensor]] = {}
    for part in PARTS:
        sub = {k: v for k, v in params.items() if k.startswith(part + ".")}
        if not sub:
            raise KeyError(f"no parameters named {part}.* to save")
        trees[part] = sub
    if opt_state is not None:
        flat = {"count": torch.tensor(int(opt_state["count"]), dtype=torch.int64)}
        if opt_state.get("learning_rate") is not None:
            # a float32 value, as optax's injected hyperparameter is stored
            flat["learning_rate"] = torch.tensor(float(opt_state["learning_rate"]),
                                                 dtype=torch.float32)
        for kind in ("mu", "nu"):
            for k, v in opt_state[kind].items():
                if isinstance(v, dict):  # adam_fp8's quantized leaf
                    flat.update({f"{kind}/{k}/{field}": t for field, t in v.items()})
                else:
                    flat[f"{kind}/{k}"] = v
        trees[OPTIMIZER_DIR] = flat
    return trees


def _to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu") for k, v in tensors.items()}


def _write_payload(obj: Dict[str, torch.Tensor], staging: str, sub: str) -> None:
    """One subtree's file inside a staging directory (no temporary name: the
    whole directory is published by one rename)."""
    os.makedirs(os.path.join(staging, sub), exist_ok=True)
    torch.save(obj, os.path.join(staging, sub, _payload_file(sub)))


def save_checkpoint(logdir: str, params: Dict[str, torch.Tensor],
                    opt_state: Optional[dict] = None, mesh=None) -> int:
    """Write one crash-atomic round into ``logdir``: the weights (and the
    optimizer state, when given) are staged under ``rounds/.tmp-N``, one
    subtree on the host at a time, then committed. A kill at any point keeps
    the previous complete round. Returns the round number N.

    On a mesh of ranks (``parallel/``) every rank calls it: global rank 0
    stages, writes and commits the round with the whole state it was given
    (the others' arguments are not read); the round number is broadcast, and
    every rank returns once the round is committed. The files are those a
    single device writes."""
    import torch.distributed as dist

    distributed = mesh is not None and mesh.distributed
    logdir = os.path.abspath(logdir)
    n = 0
    if not distributed or mesh.is_primary:
        trees = _subtrees(params, opt_state)
        os.makedirs(logdir, exist_ok=True)
        tmp_path, n = _stage_round(logdir)
    if distributed:
        box = [n]
        dist.broadcast_object_list(box, src=0)
        n = box[0]
    if not distributed or mesh.is_primary:
        for i, (sub, tensors) in enumerate(trees.items()):
            _write_payload(_to_host(tensors), tmp_path, sub)
            if i == 0:
                _test_pause("between_subtrees")
        _test_pause("before_commit")
        _commit_round(logdir, tmp_path, n)
    if distributed:
        dist.barrier()
    return n


class AsyncSaver:
    """Checkpoint writes that do not block training (``training.async_checkpoint``).

    A periodic save blocks training for the whole write of the weights and
    the Adam moments. Here ``save`` returns as soon as the state is safely
    off the training tensors, and a writer thread writes the files.
    ``Adam.step`` updates parameters and moments IN PLACE, so the copy must be
    complete, not merely queued, when ``save`` returns, or the round would mix
    two steps: a CUDA tensor is copied into host memory through two pinned
    buffers of ``pinned_bytes`` each (the copy of one piece overlaps the host's
    move of the previous one; the state is never pinned whole) and the device
    is waited for; a CPU tensor is cloned.

    At most one round is in flight: ``save`` first waits out (and commits) the
    previous one. Rounds use the staging and commit of the synchronous path;
    the commit happens inside ``wait``, after the writer finished. Commit
    callbacks (the ``train_state.json`` sidecar) run only after the commit: a
    sidecar must never record progress that the weights do not durably have.
    If the write failed, the round never commits, its callbacks are dropped
    (a later round or the final synchronous save writes a consistent pair)
    and the error is raised; the next save sweeps the orphaned staging
    directory.
    """

    def __init__(self, pinned_bytes: int = 256 << 20):
        self._pinned_bytes = int(pinned_bytes)
        self._bounce: Optional[List[torch.Tensor]] = None
        self._thread: Optional[threading.Thread] = None
        self._errors: List[Exception] = []
        self._pending_callbacks: List[Callable[[], None]] = []
        self._pending_commit: Optional[Tuple[str, str, int]] = None

    # -- the copy off the training tensors ----------------------------------------------------
    def _staged_copy(self, t: torch.Tensor) -> torch.Tensor:
        """A host copy of a CUDA tensor, complete on return."""
        nbytes = t.numel() * t.element_size()
        if nbytes < _STAGED_COPY_MIN_BYTES:
            return t.detach().to("cpu")
        if self._bounce is None:
            self._bounce = [torch.empty(self._pinned_bytes, dtype=torch.uint8, pin_memory=True)
                            for _ in range(2)]
        src = t.detach().contiguous().view(-1).view(torch.uint8)
        out = torch.empty(t.shape, dtype=t.dtype)
        dst = out.view(-1).view(torch.uint8)
        events = [torch.cuda.Event(), torch.cuda.Event()]
        pieces = [(off, min(self._pinned_bytes, nbytes - off))
                  for off in range(0, nbytes, self._pinned_bytes)]
        # piece k leaves the device while the host moves piece k - 1 out of its buffer
        for k in range(len(pieces) + 1):
            if k < len(pieces):
                off, length = pieces[k]
                self._bounce[k % 2][:length].copy_(src[off:off + length], non_blocking=True)
                events[k % 2].record()
            if k > 0:
                off, length = pieces[k - 1]
                events[(k - 1) % 2].synchronize()
                dst[off:off + length].copy_(self._bounce[(k - 1) % 2][:length])
        return out

    def _snapshot(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: self._staged_copy(v) if v.is_cuda else v.detach().clone()
                for k, v in tensors.items()}

    # -- rounds ---------------------------------------------------------------------------------
    def save(self, log_dir: str, params: Dict[str, torch.Tensor],
             opt_state: Optional[dict] = None) -> None:
        """Start a background write of one round; returns once every tensor
        has been copied off the training state."""
        self.wait()  # one round in flight; this also commits the previous one
        trees = _subtrees(params, opt_state)
        log_dir = os.path.abspath(log_dir)
        os.makedirs(log_dir, exist_ok=True)
        tmp_path, n = _stage_round(log_dir)
        payloads = {sub: self._snapshot(tensors) for sub, tensors in trees.items()}

        def write() -> None:
            try:
                for sub, obj in payloads.items():
                    _write_payload(obj, tmp_path, sub)
            except Exception as err:  # noqa: BLE001 - handed to wait(), which raises it
                self._errors.append(err)

        self._thread = threading.Thread(target=write, name="checkpoint-writer", daemon=True)
        self._thread.start()
        self._pending_commit = (log_dir, tmp_path, n)

    def add_commit_callback(self, cb: Callable[[], None]) -> None:
        """Run ``cb`` once the round in flight is committed."""
        self._pending_callbacks.append(cb)

    def wait(self) -> None:
        """Block until the round in flight (if any) is written, commit it,
        then run its callbacks. After a failed write the round is abandoned
        (no commit, callbacks dropped) and the first error is raised, once the
        writer thread has ended."""
        callbacks, self._pending_callbacks = self._pending_callbacks, []
        commit, self._pending_commit = self._pending_commit, None
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        errors, self._errors = self._errors, []
        if errors:
            raise errors[0]
        if commit is not None:
            _commit_round(*commit)
        for cb in callbacks:
            cb()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._bounce = None


# -- restoring ----------------------------------------------------------------------------------

def _is_port_subtree(path: str, sub: str) -> bool:
    return os.path.isfile(os.path.join(path, _payload_file(sub)))


def _subtree_layout(path: str, sub: str) -> str:
    """'port' (``params.pt`` / ``state.pt``) or 'orbax' (the JAX package's
    ``_METADATA`` and OCDBT store), by what the subtree holds."""
    if _is_port_subtree(path, sub):
        return "port"
    if is_orbax_subtree(path):
        return "orbax"
    raise FileNotFoundError(
        f"{path}: not a log directory written by this package's save_model (no "
        f"{_payload_file(sub)}) nor by the JAX package's (no orbax subtree: {METADATA_FILE} "
        f"with {MANIFEST_FILE})")


def has_optimizer(logdir: str) -> bool:
    """Whether the round that restoring reads holds Adam moments, in either
    layout."""
    path = os.path.join(resolve_round_dir(logdir), OPTIMIZER_DIR)
    return _is_port_subtree(path, OPTIMIZER_DIR) or is_orbax_subtree(path)


def _load(path: str, map_location) -> dict:
    return torch.load(path, map_location=map_location, weights_only=True)


def _moved(state: Dict[str, torch.Tensor], map_location) -> Dict[str, torch.Tensor]:
    return {k: v.to(map_location) for k, v in state.items()}


def restore_params(logdir: str, map_location="cpu") -> Dict[str, torch.Tensor]:
    """The full state dict of the core from the round ``resolve_round_dir``
    selects (or from a flat log directory), in the port's layout or the JAX
    package's."""
    base = resolve_round_dir(logdir)
    paths = {part: os.path.join(base, part) for part in PARTS}
    layouts = {_subtree_layout(path, part) for part, path in paths.items()}
    if layouts == {"port"}:
        out: Dict[str, torch.Tensor] = {}
        for path in paths.values():
            out.update(_load(os.path.join(path, PARAMS_FILE), map_location))
        return out
    if layouts != {"orbax"}:
        raise ValueError(f"{base}: encoder and decoder are in different layouts")
    tree = {part: read_subtree(path) for part, path in paths.items()}
    return _moved(params_from_flax(tree), map_location)


def _param_names(base: str) -> List[str]:
    """The state-dict keys of a JAX round's parameters, from its subtrees'
    ``_METADATA`` alone (no array is read)."""
    return [f"{part}.layers.{layer}.{'weight' if leaf == 'kernel' else leaf}"
            for part in PARTS for layer, leaf in subtree_keys(os.path.join(base, part))]


def _optax_adam_state(tree: dict, path: str) -> dict:
    """The dict ``Adam.load_state_dict`` (or ``AdamFp8.load_state_dict``)
    takes, from the JAX package's optimizer tree (``inject_hyperparams``'
    layout)."""
    inner = tree.get("inner_state", {}).get("0", {})
    mu, nu = inner.get("mu"), inner.get("nu")
    if not isinstance(mu, dict) or not isinstance(nu, dict) or "count" not in inner:
        raise ValueError(f"{path}: not an optax Adam state (no inner_state/0/count, mu, nu)")
    learning_rate = tree.get("hyperparams", {}).get("learning_rate")
    if set(mu) <= set(PARTS):
        return opt_state_from_optax(inner["count"], mu, nu, learning_rate=learning_rate)
    # adam_fp8: the moments are lists ('0', '1', ...) in the parameters' flattened order
    names = _param_names(os.path.dirname(path))
    state = {"count": int(inner["count"]), "mu": fp8_moments_from_optax(mu, names),
             "nu": fp8_moments_from_optax(nu, names)}
    if learning_rate is not None:
        state["learning_rate"] = float(np.asarray(learning_rate, dtype=np.float64))
    return state


def restore_optimizer_state(logdir: str, map_location="cpu") -> dict:
    """{'count', 'learning_rate', 'mu', 'nu'} as ``ops.adam.Adam.load_state_dict``
    (and ``ops.adam8.AdamFp8``'s) takes it, from the same round as ``restore_params`` reads. The port's
    checkpoints written before the learning rate was saved give
    ``learning_rate`` None."""
    path = os.path.join(resolve_round_dir(logdir), OPTIMIZER_DIR)
    if _subtree_layout(path, OPTIMIZER_DIR) == "orbax":
        state = _optax_adam_state(read_subtree(path), path)
        for kind in ("mu", "nu"):
            state[kind] = {k: _moved(v, map_location) if isinstance(v, dict)
                           else v.to(map_location) for k, v in state[kind].items()}
        return state
    flat = _load(os.path.join(path, OPTIMIZER_FILE), map_location)
    state: dict = {"count": int(flat["count"]), "learning_rate": None, "mu": {}, "nu": {}}
    if "learning_rate" in flat:
        state["learning_rate"] = float(flat["learning_rate"])
    for key, t in flat.items():
        if key not in ("count", "learning_rate"):
            kind, name = key.split("/", 1)
            if "/" in name:  # a field of adam_fp8's quantized leaf
                name, field = name.split("/")
                state[kind].setdefault(name, {})[field] = t
            else:
                state[kind][name] = t
    return state
