"""Multi-camera batched streaming inference, scoring and fleet continual learning.

Counterpart of ``trustedai_cl_vae_ad_tpu/stream/multicam.py::MultiCameraEngine``.
One model serves K camera streams: a tick uploads the K uint8 frames as one
batch, normalizes and resizes them on the device, runs ONE forward for all of
them (float, or int8 through ``ops/quant.py``: the weights are read once per
tick, whatever K is) and one launch of the stream-scorer kernel over a grid of
K frames (``ops/stream_score.py::stream_score_step_batched``; the JAX engine
runs a vmapped jnp reference there), then fetches the K [score, count] pairs
in one copy and advances K host-side state machines. The scorer state is
batched: maps (K, 2, H, W), scalars (K, 6).

A camera that drops a tick is handled with a validity mask: that stream's
EMA state is left untouched, its result is None and its score would be NaN.

Also: the per-stream state machines with fixed and per-stream CDF
thresholds, ``new_task`` / ``reset_stream``, mixed camera resolutions (host
resize onto the pinned batch shape), the provisional warm-up pin, pipelined
mode with ``flush``, int8 serving (``quantize=`` / ``qparams=``), and what the
single-stream engine (``stream/engine.py``) does for one camera, lifted to the
fleet:

  * fleet continual learning: every tick stores its model-size float batch in
    slot ``tick % T`` of a (T, K, H, W, C) device ring, with the validity
    mask as that slot's row weights; at its cadence ONE gradient step on the
    T·K rows (plus a shared capacity-padded replay buffer) trains the shared
    weights on every camera's scene at once; dropped frames and padding weigh
    0. The ring and Adam's moments are allocated at the first enabled tick;
  * per-camera recording: one subtree of five PNG streams and one
    ``labels.json`` per camera, one model snapshot for the fleet;
  * autosave into ``model_cache_dir`` on the single-stream engine's schedule.

A device mesh (``mesh=``, ``parallel.mesh.make_mesh`` over local devices, as
``camera_streamer_torch.py --mesh`` builds it) scales the fleet over devices,
as the JAX engine shards its K streams over chips. The streams split into
contiguous blocks of K/D, one a device of the mesh; each device holds its
block's scorer state and fleet-CL ring, its rows of the replay buffer, and a
replica of the serving parameters (``parallel.mesh.replicate``: the float
parameters or the int8 tree, made once and refreshed after each CL step). A
tick launches every block's normalize, resize, forward and scorer launch
before it reads any result, then fetches each block's [score, count] pairs
once. A fleet CL step equals the unsharded engine's step: each device runs
the forward of its rows on its replica (the latent noise of the whole
stacked batch is drawn at once and given to rows by their global index), x,
x_hat, z, mean and logvar come to the mesh's first device in copies that
autograd differentiates, and the loss's batch statistics are taken there
over the union of every block's rows in the unsharded row order. The
replicas' gradients are summed onto the first device's parameters (a
replica that IS those tensors, as when the mesh lists one device twice,
counts once), the optimizer steps there and the replicas are refreshed. The
mesh's first device must be the model's.
"""

from __future__ import annotations

import datetime
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from trustedai_cl_vae_ad_tpu_torch.anomaly.cdf import CDFObject, threshold_from_cdf
from trustedai_cl_vae_ad_tpu_torch.data.ingest import resize_images
from trustedai_cl_vae_ad_tpu_torch.ops import moments, stream_score
from trustedai_cl_vae_ad_tpu_torch.ops.quant import serving_forward
from trustedai_cl_vae_ad_tpu_torch.parallel.mesh import Mesh, local_device, replicate
from trustedai_cl_vae_ad_tpu_torch.stream.engine import (
    RECORD_STREAMS,
    AutosaveControls,
    _to_u8,
    cl_batch,
    decode_filelist_to_model_res,
    parse_replay_file,
    record_frame_artifacts,
    save_model_dir,
    validate_anomaly_settings,
    warm_cl_backward,
    write_coco_labels,
)
from trustedai_cl_vae_ad_tpu_torch.utils.profiling import defer_signals


class _Detailed(nn.Module):
    """``core.call_detailed`` in training mode as a module's forward, so that
    ``torch.func.functional_call`` runs it over a replica's parameters."""

    def __init__(self, core):
        super().__init__()
        self.core = core

    def forward(self, x, eps):
        return self.core.call_detailed(x, training=True, eps=eps)


def _block_devices(mesh, n_streams: int, device: torch.device) -> List[torch.device]:
    """The device of each block of streams: the model's alone without a mesh;
    on a one-process mesh each of its devices, the first the model's."""
    if mesh is None:
        return [device]
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh), not {type(mesh).__name__}")
    if mesh.distributed:
        raise ValueError("the multi-camera engine runs in one process: make_mesh over the local "
                         "devices (devices=...), not over the ranks of a process group")
    devices = [local_device(d) for d in mesh.devices]
    if n_streams % len(devices):
        raise ValueError(f"n_streams {n_streams} must divide over {len(devices)} devices")
    if devices[0] != device:
        raise ValueError(f"the mesh's first device {devices[0]} is not the model's {device}: "
                         "fleet continual learning steps the parameters there")
    return devices


@dataclass
class StreamStatus:
    score: float
    score_ma: float
    pixel_count: float
    anomalous: bool
    _norm_dev: object = None
    _rec_dev: object = None
    # memoized host copies: each fetch is a device->host round trip, and a
    # reader of the same map twice per tick must not pay for two
    _norm_np: object = None
    _rec_np: object = None

    @property
    def norm_err_u8(self) -> np.ndarray:
        if self._norm_np is None:
            self._norm_np = self._norm_dev.cpu().numpy()
        return self._norm_np

    @property
    def reconstruction_u8(self) -> np.ndarray:
        if self._rec_np is None:
            self._rec_np = self._rec_dev.cpu().numpy()
        return self._rec_np


class MultiCameraEngine(AutosaveControls):
    def __init__(
        self,
        model,
        config: dict,
        n_streams: int,
        anomaly_settings: Optional[dict] = None,
        stream_error_ma: float = 0.99,
        anomaly_ma_weight: float = 0.9,
        quantize: bool = False,
        model_cache_dir: Optional[str] = None,
        pipelined: bool = False,
        mesh=None,
        qparams: Optional[dict] = None,
        continuous_learning_period_ms: float = 500.0,
        cl_ring_ticks: int = 4,
        metrics=None,
        autosave_period_s: float = 5 * 60.0,
        replay_capacity: int = 64,
        async_autosave: bool = False,
    ):
        if n_streams < 1:
            raise ValueError(f"n_streams must be at least 1, got {n_streams}")
        self.model = model
        self.device = local_device(model.device)
        self.mesh = mesh
        #: the device of each block of streams (one block without a mesh)
        self.block_devices = _block_devices(mesh, int(n_streams), self.device)
        self._block = int(n_streams) // len(self.block_devices)  # streams a block
        # ``qparams`` is a tree that is already quantized
        # (load_quantized_checkpoint): the int8-checkpoint boot, where
        # model.params may be None and fleet continual learning raises
        self.quantized = bool(quantize) or qparams is not None
        self.config = config
        self.n_streams = int(n_streams)
        if anomaly_settings is not None:
            validate_anomaly_settings(anomaly_settings)
        self.anomaly_settings = anomaly_settings
        self.stream_error_ma = float(stream_error_ma)
        self.anomaly_ma_weight = float(anomaly_ma_weight)

        size = config["data"]["image_size"]
        self.height, self.width, self.channels = int(size[0]), int(size[1]), int(size[2])
        k = self.n_streams
        # the scorer state, one block of streams a device
        self._maps = [torch.zeros((self._block, 2, self.height, self.width), dtype=torch.float32,
                                  device=d) for d in self.block_devices]
        self._scalars = [torch.zeros((self._block, 6), dtype=torch.float32, device=d)
                         for d in self.block_devices]

        self.score_ma = np.zeros(k, np.float64)
        self.anomalous = np.zeros(k, bool)
        self.anomalous_start: list = [None] * k

        # per-stream CDF thresholding (anomaly_score_method 'cdf'), as the
        # single-stream engine's per-task mechanism: each stream keeps its own
        # score history, so a task or camera change on one stream re-derives
        # only ITS threshold
        self._score_history = [deque(maxlen=1024) for _ in range(k)]
        self._cdf: list = [None] * k
        self._cdf_dirty = [0] * k
        self._task_scored = [0] * k  # per-stream cdf_warmup_skip counters

        self._ref_shape = None  # pinned at the first tick
        self._warm_pin = False  # _ref_shape came from warmup, not from a real tick
        self._resize_warned: set = set()

        # pipelined mode: dispatch tick N, return tick N-1's results, so the
        # device computes while the host fetches the next frames
        self.pipelined = bool(pipelined)
        self._pending = None
        self.last_emitted_tag = None

        # fleet continual learning: ONE step on the union of every stream's
        # last ``cl_ring_ticks`` ticks; the ring and the optimizer's moments
        # are allocated at the first enabled tick (_ensure_cl)
        self.enable_cont_learning = False
        self.continuous_learning_period_ms = float(continuous_learning_period_ms)
        self.cl_ring_ticks = int(cl_ring_ticks)
        self.metrics = metrics
        self.cl_epochs = 0
        self.last_epoch_loss: Optional[dict] = None
        self.model_changed_flag = False
        self._last_cl_t = 0.0
        # per block, (T, K / D, H, W, C) float32
        self._cl_rings: Optional[List[torch.Tensor]] = None
        self._cl_valid: Optional[np.ndarray] = None  # (T, K) row weights
        self._cl_tick = 0

        # the replay buffer the fleet shares, capacity-padded as the
        # single-stream engine's (padding rows weigh 0), in blocks of rows
        # over the devices
        self.replay_capacity = int(replay_capacity)
        self._replay_blocks: Optional[List[torch.Tensor]] = None
        self.replay_n = 0
        self.replay_buffer_paths: Optional[list] = None

        # per-stream recording: the single-stream engine's instance layout,
        # one subtree per stream
        self.recording_flag = False
        self.record_dir: Optional[str] = None
        self.record_instance_dir: Optional[str] = None
        self.record_period_ms = 500.0
        self._last_record_t = 0.0
        self._stream_names: Optional[List[str]] = None
        self._anomaly_score_maps: Optional[List[dict]] = None

        # autosave (AutosaveControls): fleet CL changes the shared weights,
        # so the single-stream engine's cycle applies; the schedule flag
        # starts clear here, as in the JAX fleet engine
        self.model_cache_dir = model_cache_dir
        self.autosave_period_s = float(autosave_period_s)
        self.async_autosave = bool(async_autosave)
        self._async_saver = None
        self.schedule_model_save_flag = False
        self._last_autosave_t: Optional[float] = None

        self._forward, tree = serving_forward(
            model.core, model.params, quantize=self.quantized, qparams=qparams)
        #: per block, the float parameters on its device (the model's own on
        #: the first device; copies elsewhere, which the CL step differentiates)
        self._param_replicas: Optional[List[dict]] = None
        if not self.quantized:
            self._param_replicas = self._float_replicas()
        #: per block, what its forward reads: the float replica or the int8 tree
        self._serve_replicas = (self._replicate(tree) if self.quantized
                                else self._param_replicas)
        self._detailed = _Detailed(model.core)

    # ------------------------------------------------------------ blocks
    def _replicate(self, tree) -> List[dict]:
        return [tree] if self.mesh is None else replicate(tree, self.mesh)

    def _float_replicas(self) -> List[dict]:
        replicas = self._replicate(self.model.params)
        for device, replica in zip(self.block_devices, replicas):
            if device != self.device:
                for t in replica.values():
                    t.requires_grad_(True)
        return replicas

    def _split(self, t: torch.Tensor) -> List[torch.Tensor]:
        """A (K, ...) tensor in blocks of streams, each on its device."""
        b = self._block
        return [t[j * b:(j + 1) * b].to(d) for j, d in enumerate(self.block_devices)]

    def _joined(self, blocks: List[torch.Tensor], dim: int = 0) -> torch.Tensor:
        """Blocks joined on the first device (the one block itself)."""
        if len(blocks) == 1:
            return blocks[0]
        return torch.cat([b.to(self.device) for b in blocks], dim=dim)

    @property
    def maps(self) -> torch.Tensor:
        """The scorer's maps (K, 2, H, W); on a mesh a copy on the first device."""
        return self._joined(self._maps)

    @maps.setter
    def maps(self, value: torch.Tensor) -> None:
        self._maps = self._split(value)

    @property
    def scalars(self) -> torch.Tensor:
        """The scorer's scalars (K, 6); on a mesh a copy on the first device."""
        return self._joined(self._scalars)

    @scalars.setter
    def scalars(self, value: torch.Tensor) -> None:
        self._scalars = self._split(value)

    @property
    def _serve_params(self):
        """The first device's serving tree."""
        return self._serve_replicas[0]

    @property
    def _cl_ring(self) -> Optional[torch.Tensor]:
        """The fleet ring (T, K, H, W, C), None before the first CL tick; on a
        mesh a copy on the first device."""
        return None if self._cl_rings is None else self._joined(self._cl_rings, dim=1)

    @property
    def replay_buffer(self) -> Optional[torch.Tensor]:
        """The capacity-padded replay buffer; on a mesh a copy on the first device."""
        return None if self._replay_blocks is None else self._joined(self._replay_blocks)

    def _block_forward(self, j: int, x: torch.Tensor) -> torch.Tensor:
        """Block j's eval forward on its device."""
        params = self._serve_replicas[j]
        if self.quantized or self.block_devices[j] == self.device:
            return self._forward(params, x)
        return torch.func.functional_call(self.model.core, params, (x,))

    # ------------------------------------------------------------ fleet CL
    def _need_float_model(self) -> None:
        """Attach the optimizer (allocating Adam's moments) if needed; raises
        on an int8-checkpoint boot, which holds no float parameters."""
        if self.model.params is None:
            raise RuntimeError(
                "fleet continual learning needs float params, but this engine was booted from "
                "an int8 checkpoint (inference-only). Load the float checkpoint to train.")
        if self.model.optimizer is None:
            self.model.compile()

    def _ensure_cl(self) -> None:
        """Allocate the fleet ring, the optimizer and, on a mesh serving
        int8, the float replicas at the first use."""
        if self._cl_rings is not None:
            return
        self._need_float_model()
        if self._param_replicas is None:
            self._param_replicas = self._float_replicas()
        t = self.cl_ring_ticks
        # made outside inference mode and written in place inside it, so its
        # rows can enter the CL step's autograd graph
        self._cl_rings = [torch.zeros((t, self._block, self.height, self.width, self.channels),
                                      dtype=torch.float32, device=d)
                          for d in self.block_devices]
        self._cl_valid = np.zeros((t, self.n_streams), np.float32)

    def _cl_eps(self, n: int) -> torch.Tensor:
        """The latent noise of a mesh CL step's n stacked rows, drawn at once
        from the model's generator: the unsharded step's draw."""
        return torch.randn((n, self.model.latent_size), generator=self.model.generator,
                           device=self.device)

    def _cl_blocks(self, rings, replay) -> list:
        """Per block, (its stacked CL rows on its device: its ring rows tick
        by tick, then its replay rows; their rows' indices in the unsharded
        stacked batch, t * K + k for the ring, T * K + r for the replay)."""
        t, k, b = self.cl_ring_ticks, self.n_streams, self._block
        out = []
        for j, ring in enumerate(rings):
            rows = ring.reshape((-1,) + tuple(ring.shape[2:]))
            index = (np.arange(t)[:, None] * k + j * b + np.arange(b)[None, :]).reshape(-1)
            if replay is not None:
                r = replay[j].shape[0]
                rows = torch.cat([rows, replay[j]], dim=0)
                index = np.concatenate([index, t * k + j * r + np.arange(r)])
            out.append((rows, torch.from_numpy(index).to(self.device)))
        return out

    def _mesh_grads(self, blocks: list, weights: torch.Tensor, eps: torch.Tensor):
        """(loss dict, the gradients of the first device's parameters) of the
        stacked batch in ``blocks``: each block's forward on its device and
        replica, the loss over the union on the first device, the replicas'
        gradients summed in."""
        core, parts, index = self.model.core, [], []
        for j, (rows, idx) in enumerate(blocks):
            e = eps[idx].to(rows.device)
            if self.block_devices[j] == self.device:
                out = core.call_detailed(rows, training=True, eps=e)
            else:
                replica = {f"core.{k}": v for k, v in self._param_replicas[j].items()}
                out = torch.func.functional_call(self._detailed, replica, (rows, e))
            parts.append((rows,) + tuple(out))
            index.append(idx)
        order = torch.argsort(torch.cat(index))  # the unsharded row order
        x, x_hat, z, mean, logvar = (torch.cat([p[i].to(self.device) for p in parts])[order]
                                     for i in range(5))
        loss = core.compute_loss(x, training=True, weights=weights,
                                 detailed=(x_hat, z, mean, logvar))
        params = list(self.model.optimizer.params)
        names = self.model.optimizer.names
        replicas = [[r[k] for k in names] for d, r in zip(self.block_devices,
                                                         self._param_replicas)
                    if d != self.device]
        grads = torch.autograd.grad(loss["loss"], params + [t for r in replicas for t in r])
        total = list(grads[:len(params)])
        for i in range(len(replicas)):
            for g, extra in zip(total, grads[(i + 1) * len(params):(i + 2) * len(params)]):
                g.add_(extra.to(g.device))
        return loss, total

    def _mesh_cl_step(self) -> dict:
        """The mesh's CL step on the ring and the replay buffer."""
        w = [self._cl_valid.reshape(-1)]
        if self._replay_blocks is not None:
            w.append((np.arange(self.replay_capacity) < self.replay_n).astype(np.float32))
        weights = torch.from_numpy(np.concatenate(w)).to(self.device)
        loss, grads = self._mesh_grads(self._cl_blocks(self._cl_rings, self._replay_blocks),
                                       weights, self._cl_eps(weights.shape[0]))
        self.model.optimizer.step(grads)
        return {k: v.detach() for k, v in loss.items()}

    def _refresh_serve_params(self) -> None:
        """The replicas after a CL step: the float copies take the trained
        parameters in place; an int8 tree is quantized again and replicated."""
        params = self.model.params
        with torch.no_grad():
            for device, replica in zip(self.block_devices, self._param_replicas):
                if device != self.device:
                    for k, t in replica.items():
                        t.copy_(params[k])
        if self.quantized:
            _, tree = serving_forward(self.model.core, params, quantize=True)
            self._serve_replicas = self._replicate(tree)

    def _do_cl_step(self) -> Optional[dict]:
        """One gradient step on the fleet ring (all streams, weighted rows)
        plus the replay buffer; None while no row of the ring is valid.
        Returns the loss dict as floats, fetched in one copy."""
        if self._cl_valid is None or self._cl_valid.sum() == 0:
            return None
        # parameters and moments update in place, tensor by tensor: defer
        # signals so an interrupt never leaves a step half applied
        with defer_signals():
            if self.mesh is None:
                rows = self._cl_rings[0].reshape((-1,) + self._cl_rings[0].shape[2:])
                stacked, weights = cl_batch(
                    rows, torch.from_numpy(self._cl_valid.reshape(-1)).to(self.device),
                    self.replay_buffer, self.replay_n)
                loss, _x_hat = self.model.train_step_and_run(stacked, weights=weights)
            else:
                loss = self._mesh_cl_step()
            self._refresh_serve_params()
        self.cl_epochs += 1
        values = torch.stack([v.to(torch.float32) for v in loss.values()]).cpu().tolist()
        loss = dict(zip(loss, values))
        self.last_epoch_loss = loss
        self.model_changed_flag = True
        if self.metrics is not None:
            self.metrics.log(self.cl_epochs, loss, prefix="cl/")
        return loss

    def set_learning_rate(self, lr: float) -> None:
        # a CL control: dialing it attaches the optimizer if needed
        self._need_float_model()
        self.model.set_learning_rate(lr)

    def set_img_noise(self, beta: float) -> None:
        """The img-noise dial -> model.beta; stored, with no effect on the CL
        loss, as in the single-stream engine."""
        self.model.beta = beta

    # ------------------------------------------------------------ replay
    def load_replay_buffer_from_file(self, input_filename: str) -> int:
        """txt (one path per line) or csv (first column) -> the fleet's replay
        buffer."""
        return self.load_replay_buffer_from_filelist(parse_replay_file(input_filename))

    def load_replay_buffer_from_filelist(self, filelist: list) -> int:
        imgs, ok_paths = decode_filelist_to_model_res(
            filelist, self.height, self.width, self.channels, self.device)
        n = len(ok_paths)
        if n == 0:
            return 0
        if n > self.replay_capacity:
            # grow in fleet-ring buckets, so that repeated oversized loads
            # converge to few distinct batch shapes
            ring_rows = self.cl_ring_ticks * self.n_streams
            self.replay_capacity = -(-n // ring_rows) * ring_rows
        d = len(self.block_devices)  # the buffer's rows split evenly over the devices
        self.replay_capacity = -(-self.replay_capacity // d) * d
        buf = torch.zeros((self.replay_capacity, self.height, self.width, self.channels),
                          dtype=torch.float32, device=self.device)
        buf[:n] = imgs
        rows = self.replay_capacity // d
        self._replay_blocks = [buf[j * rows:(j + 1) * rows].to(dev)
                               for j, dev in enumerate(self.block_devices)]
        self.replay_n = n
        self.replay_buffer_paths = ok_paths
        print(f"Replay Buffer Loaded: {n} images (capacity {self.replay_capacity})")
        return n

    # ------------------------------------------------------------ recording
    def begin_recording(self, record_dir: str, names: Optional[List[str]] = None) -> str:
        """Open a ``data_<timestamp>`` instance directory with one subtree of
        five PNG streams per stream, named after ``names`` (default
        cam<i>); names that collide are made unique (gate, gate_1, gate_2,
        each candidate checked again). Returns the instance directory."""
        if not os.path.isdir(record_dir):
            raise NotADirectoryError(f"record directory not found: {record_dir}")
        if names is not None and len(names) != self.n_streams:
            raise ValueError(f"{len(names)} names for {self.n_streams} streams")
        raw = list(names) if names else [f"cam{i}" for i in range(self.n_streams)]
        seen: set = set()
        self._stream_names = []
        for name in raw:
            cand, k = name, 0
            while cand in seen:
                k += 1
                cand = f"{name}_{k}"
            seen.add(cand)
            self._stream_names.append(cand)
        self.record_dir = record_dir
        stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        self.record_instance_dir = os.path.join(record_dir, f"data_{stamp}")
        for name in self._stream_names:
            for sub in RECORD_STREAMS:
                os.makedirs(os.path.join(self.record_instance_dir, name, sub))
        self._anomaly_score_maps = [{} for _ in range(self.n_streams)]
        self.recording_flag = True
        print(f"Recording to: {self.record_instance_dir}")
        return self.record_instance_dir

    def _maybe_record(self, batch: np.ndarray, valid: np.ndarray,
                      out: List[Optional[StreamStatus]], now: float) -> None:
        """Every ``record_period_ms``: each stream's five PNGs; a stream that
        dropped the tick records nothing."""
        if not self.recording_flag:
            return
        if (now - self._last_record_t) * 1000.0 < self.record_period_ms:
            return
        self._last_record_t = now
        basename = datetime.datetime.now().strftime("%Y%m%d-%H%M%S-%f") + ".png"
        for i, r in enumerate(out):
            if r is None or not valid[i]:
                continue
            self._anomaly_score_maps[i][basename] = r.score
            record_frame_artifacts(
                os.path.join(self.record_instance_dir, self._stream_names[i]), basename,
                batch[i], r.norm_err_u8, r.reconstruction_u8, self.height, self.width)

    def terminate_recording(self) -> Optional[str]:
        """Close the recording: one ``labels.json`` per stream and ONE model
        snapshot for the fleet (the weights are shared). Returns the
        instance directory (None if nothing was opened)."""
        self.recording_flag = False
        root = self.record_instance_dir
        if root is None or not os.path.isdir(root):
            return None
        for i, name in enumerate(self._stream_names):
            write_coco_labels(os.path.join(root, name), self._anomaly_score_maps[i])
        self.save_model_to_dir(os.path.join(root, "model"))
        return root

    # ----------------------------------------------------------- model save
    def save_model_to_dir(self, model_dir: str, saver=None) -> str:
        """Checkpoint round + ``config.yml`` + replay provenance (the
        single-stream engine's save without ``cam_info``, a per-camera
        notion)."""
        return save_model_dir(self.model, self.config, model_dir,
                              replay_paths=self.replay_buffer_paths, saver=saver)

    # ------------------------------------------------------------- the tick
    def _host_resize(self, i: int, frame: np.ndarray, ref_shape) -> np.ndarray:
        """Bring a stream whose camera delivers another resolution onto the
        pinned batch shape (bilinear on the host; warns once per stream)."""
        from PIL import Image

        if i not in self._resize_warned:
            self._resize_warned.add(i)
            print(f"multicam: stream {i} delivers {frame.shape}, resizing to "
                  f"the pinned batch shape {ref_shape}")
        if frame.ndim == 3 and frame.shape[-1] == 1:
            frame = frame[..., 0]  # PIL rejects (H, W, 1) arrays
        img = Image.fromarray(frame).resize((ref_shape[1], ref_shape[0]), Image.BILINEAR)
        out = np.asarray(img, np.uint8)
        if out.shape != tuple(ref_shape):  # channel mismatch
            if out.ndim == 2:  # gray -> replicate across the reference channels
                out = np.broadcast_to(out[..., None], ref_shape).copy()
            elif ref_shape[-1] == 1:  # RGB -> single channel: luminance
                lum = 0.299 * out[..., 0] + 0.587 * out[..., 1] + 0.114 * out[..., 2]
                out = np.clip(np.round(lum), 0, 255).astype(np.uint8)[..., None]
            else:
                out = np.broadcast_to(out[..., :1], ref_shape).copy()
        return out

    def _step(self, batch_u8: np.ndarray, valid: np.ndarray):
        """One tick: for each block of streams on its device, normalize,
        resize, one forward for its frames and one launch of the scorer over
        them; every block is launched before any result is read. Returns,
        each a list over the blocks, the new state, the tick's device
        results and the model-size float batch (which the fleet CL ring
        stores); nothing is fetched."""
        b, out = self._block, []
        for j, device in enumerate(self.block_devices):
            rows = slice(j * b, (j + 1) * b)
            x = torch.from_numpy(batch_u8[rows]).to(device).to(torch.float32) / 255.0
            x = resize_images(x, (self.height, self.width))
            x_hat = self._block_forward(j, x)
            maps, scalars, norm, score_count = stream_score.stream_score_step_batched(
                self._maps[j], self._scalars[j], x, x_hat, self.stream_error_ma,
                torch.from_numpy(valid[rows]).to(device))
            out.append((maps, scalars, _to_u8(norm), _to_u8(x_hat), score_count, x))
        return tuple(list(t) for t in zip(*out))

    def warmup(self, frame_shape=None, cl: bool = False) -> None:
        """Build the kernels and run the tick once on zero frames BEFORE the
        cameras attach, so the first real tick pays neither the nvcc builds
        nor the first-call costs. The scorer state is untouched.

        Pins the batch shape to ``frame_shape`` (default: the model's
        resolution), provisionally: if the first real tick delivers another
        resolution, the pin moves to the delivered shape (the device resize
        then runs, as without a warm-up) and a line says so. A wrong
        ``frame_shape`` wastes the warm-up but never changes the scores.

        ``cl``: also prepare the fleet CL step: allocate the ring and the
        optimizer, build the moments kernels, and run the step's loss and
        backward once on a scratch batch of its shape (T·K rows plus the
        replay buffer's; load the replay buffer first). Parameters, moments,
        the generator and the ring stay as they were."""
        shape = tuple(frame_shape) if frame_shape is not None else (
            self.height, self.width, self.channels)
        if self._ref_shape is None:
            self._ref_shape = shape
            self._warm_pin = True  # provisional until the first real tick
        with torch.inference_mode():
            *_state, score_count, _x = self._step(
                np.zeros((self.n_streams, *self._ref_shape), np.uint8),
                np.ones(self.n_streams, bool))
            for sc in score_count:
                sc.cpu()
        if cl:
            self._ensure_cl()
            if self.mesh is None:
                n = self.cl_ring_ticks * self.n_streams + (
                    0 if self._replay_blocks is None else self.replay_capacity)
                warm_cl_backward(self.model, n, (self.height, self.width, self.channels))
            else:
                self._warm_mesh_cl()

    def _warm_mesh_cl(self) -> None:
        """``warm_cl_backward`` over the mesh: the CL step's loss and backward
        once on mid-grey scratch blocks of its shapes, the gradients dropped."""
        if self.device.type == "cuda":
            moments.build()
        rings = [torch.full_like(r, 0.5) for r in self._cl_rings]
        replay = (None if self._replay_blocks is None
                  else [torch.full_like(r, 0.5) for r in self._replay_blocks])
        blocks = self._cl_blocks(rings, replay)
        n = sum(rows.shape[0] for rows, _ in blocks)
        _, grads = self._mesh_grads(blocks, torch.ones(n, device=self.device),
                                    torch.zeros((n, self.model.latent_size), device=self.device))
        float(grads[0].flatten()[0])  # wait for the backward

    def process_frames(self, frames: Sequence[Optional[np.ndarray]],
                       now: Optional[float] = None,
                       tag: object = None) -> List[Optional[StreamStatus]]:
        """Score one tick of frames (len == n_streams; None = a dropped tick).

        ``tag``: the caller's id of this tick; after the call
        ``last_emitted_tag`` holds the tag of the tick the RETURNED results
        belong to (one tick behind in pipelined mode)."""
        if len(frames) != self.n_streams:
            raise ValueError(f"{len(frames)} frames for {self.n_streams} streams")
        now = time.monotonic() if now is None else now
        valid = np.array([f is not None for f in frames], bool)
        # dropped streams get a zero placeholder; the mask freezes their state.
        # The batch shape is pinned at the first tick; streams that deliver
        # another resolution are resized on the host.
        shapes = [f.shape for f in frames if f is not None]
        if self._ref_shape is None:
            self._ref_shape = tuple(shapes[0]) if shapes else (
                self.height, self.width, self.channels)
        elif self._warm_pin and shapes:
            # the warm-up's pin is provisional: the first real tick WITH
            # frames wins. An all-dropped tick (cameras still connecting)
            # does not confirm it.
            if tuple(shapes[0]) != self._ref_shape:
                print(f"warmup shape {self._ref_shape} != delivered frame {shapes[0]}: "
                      "re-pinning (pass --warmup HxW matching the cameras)")
                self._ref_shape = tuple(shapes[0])
            self._warm_pin = False
        ref_shape = self._ref_shape
        batch = np.zeros((self.n_streams, *ref_shape), np.uint8)
        for i, f in enumerate(frames):
            if f is not None:
                if f.shape != ref_shape:
                    f = self._host_resize(i, f, ref_shape)
                batch[i] = f

        if self.enable_cont_learning:
            self._ensure_cl()
        # maps and scalars are re-assigned together, and the CL ring's slot
        # is written with its weights: defer signals so an interrupt never
        # splits them
        with defer_signals(), torch.inference_mode():
            self._maps, self._scalars, norm_u8, rec_u8, score_count, x = self._step(batch, valid)
            if self.enable_cont_learning:
                slot = self._cl_tick % self.cl_ring_ticks
                for ring, rows in zip(self._cl_rings, x):
                    ring[slot].copy_(rows)
                self._cl_valid[slot] = valid.astype(np.float32)
                self._cl_tick += 1
        if (self.enable_cont_learning
                and (now - self._last_cl_t) * 1000.0 > self.continuous_learning_period_ms):
            self._last_cl_t = now
            self._do_cl_step()
        self._maybe_autosave(now)

        if self.pipelined:
            # return tick N-1's results while tick N computes on the device;
            # the raw batch, the validity mask and the tag travel with their
            # results, so a recording pairs tick N-1's frames with its scores
            pending = self._pending
            self._pending = (score_count, norm_u8, rec_u8, batch, valid, tag)
            if pending is None:
                return [None] * self.n_streams  # the first tick's results come next call
            score_count, norm_u8, rec_u8, batch, valid, tag = pending
        return self._emit(score_count, norm_u8, rec_u8, batch, valid, now, tag)

    def flush(self, now: Optional[float] = None) -> Optional[List[Optional[StreamStatus]]]:
        """Pipelined mode: fetch the last in-flight tick's results."""
        if not self.pipelined or self._pending is None:
            return None
        now = time.monotonic() if now is None else now
        score_count, norm_u8, rec_u8, batch, valid, tag = self._pending
        self._pending = None
        return self._emit(score_count, norm_u8, rec_u8, batch, valid, now, tag)

    def _emit(self, score_count, norm_u8, rec_u8, batch, valid, now,
              tag=None) -> List[Optional[StreamStatus]]:
        """Host side of one tick: the score fetch (one device->host copy a
        block), the moving averages, the per-stream state machines and the
        recording."""
        self.last_emitted_tag = tag
        sc = np.concatenate([c.cpu().numpy() for c in score_count])  # (K, 2)
        out: List[Optional[StreamStatus]] = []
        b = self._block
        for i in range(self.n_streams):
            if not valid[i]:
                out.append(None)
                continue
            score = float(sc[i, 0])
            ma = self.anomaly_ma_weight * self.score_ma[i] + (1 - self.anomaly_ma_weight) * score
            if not np.isnan(ma):
                self.score_ma[i] = ma
            self._record_score(i, score)
            self._update_state_machine(i, score, now)
            out.append(StreamStatus(
                score=score,
                score_ma=float(self.score_ma[i]),
                pixel_count=float(sc[i, 1]),
                anomalous=bool(self.anomalous[i]),
                _norm_dev=norm_u8[i // b][i % b],
                _rec_dev=rec_u8[i // b][i % b],
            ))
        self._maybe_record(batch, valid, out, now)
        return out

    # ------------------------------------------------------- state machines
    def _record_score(self, i: int, score_f: float) -> None:
        """Append a finite score to stream i's CDF history, after the optional
        ``cdf_warmup_skip`` first scores of the stream's task."""
        self._task_scored[i] += 1
        if not np.isfinite(score_f):
            return
        skip = 0
        if self.anomaly_settings is not None:
            skip = int(self.anomaly_settings.get("cdf_warmup_skip", 0))
        if self._task_scored[i] <= skip:
            return
        self._score_history[i].append(score_f)
        self._cdf_dirty[i] += 1

    def current_threshold(self, i: int) -> Optional[float]:
        """Active threshold of stream i: fixed, or its own CDF quantile once
        32 scores exist; the options and defaults are the single-stream
        engine's (``StreamingEngine.current_threshold``). None without
        anomaly_settings (scoring runs, no state machine is configured)."""
        if self.anomaly_settings is None:
            return None
        threshold = float(self.anomaly_settings.get("anomaly_score_threshold"))
        method = str(self.anomaly_settings.get("anomaly_score_method", "fixed"))
        if method.startswith("cdf"):
            if len(self._score_history[i]) < 32:
                if bool(self.anomaly_settings.get("cdf_warmup_abstain", True)):
                    return float("inf")
                return threshold
            if self._cdf[i] is None or self._cdf_dirty[i] >= 16:
                window = int(self.anomaly_settings.get("cdf_window", 96))
                hist = np.asarray(self._score_history[i])
                self._cdf[i] = CDFObject(hist[-window:] if window > 0 else hist)
                self._cdf_dirty[i] = 0
            q = float(self.anomaly_settings.get("cdf_quantile", 0.995))
            robust = bool(self.anomaly_settings.get("cdf_robust_tail", True))
            adaptive = threshold_from_cdf(self._cdf[i], q, robust=robust)
            floor = float(self.anomaly_settings.get("cdf_floor", threshold))
            return max(adaptive, floor)
        return threshold

    def _update_state_machine(self, i: int, score: float, now: float) -> None:
        """Per-stream threshold and hold period."""
        if self.anomaly_settings is None:
            self.anomalous[i] = False
            return
        threshold = self.current_threshold(i)
        if score > threshold:
            if not self.anomalous[i]:
                self.anomalous_start[i] = now
            self.anomalous[i] = True
        elif self.anomalous[i] and self.anomalous_start[i] is not None:
            hold = float(self.anomaly_settings.get("anomalous_state_period_s"))
            if now - self.anomalous_start[i] > hold:
                self.anomalous[i] = False

    def reset_stream(self, i: int) -> None:
        """Task or camera change on one stream: reset its EMA state only."""
        j, row = divmod(i, self._block)
        with torch.inference_mode():  # the state tensors were made under it
            self._maps[j][row] = 0.0
            self._scalars[j][row] = 0.0
        self.score_ma[i] = 0.0
        self.anomalous[i] = False
        self.anomalous_start[i] = None

    def new_task(self, i: Optional[int] = None, reset_scorer: bool = False) -> None:
        """Task boundary for stream i (or ALL streams when None): reset the
        stream's score CDF so that its threshold re-derives. The scorer's EMA
        state is kept by default (re-seeding it rails the score at the z-cap
        for dozens of frames); ``reset_scorer=True`` is the hard reset for a
        physical camera swap. The anomalous state is not cleared: a stream in
        mid-alarm keeps its hold period and expires on its own."""
        streams = range(self.n_streams) if i is None else [i]
        for s in streams:
            self._score_history[s].clear()
            self._cdf[s] = None
            self._cdf_dirty[s] = 0
            self._task_scored[s] = 0
            if reset_scorer:
                self.reset_stream(s)
            else:
                self.score_ma[s] = 0.0
