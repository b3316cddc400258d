"""Metric logging: JSON lines always, TensorBoard events when available.

Counterpart of ``MetricsWriter`` in ``trustedai_cl_vae_ad_tpu/utils/
metrics.py``: scalars are logged per step or epoch into
``<logdir>/metrics.jsonl`` and mirrored to TensorBoard event files when
``torch.utils.tensorboard`` is importable.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping


def _try_tensorboard(logdir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:  # the tensorboard package is optional
        return None
    return SummaryWriter(log_dir=logdir)


class MetricsWriter:
    def __init__(self, logdir: str, use_tensorboard: bool = True):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._jsonl_path = os.path.join(logdir, "metrics.jsonl")
        self._jsonl = open(self._jsonl_path, "a")
        self._tb = _try_tensorboard(logdir) if use_tensorboard else None

    def log(self, step: int, metrics: Mapping[str, float], prefix: str = "") -> None:
        """One record; values that do not convert to float are left out. A
        device tensor converts by a fetch, which waits for the device."""
        record = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            key = f"{prefix}{k}"
            try:
                record[key] = float(v)
            except (TypeError, ValueError):
                continue
            if self._tb is not None:
                self._tb.add_scalar(key, record[key], int(step))
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
