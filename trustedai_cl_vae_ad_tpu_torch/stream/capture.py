"""Frame sources: RTSP/webcam/video file via OpenCV, frame directories,
synthetic frames.

Counterpart of ``trustedai_cl_vae_ad_tpu/stream/capture.py`` (numpy,
OpenCV and PIL only, as there): the same sources, frames and reconnect
behaviour, so the two packages see identical synthetic streams. A directory
source decodes with cv2, then PIL; the JAX package's native C++ decoder is
not ported.
"""

from __future__ import annotations

import os
import time
from typing import Iterator, Optional

import numpy as np


class FrameSource:
    """Iterator protocol: yields RGB uint8 HWC frames.

    read() returns None for a transient gap (corrupt frame, RTSP hiccup);
    sources set ``exhausted`` when the stream has ended. Iteration skips
    transient gaps (up to MAX_CONSECUTIVE_GAPS, so a dead live source still
    terminates) and stops on exhaustion."""

    fps: float = 20.0
    exhausted: bool = False
    # live sources (webcam/RTSP) buffer internally and must be drained every
    # tick; replayable sources (file/dir/synthetic) are read only when due
    is_live: bool = False
    MAX_CONSECUTIVE_GAPS = 10

    def read(self) -> Optional[np.ndarray]:
        raise NotImplementedError

    def release(self) -> None:
        pass

    def __iter__(self) -> Iterator[np.ndarray]:
        gaps = 0
        while True:
            frame = self.read()
            if frame is None:
                if self.exhausted:
                    return
                gaps += 1
                if gaps >= self.MAX_CONSECUTIVE_GAPS:
                    return
                continue
            gaps = 0
            yield frame


class SyntheticSource(FrameSource):
    """Moving-gradient frames with sensor noise; frames in
    ``anomaly_frames`` get a bright disc at the centre. Deterministic from
    ``seed``."""

    def __init__(
        self,
        width: int = 320,
        height: int = 240,
        fps: float = 30.0,
        n_frames: int = 300,
        anomaly_frames: Optional[range] = None,
        seed: int = 0,
        motion: float = 1.0,
    ):
        self.width, self.height, self.fps = width, height, fps
        self.n_frames = n_frames
        self.anomaly_frames = anomaly_frames or range(0)
        self.motion = motion
        self._rng = np.random.RandomState(seed)
        self._i = 0
        yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
        self._yy, self._xx = yy / height, xx / width

    def read(self) -> Optional[np.ndarray]:
        if self._i >= self.n_frames:
            self.exhausted = True
            return None
        t = self.motion * self._i / max(self.fps, 1.0)
        r = 0.5 + 0.4 * np.sin(2 * np.pi * (self._xx + 0.1 * t))
        g = 0.5 + 0.4 * np.cos(2 * np.pi * (self._yy - 0.07 * t))
        b = 0.5 + 0.4 * np.sin(2 * np.pi * (self._xx + self._yy + 0.05 * t))
        frame = np.stack([r, g, b], axis=-1)
        frame += self._rng.normal(0, 0.01, frame.shape)
        if self._i in self.anomaly_frames:
            cy, cx = self.height // 2, self.width // 2
            rr = max(min(self.height, self.width) // 10, 2)
            mask = (self._yy * self.height - cy) ** 2 + (self._xx * self.width - cx) ** 2 < rr**2
            frame[mask] = 1.0
        self._i += 1
        return np.clip(np.round(frame * 255), 0, 255).astype(np.uint8)


def decode_image_rgb(filepath: str) -> Optional[np.ndarray]:
    """Read an image file to RGB uint8 HWC with cv2, then PIL; None when
    neither can decode it."""
    try:
        import cv2

        img = cv2.imread(filepath)
        if img is not None:
            return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    except ImportError:
        pass
    from PIL import Image

    try:
        with Image.open(filepath) as im:
            return np.asarray(im.convert("RGB"))
    except Exception:
        return None


class DirectorySource(FrameSource):
    """Replays PNG/JPG/BMP frames from a directory in sorted order."""

    def __init__(self, path: str, fps: float = 20.0, loop: bool = False):
        self.fps = fps
        self.loop = loop
        exts = (".png", ".jpg", ".jpeg", ".bmp")
        self.files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if os.path.splitext(f)[1].lower() in exts
        )
        if not self.files:
            raise ValueError(f"no frames in {path}")
        self._i = 0

    def read(self) -> Optional[np.ndarray]:
        if self._i >= len(self.files):
            if not self.loop:
                self.exhausted = True
                return None
            self._i = 0
        img = decode_image_rgb(self.files[self._i])
        self._i += 1
        return img


class OpenCVSource(FrameSource):
    """cv2.VideoCapture over a webcam index, a video file or an RTSP URL,
    with exponential-backoff reconnect for live sources."""

    def __init__(self, url, fps: float = 20.0, max_backoff_s: float = 8.0):
        import cv2

        self._cv2 = cv2
        # empty -> webcam 0, digits -> device index
        if url is None or url == "":
            url = 0
        elif isinstance(url, str) and url.isdigit():
            url = int(url)
        self.url = url
        self.fps = fps
        self.max_backoff_s = max_backoff_s
        # a local file that stops returning frames has ended; only live
        # sources (RTSP/webcam) reconnect
        self._is_file = isinstance(url, str) and os.path.isfile(url)
        self.is_live = not self._is_file
        self.cap = None
        self._connect()

    def _connect(self) -> None:
        cv2 = self._cv2
        self.cap = cv2.VideoCapture(self.url)
        try:
            self.cap.set(cv2.CAP_PROP_FOURCC, cv2.VideoWriter_fourcc(*"MJPG"))
        except Exception:
            pass

    def negotiate_connection(self) -> bool:
        """Reconnect with exponential backoff, up to ``max_backoff_s``."""
        backoff = 0.5
        while backoff <= self.max_backoff_s:
            if self.cap is not None:
                self.cap.release()
            time.sleep(backoff)
            self._connect()
            if self.cap.isOpened():
                ok, _ = self.cap.read()
                if ok:
                    return True
            backoff *= 2.0
        return False

    def read(self) -> Optional[np.ndarray]:
        cv2 = self._cv2
        if self.cap is None or not self.cap.isOpened():
            if not self.negotiate_connection():
                return None
        ok, frame = self.cap.read()
        if not ok:
            if self._is_file:
                self.exhausted = True
                return None
            ts = time.strftime("%Y%m%d-%H%M%S")
            print(f"{ts}: Failed to read capture device: {self.url}")
            if not self.negotiate_connection():
                return None
            ok, frame = self.cap.read()
            if not ok:
                return None
        return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

    def release(self) -> None:
        if self.cap is not None:
            self.cap.release()
            self.cap = None


def make_source(spec, fps: float = 20.0) -> FrameSource:
    """A source from a spec string: 'synthetic', a directory, a file, a
    digit webcam index, or an rtsp/http URL."""
    if spec == "synthetic":
        return SyntheticSource(fps=fps)
    if isinstance(spec, str) and os.path.isdir(spec):
        return DirectorySource(spec, fps=fps)
    return OpenCVSource(spec, fps=fps)
