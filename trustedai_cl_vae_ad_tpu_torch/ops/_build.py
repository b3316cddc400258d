"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``build/kernels/<name>-<hash>.so`` at the checkout's root on
first use, then loaded with ``ctypes``. The file name carries a digest of the
source, of every header of the package it includes (a quoted include found
beside the including file, directly or through another header), and of the
flags, so an edit to any of them rebuilds. Nothing here runs at import time.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false`` so that ``a*b + c``
rounds twice as it does in PyTorch's elementwise ops; no ``--use_fast_math``
(sqrt and division stay IEEE, NaN stays NaN).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
_QUOTED_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)

_loaded: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each kernel built here
build_log: Dict[str, str] = {}
#: the shared library each loaded source was built into
library_paths: Dict[str, Path] = {}


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found: Optional[str] = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return found


def included_headers(src: Path) -> List[Path]:
    """Every header that ``src`` includes in quotes, directly or through
    another one, and that lies beside the including file (where nvcc looks
    first); the toolkit's ``<...>`` headers are not followed. Sorted, each
    once."""
    found, todo = set(), [Path(src)]
    while todo:
        including = todo.pop()
        for name in _QUOTED_INCLUDE.findall(including.read_text(errors="replace")):
            header = including.parent / name
            if header.is_file():
                header = header.resolve()
                if header not in found:
                    found.add(header)
                    todo.append(header)
    return sorted(found)


def source_digest(src: Path, flags: Sequence[str]) -> str:
    """16 hex digits over the source, its headers (name and bytes) and the flags."""
    h = hashlib.sha256(Path(src).read_bytes())
    for header in included_headers(src):
        h.update(b"\0" + header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"{name}-{source_digest(src, NVCC_FLAGS)}.so"
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src} (exit {proc.returncode}):\n{proc.stderr}")
        build_log[name] = proc.stderr
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    library_paths[name] = out
    _loaded[name] = lib
    return lib
