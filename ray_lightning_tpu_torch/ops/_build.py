"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each kernel is one source ``csrc/<name>.cu`` with a plain C entry point.
It is compiled for Hopper (``sm_90a``) into ``lib<name>.so`` at first use,
in ``build/kernels/<name>-<hash>/`` at the root of the checkout, where the
hash covers the source and the flags: an edited source builds anew, an
unchanged one loads the library already built.  A plain C interface keeps
the build to seconds (a source that includes PyTorch's headers takes
minutes) and keeps the port free of a compiled PyTorch extension.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Sequence, Tuple

__all__ = ["Build", "build", "load_function", "library_path", "CSRC",
           "BUILD_DIR", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# -Xptxas -v makes nvcc report each kernel's registers, shared memory and
# spills on stderr, which Build.log keeps.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass(frozen=True)
class Build:
    """One kernel library: where it is, how long nvcc took (0.0 when it
    was already built) and what nvcc printed."""

    name: str
    path: Path
    seconds: float
    log: str


_lock = threading.Lock()
_functions: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found on PATH or in /usr/local/cuda/bin: the port's "
            "CUDA kernels are built on the machine that holds the card"
        )
    return nvcc


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by source and flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(
        src + "\0".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}" / f"lib{name}.so"


def build(name: str) -> Build:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists.
    Raises ``RuntimeError`` carrying nvcc's stderr when the build fails."""
    path = library_path(name)
    if path.exists():
        return Build(name, path, 0.0, "")
    path.parent.mkdir(parents=True, exist_ok=True)
    # Build to a private name and rename into place, so a process
    # building at the same time never loads a half-written library.
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stderr}"
        )
    os.replace(tmp, path)
    return Build(name, path, seconds, proc.stderr)


def load_function(name: str, symbol: str,
                  argtypes: Sequence[type]) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of kernel library ``name`` (built at
    first use), with its ``argtypes`` declared and an ``int`` result.
    Every pointer and the stream must be declared ``ctypes.c_void_p``:
    undeclared, ctypes would pass them as 32-bit ints."""
    key = (name, symbol)
    with _lock:
        fn = _functions.get(key)
        if fn is None:
            fn = getattr(ctypes.CDLL(str(build(name).path)), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _functions[key] = fn
        return fn
