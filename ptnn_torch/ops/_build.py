"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
by ``nvcc`` for Hopper (``sm_90a``) into ``build/ptnn_torch/<name>-<hash>.so``
at the root of the checkout, keyed by a hash of the source and the flags, and
loaded with ``ctypes``. A missing ``nvcc`` or a failed build raises. Nothing
is compiled at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, NamedTuple

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ptnn_torch"
# no --use_fast_math: the kernels keep IEEE expf and division
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float  # compile time in this process; 0.0 when it was on disk
    log: str  # nvcc's output (ptxas register and shared-memory report)


_loaded: Dict[str, Built] = {}


def nvcc() -> str:
    """The nvcc binary: $CUDA_HOME/bin, then PATH, then the toolkit's
    default install prefix."""
    cands = [
        os.path.join(os.environ[v], "bin", "nvcc")
        for v in ("CUDA_HOME", "CUDA_PATH")
        if os.environ.get(v)
    ]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of ptnn_torch are "
        "compiled from source at first use"
    )


def build(name: str) -> Built:
    """Compile (if needed) and load ``csrc/<name>.cu``; cached per process."""
    if name in _loaded:
        return _loaded[name]
    src = _CSRC / f"{name}.cu"
    key = hashlib.sha256(
        src.read_bytes() + " ".join(FLAGS).encode()
    ).hexdigest()[:16]
    so = BUILD_DIR / f"{name}-{key}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {src.name}:\n{log}"
            )
        os.replace(tmp, so)  # atomic: a concurrent build sees all or none
    lib = ctypes.CDLL(str(so))
    _declare(name, lib)
    _loaded[name] = Built(lib, so, seconds, log)
    return _loaded[name]


def _declare(name: str, lib: ctypes.CDLL) -> None:
    lib.ptnn_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ptnn_cuda_error_string.restype = ctypes.c_char_p
    if name == "rw_block":
        from ptnn_torch.ops.block_step import _RwParams, _THREADS

        lib.ptnn_rw_block.argtypes = [
            ctypes.POINTER(_RwParams), ctypes.c_int, ctypes.c_void_p
        ]
        lib.ptnn_rw_block.restype = ctypes.c_int
        lib.ptnn_rw_params_size.argtypes = []
        lib.ptnn_rw_params_size.restype = ctypes.c_int
        lib.ptnn_rw_block_threads.argtypes = []
        lib.ptnn_rw_block_threads.restype = ctypes.c_int
        if lib.ptnn_rw_params_size() != ctypes.sizeof(_RwParams):
            raise RuntimeError(
                "RwParams layout differs between rw_block.cu "
                f"({lib.ptnn_rw_params_size()} bytes) and block_step.py "
                f"({ctypes.sizeof(_RwParams)} bytes)"
            )
        if lib.ptnn_rw_block_threads() != _THREADS:
            raise RuntimeError("THREADS differs between rw_block.cu and "
                               "block_step.py")


def error_string(lib: ctypes.CDLL, err: int) -> str:
    return f"{lib.ptnn_cuda_error_string(err).decode()} (cudaError {err})"
